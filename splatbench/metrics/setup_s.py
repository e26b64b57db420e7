"""setup_s: seconds from the process's start to the window's start: the
scene made, the capacity calibrated, kernels built or loaded, the shapes of
the cell warmed up (and in training the checked steps)."""


def read(out, ctx):
    return out["setup_s"]
