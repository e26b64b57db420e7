"""train_mpx_per_s: pixels of the training views stepped through in the
window (forward, backward and optimizer), in millions, over the window."""


def read(out, ctx):
    w = out.get("window")
    if not w or "steps" not in w:
        return None
    return w["steps"] * w["pixels"] / w["seconds"] / 1e6
