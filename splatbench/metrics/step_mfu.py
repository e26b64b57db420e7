"""step_mfu: the whole step's floor at the card's published peaks (the
scene read once, the target read and the image written once, gradients and
parameters written once, Adam's moments read and written once, the
composite's forward and backward arithmetic on the pairs the reference's walk
reaches) over the time a step takes, timed without the profiler over the
traced steps, in percent."""

from splatbench import roofline


def read(out, ctx):
    t = out.get("trace")
    if not t or not t["work"]:
        return None
    floor = sum(roofline.step_floor_s(w) for w in t["work"]) / len(t["work"])
    return 100.0 * floor / t["iter_s"]
