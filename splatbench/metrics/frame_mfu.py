"""frame_mfu: the whole frame's floor at the card's published peaks (the
scene read once, the image written once, the composite's arithmetic on the
pairs the reference's walk reaches) over the time a frame takes, timed
without the profiler over the traced frames, in percent."""

from splatbench import roofline


def read(out, ctx):
    t = out.get("trace")
    if not t or not t["work"]:
        return None
    floor = sum(roofline.frame_floor_s(w) for w in t["work"]) / len(t["work"])
    return 100.0 * floor / t["iter_s"]
