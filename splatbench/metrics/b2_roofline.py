"""b2_roofline: B2 (the composite forward) as a share of its floor: the
floor over the reference's walk of each traced frame over the device time of
B2's kernels, by name, in the frames traced through render.render."""

from splatbench import roofline

KERNELS = ('composite_fwd_segments_kernel', 'composite_fwd_combine_kernel')


def read(out, ctx):
    t = out.get("trace")
    if not t:
        return None
    device_s = t["entry"].kernel_s(*KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(roofline.composite_fwd_floor_s(w) for w in t["work"]) / device_s
