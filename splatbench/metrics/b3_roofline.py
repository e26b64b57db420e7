"""b3_roofline: B3 (the composite backward) as a share of its floor: the
floor over the reference's walk of each traced step's view over the device
time of B3's kernel, by name, in the steps traced through train.train_step."""

from splatbench import roofline

KERNELS = ('composite_bwd_kernel',)


def read(out, ctx):
    t = out.get("trace")
    if not t:
        return None
    device_s = t["entry"].kernel_s(*KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(roofline.composite_bwd_floor_s(w) for w in t["work"]) / device_s
