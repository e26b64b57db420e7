"""frame_ms_p95: the 95th percentile, over every frame of the window, of the
interval between consecutive frames' end events, read on the device."""

from splatbench.drivers.common import quantile


def read(out, ctx):
    w = out.get("window")
    if not w or len(w.get("end_intervals_ms", ())) < 2:
        return None
    return quantile(w["end_intervals_ms"], 0.95)
