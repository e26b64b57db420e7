"""binning_busy_ms.view: device busy ms a frame inside the span around
ops/binning.bin_splats."""


def read(out, ctx):
    t = out.get("trace")
    if not t:
        return None
    busy = t["spans"].span_busy_s("binning")
    return 1e3 * busy / t["span_iters"] if busy > 0 else None
