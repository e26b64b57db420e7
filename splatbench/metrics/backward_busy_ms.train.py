"""backward_busy_ms.train: device busy ms a step inside the span around
loss.backward()."""


def read(out, ctx):
    t = out.get("trace")
    if not t:
        return None
    busy = t["spans"].span_busy_s("backward")
    return 1e3 * busy / t["span_iters"] if busy > 0 else None
