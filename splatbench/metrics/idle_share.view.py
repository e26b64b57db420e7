"""idle_share.view: the share of a call's time in which the device is idle, in
percent: 1 - (device busy time a call, from the profiler's trace of the
frames traced through render.render) / (the time a call takes, timed without the
profiler over the same calls), so that the profiler's own host cost does not
count as idle."""


def read(out, ctx):
    t = out.get("trace")
    if not t:
        return None
    busy = t["entry"].busy_s() / t["iters"]
    if busy <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - busy / t["iter_s"])
