"""A viewer flying a camera path: ``render.render`` one view after another in a
closed loop with a swap chain of ``in_flight`` frames (frame i is issued once
frame i - in_flight has finished), the capacity calibrated once over the path
(``render.calibrate_config``).

Window (trace off): the path cycles until ``--seconds`` have passed, then the
frames in flight finish. Traced: ``trace_frames`` path views ``trace_stride``
apart are timed without the profiler for ``timing_seconds``, then rendered
once under it through ``render.render`` (busy and idle time, kernels) and once
more through its parts, each in a span (prepare, binning, composite,
assemble). ``sample_frames`` frames drawn from the seed among those rendered
are copied as they finish and compared with the reference once the window has
closed.
"""

from __future__ import annotations

import importlib
import random
import time

from splatbench import device as D
from splatbench import trace as TR
from splatbench import traffic
from splatbench.drivers.common import (
    Reservoir, dropped_instances, forward_in_spans, image_errors, program_cameras,
    program_config, worst)
from splatbench.reference import render as ref
from splatbench.scene import make_scene


def closed_loop(dev, issue, view_of, in_flight: int, done, on_frame=None):
    """Issue frames until ``done(i, elapsed)`` with at most ``in_flight``
    unfinished -> (wall seconds until the last has finished, end events,
    views)."""
    ends, views = [], []
    t0 = time.perf_counter()
    i = 0
    while not done(i, time.perf_counter() - t0):
        if i >= in_flight:
            ends[i - in_flight].synchronize()
        v = view_of(i)
        img = issue(v)
        ev = D.event(dev)
        ev.record()
        ends.append(ev)
        views.append(v)
        if on_frame is not None:
            on_frame(i, v, img, ev)
        i += 1
    D.sync(dev)
    return time.perf_counter() - t0, ends, views


def run(ctx) -> dict:
    R = importlib.import_module("splatapult_tpu_torch.render")

    dev, cfg, tr = ctx.device, ctx.config, ctx.traffic
    mark = D.Marks()
    scene = make_scene(cfg["num_splats"], ctx.seed, dev)
    D.sync(dev)
    mark("scene")
    gs = R.GaussianScene(**scene)
    views = traffic.cameras(tr, cfg)
    nviews = len(views)
    cams, batched = program_cameras(views, dev)
    rcfg = R.calibrate_config(gs, batched, program_config(cfg, tr, ctx.overrides))
    mark(f"calibration (max_instance_mult {rcfg.max_instance_mult:.4f})")

    def frame(v):
        return R.render(gs, cams[v], rcfg)

    copies = D.FrameCopies(dev, tr["sample_frames"], (cfg["height"], cfg["width"], 4))
    closed_loop(dev, frame, lambda i: i % nviews, tr["in_flight"],
                lambda i, _: i >= tr["warmup_frames"])
    out = {"setup_s": time.perf_counter() - ctx.t_start}
    setup_peak = D.peak_bytes(dev)
    mark("warm-up")

    sample = Reservoir(tr["sample_frames"], random.Random(ctx.seed))

    def keep_sample(i, v, img, ev):
        slot = sample.offer(v)
        if slot is not None:
            copies.take(slot, img, ev)

    if not ctx.trace:
        D.reset_peak(dev)
        wall, ends, shown = closed_loop(dev, frame, lambda i: i % nviews, tr["in_flight"],
                                        lambda i, t: t >= ctx.seconds, keep_sample)
        peak = D.peak_bytes(dev)
        out["window"] = {"seconds": wall, "frames": len(ends), "pixels": cfg["width"] * cfg["height"],
                         "end_intervals_ms": [ends[k - 1].elapsed_time(ends[k])
                                              for k in range(1, len(ends))],
                         "peak_bytes": peak}
        peak = max(peak, setup_peak)
        mark("window")
    else:
        k = tr["trace_frames"]
        path = [(j * tr["trace_stride"]) % nviews for j in range(k)]
        rounds, t0 = 0, time.perf_counter()
        while rounds == 0 or time.perf_counter() - t0 < tr["timing_seconds"]:
            closed_loop(dev, frame, lambda i: path[i], tr["in_flight"], lambda i, _: i >= k)
            rounds += 1
        iter_s = (time.perf_counter() - t0) / (rounds * k)
        (wall, ends, shown), entry = TR.profile(lambda: closed_loop(
            dev, frame, lambda i: path[i], tr["in_flight"], lambda i, _: i >= k, keep_sample), dev)

        def parts(v):
            return forward_in_spans(gs, cams[v], rcfg)

        _, spans = TR.profile(lambda: closed_loop(
            dev, parts, lambda i: path[i], tr["in_flight"], lambda i, _: i >= k), dev)
        peak = D.peak_bytes(dev)
        mark("timing and traces")
        refcfg = ref.ref_config(cfg)
        out["trace"] = {"entry": entry, "entry_wall_s": wall, "iters": k, "iter_s": iter_s,
                        "spans": spans, "span_iters": k,
                        "work": [ref.work_counts(scene, *views[v], refcfg) for v in path]}
        out["breakdown"] = entry.breakdown()
        mark("work counts")

    drops = dropped_instances(gs, cams, rcfg, shown)
    out["attempted"] = len(shown)
    out["failed"] = sum(1 for v in shown if drops[v] > 0)
    out["device"] = D.describe(dev, peak)
    if ctx.trace:
        out["device"].update(busy_s=out["trace"]["entry"].busy_s(), window_s=wall)
    mark("dropped instances")
    copies.finish()
    refcfg = ref.ref_config(cfg)
    errors = [image_errors(copies.buffers[slot], ref.render(scene, *views[v], refcfg))
              for slot, v in enumerate(sample.items) if v is not None]
    out["checks"] = worst(errors)
    mark("reference")
    return out
