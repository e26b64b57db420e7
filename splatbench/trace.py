"""The device trace: ``torch.profiler`` over a callable, its Chrome trace read
back into device busy time, device time by kernel name, device time launched
inside named spans, and a breakdown of the device's operations and idle gaps.

Spans are ``torch.profiler.record_function`` ranges that the drivers place
around their own calls into the program. A device operation belongs to a span
when the host call that launched it (its runtime event, on any thread, so the
autograd engine's too) lies inside the span.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def profile(fn, device):
    """Run ``fn`` under the profiler and wait for the device -> (fn's result,
    Trace of what ran)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, Trace(events)


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Trace:
    """The complete events ("ph": "X") of a Chrome trace, times in microseconds."""

    def __init__(self, events):
        self.device, self.runtime, self.spans, self.ops = [], {}, [], defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
            elif cat in RUNTIME_CATS:
                if corr is not None:
                    self.runtime[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.spans.append((e.get("name", ""), ts, ts + dur))
            elif cat == "cpu_op":
                self.ops[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
        self.device.sort()
        for lst in self.ops.values():
            lst.sort()

    def busy_s(self) -> float:
        return _union((a, b) for a, b, _, _ in self.device) * 1e-6

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the operations whose name contains one of ``names``."""
        return sum(b - a for a, b, n, _ in self.device if any(k in n for k in names)) * 1e-6

    def span_busy_s(self, name: str) -> float:
        """Device busy seconds of what was launched inside spans called ``name``."""
        ranges = sorted((a, b) for n, a, b in self.spans if n == name)
        starts = [a for a, _ in ranges]
        picked = []
        for a, b, _, corr in self.device:
            launch = self.runtime.get(corr)
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and ranges[i][0] <= launch[0] <= ranges[i][1]:
                picked.append((a, b))
        return _union(picked) * 1e-6

    def _host_op(self, corr) -> str:
        """The innermost host operation around the launch of ``corr``."""
        launch = self.runtime.get(corr)
        if launch is None:
            return "(unknown launch)"
        t, tid = launch
        ops = self.ops.get(tid, [])
        i = bisect.bisect_right(ops, (t, float("inf"), "")) - 1
        for j in range(i, max(i - 64, -1), -1):
            if ops[j][0] <= t <= ops[j][1]:
                return ops[j][2]
        return "(outside any operation)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps between
        device operations summed by the host operation that launched the next
        one -> {"device_ops": [[name, s]], "idle_gaps": [[name, s]]}."""
        by_op = defaultdict(float)
        for a, b, n, _ in self.device:
            by_op[n] += (b - a) * 1e-6
        gaps = defaultdict(float)
        end = None
        for a, b, _, corr in self.device:
            if end is not None and a > end:
                gaps[self._host_op(corr)] += (a - end) * 1e-6
            end = b if end is None else max(end, b)

        def ranked(d):
            return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}
