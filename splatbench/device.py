"""What the harness asks of the device, the same on the card and on the CPU
(where the tests drive the harness with the program's plain versions)."""

from __future__ import annotations

import subprocess
import sys
import time

import torch


class _HostEvent:
    """A stand-in for torch.cuda.Event on the CPU, where work is synchronous."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def describe(device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def name_and_power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why there is none."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return done.stdout.strip().replace("\n", "; ") or done.stderr.strip()


class FrameCopies:
    """Copies of chosen outputs, taken as they are produced without holding
    the device: on the card into pinned host buffers (allocated here, before
    any window) on a stream of their own, after the output's end event; on
    the CPU as clones."""

    def __init__(self, device, slots: int, shape, dtype=torch.float32):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.buffers = [torch.empty(shape, dtype=dtype, pin_memory=self.stream is not None)
                        for _ in range(slots)]

    def take(self, slot: int, tensor: torch.Tensor, done_event):
        if self.stream is None:
            self.buffers[slot].copy_(tensor.detach())
            return
        self.stream.wait_event(done_event)
        with torch.cuda.stream(self.stream):
            self.buffers[slot].copy_(tensor.detach(), non_blocking=True)
        tensor.record_stream(self.stream)

    def finish(self):
        if self.stream is not None:
            self.stream.synchronize()


class Marks:
    """Seconds between named points of a run, written to standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, what: str):
        now = time.perf_counter()
        print(f"splatbench: {what} {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now

