"""Dynamic gathers inside a kernel on the GPU: the probes G1 and G2.

    python -m splatapult_tpu_torch.tools.probe_dyngather [--lane-rows 8]
        [--sub-cols 512] [--out FILE.json]

The counterpart of the JAX repo's tools/test_dyngather.py (renamed: a
``test_*.py`` module would be collected by a bare pytest), at its shapes. The
JAX tool asks whether Mosaic lowers take_along_axis inside a kernel; each form
is a hand-written CUDA kernel here (kernels/csrc/probe_gather.cu), behind a
wrapper that launches it for CUDA tensors and takes the plain version for CPU
tensors:

  lane-axis  (G1, tools/test_dyngather.py:30, kernel_lane): out[i, j] =
             x[i, idx[i, j]] on [8, 640] int32                    gather_lane
  sublane-axis (G2, :48, kernel_sub): out[i, j] = x[idx[i, j], j] on
             [640, 512] int32                                      gather_sub

The tables are the JAX tool's (x = arange, G2's modulo 7919); the indices come
from numpy's default_rng(0), where the JAX tool's np.random.randint is
unseeded (:28, :46). Every index must lie in [0, L) (G1) or [0, R) (G2), as the
tool draws them: the wrappers check that on the device before they launch and
raise otherwise (numpy would wrap a negative index; these take none).
``--lane-rows`` scales G1's rows and ``--sub-cols`` G2's columns, to time the
kernels where bytes dominate (65536 each: three 168 MB arrays).

Beside each wrapper: its plain PyTorch version (the gather written out as a
flat index into x) and, timed here as a yardstick only, the one library call
that computes the same function: torch.gather (its int64 index made outside
the timed call). Timing and bounds as in tools/probe_scatter.py
(profile_bin.rounds_ms; the bytes of x, idx and the output at 3.35 TB/s).

It prints the JAX tool's lines (``lane-axis dynamic gather: OK``) with each
kernel's time, and, last, one JSON line: per kernel its shape, ms, bound,
library ms, and whether kernel, plain version and torch.gather agree; the
card's name and power limit. No fallback: a kernel that fails to build,
launch or match raises. GPU only: with no CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from splatapult_tpu_torch.tools.probe_scatter import ITERS, device_kind, on_device, report

R, L = 8, 640  # G1: the JAX tool's table
R2, L2 = 640, 512  # G2
LAUNCH_COUNTS = {"gather_lane": 0, "gather_sub": 0}
# the JAX tool's line names -> the wrapper's launch count
PROBES = {"lane": ("lane-axis dynamic gather", "gather_lane"),
          "sub": ("sublane-axis dynamic gather", "gather_sub")}
REPLACES = {"lane": "tools/test_dyngather.py:30", "sub": "tools/test_dyngather.py:48"}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def check_indices(idx, bound: int, what: str) -> None:
    """Raise unless every index lies in [0, bound) (one readback)."""
    if not bool(((idx >= 0) & (idx < bound)).all()):
        raise ValueError(f"{what}: an index lies outside [0, {bound})")


def _check_args(x, idx, axis: int, what: str) -> str:
    kind = device_kind(what, x, idx)
    other = 1 - axis
    if (x.dtype != torch.int32 or idx.dtype != torch.int32 or x.dim() != 2 or idx.dim() != 2
            or x.shape[other] != idx.shape[other]):
        raise ValueError(f"{what} takes x and idx 2-D int32 of one extent along axis {other}, "
                         f"got {tuple(x.shape)} {x.dtype} and {tuple(idx.shape)} {idx.dtype}")
    return kind


def _launch(fn_name: str, count: str, x, idx, *shape):
    """One gather kernel on CUDA tensors -> its output, idx's shape."""
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load(_build.TOOLS)
    x, idx = x.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    with torch.cuda.device(x.device):
        code = getattr(lib, fn_name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), *shape,
                                     torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, fn_name)
    LAUNCH_COUNTS[count] += 1
    return out


def gather_lane(x, idx, check: bool = True):
    """G1: out[i, j] = x[i, idx[i, j]] (take_along_axis, axis 1) -> out
    idx's shape, int32. x [R, L], idx [R, M] int32, every index in [0, L)."""
    kind = _check_args(x, idx, 1, "gather_lane")
    if check:
        check_indices(idx, x.shape[1], "gather_lane")
    if kind == "cpu":
        return gather_lane_plain(x, idx)
    if x.shape[1] > 58112:
        raise ValueError("gather_lane stages a whole row of x in shared memory: at most 58112 "
                         f"columns, got {x.shape[1]}")
    return _launch("splat_probe_gather_lane", "gather_lane", x, idx, x.shape[0], x.shape[1],
                   idx.shape[1])


def gather_lane_plain(x, idx):
    """gather_lane in PyTorch: x flattened, read at i * L + idx[i, j]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None] * x.shape[1]
    return x.reshape(-1)[rows + idx.long()]


def gather_sub(x, idx, check: bool = True):
    """G2: out[i, j] = x[idx[i, j], j] (take_along_axis, axis 0) -> out
    idx's shape, int32. x [R, L], idx [M, L] int32, every index in [0, R)."""
    kind = _check_args(x, idx, 0, "gather_sub")
    if check:
        check_indices(idx, x.shape[0], "gather_sub")
    if kind == "cpu":
        return gather_sub_plain(x, idx)
    if not 0 < x.shape[0] <= 1816:
        raise ValueError("gather_sub stages a 32-column strip of x (128 B a row) in shared "
                         f"memory: 1 to 1816 rows, got {x.shape[0]}")
    return _launch("splat_probe_gather_sub", "gather_sub", x, idx, x.shape[0], x.shape[1],
                   idx.shape[0])


def gather_sub_plain(x, idx):
    """gather_sub in PyTorch: x flattened, read at idx[i, j] * L + j."""
    cols = torch.arange(x.shape[1], device=x.device)
    return x.reshape(-1)[idx.long() * x.shape[1] + cols]


def make_inputs(lane_rows: int = R, sub_cols: int = L2, seed: int = 0) -> dict:
    """The JAX tool's tables (tools/test_dyngather.py:27, :45) and seeded
    indices in its ranges -> numpy int32 arrays lane_x [lane_rows, 640],
    lane_idx like it, sub_x [640, sub_cols], sub_idx like it."""
    rng = np.random.default_rng(seed)
    return {"lane_x": np.arange(lane_rows * L).reshape(lane_rows, L).astype(np.int32),
            "lane_idx": rng.integers(0, L, (lane_rows, L)).astype(np.int32),
            "sub_x": (np.arange(R2 * sub_cols).reshape(R2, sub_cols) % 7919).astype(np.int32),
            "sub_idx": rng.integers(0, R2, (R2, sub_cols)).astype(np.int32)}


def measure(inputs: dict) -> dict:
    """Both gather kernels on the inputs (make_inputs' arrays as CUDA tensors)
    -> per probe its shape, ms, bound, the plain version's ms, torch.gather's
    ms, ``equal`` (kernel, plain version and torch.gather alike) and
    ``max_abs_err`` (kernel against plain version). The first launch of each
    kernel checks its indices; the timed ones do not."""
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms
    from splatapult_tpu_torch.tools.profile_phases import bound

    args = {"lane": (inputs["lane_x"], inputs["lane_idx"], 1),
            "sub": (inputs["sub_x"], inputs["sub_idx"], 0)}
    kernel = {"lane": gather_lane, "sub": gather_sub}
    plain = {"lane": gather_lane_plain, "sub": gather_sub_plain}
    idx64 = {k: idx.long() for k, (_, idx, _) in args.items()}
    equal, err, calls = {}, {}, {}
    for k, (x, idx, axis) in args.items():
        want, got = plain[k](x, idx), kernel[k](x, idx)
        equal[k] = bool(torch.equal(got, want)
                        and torch.equal(torch.gather(x, axis, idx64[k]), want))
        err[k] = float((got - want).abs().max())
        del want, got
        calls[k] = lambda k=k, x=x, idx=idx: kernel[k](x, idx, check=False)
        calls[f"{k}/plain"] = lambda k=k, x=x, idx=idx: plain[k](x, idx)
        calls[f"{k}/library"] = lambda k=k, x=x, axis=axis: torch.gather(x, axis, idx64[k])
    ms = rounds_ms(calls, ITERS)
    result = {"iters": ITERS, "probes": {}}
    for k, (x, idx, axis) in args.items():
        nbytes = (x.numel() + 2 * idx.numel()) * 4
        result["probes"][k] = {
            "name": PROBES[k][0], "kernel": PROBES[k][1], "replaces": REPLACES[k],
            "x": list(x.shape), "idx": list(idx.shape), "axis": axis, "equal": equal[k],
            "max_abs_err": err[k], "ms": ms[k], "bytes": nbytes, **bound(nbytes, 0),
            "plain_ms": ms[f"{k}/plain"],
            "library": "torch.gather (int64 index)", "library_ms": ms[f"{k}/library"]}
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lane-rows", type=int, default=R, help="G1's rows (its table is [R, 640])")
    ap.add_argument("--sub-cols", type=int, default=L2,
                    help="G2's columns (its table is [640, C])")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dyngather: no CUDA device (GPU only: a host timing would not be a device "
              "number)", file=sys.stderr)
        return 1
    measured = measure(on_device(make_inputs(args.lane_rows, args.sub_cols), "cuda"))
    for r in measured["probes"].values():
        print(f"{r['name']}: {'OK' if r['equal'] else 'WRONG'} ({r['x']} int32, "
              f"{r['ms']:.4f} ms)", flush=True)
    report("probe_dyngather", measured, args.out)
    wrong = [k for k, r in measured["probes"].items() if not r["equal"]]
    if wrong:
        raise AssertionError(f"probe_dyngather: {wrong} differ from their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
