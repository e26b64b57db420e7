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

G1 has two routes, picked from x's shape by pick_route: "direct" (each
value read straight from x, for tables up to LANE_DIRECT_MAX_BYTES and for
rows too wide to stage) and "staged" (the rows of x a CTA's outputs reach
copied into shared memory first, for larger tables); ``route=`` asks for
one, and LAUNCH_COUNTS counts each. G2 has one: it stages a 32-column strip
of x (at most SUB_MAX_ROWS rows) in shared memory.

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
(profile_bin.rounds_ms; the bytes of x, idx and the output at 3.35 TB/s,
raised to the launch floor timed in the same rounds, the order of the
calls rotated by one each round).

It prints the JAX tool's lines (``lane-axis dynamic gather: OK``) with each
kernel's time, and, last, one JSON line: per kernel its shape, route, ms (G1's
every route's), bound, library ms, and whether every route, the plain version
and torch.gather agree; the launch floor; the card's name and power limit. No
fallback: a kernel that fails to build, launch or match raises. GPU only: with
no CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from splatapult_tpu_torch.tools.probe_scatter import (ITERS, bound_with_floor, device_kind,
                                                     launch_floor, launch_floor_calls, on_device,
                                                     report)

R, L = 8, 640  # G1: the JAX tool's table
R2, L2 = 640, 512  # G2
LANE_ROUTES = ("direct", "staged")  # G1's C function's route argument: 0, 1
# G1's direct route's largest table x. On an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6, the calls' order rotated) the direct route is ahead by
# 13 % at x [4096, 640] (10.5 MB) and the staged one by 6 % at [8192, 640]
# (21 MB), and by 1-4 % from there to 168 MB
LANE_DIRECT_MAX_BYTES = 16 << 20
# what shared memory holds (227 KB a CTA): G1's staged route stages a whole
# row, G2 a 32-column strip (128 B a row)
LANE_STAGE_MAX_COLS, SUB_MAX_ROWS = 58112, 1816
# kernel launches, G1's by route (incremented where the kernel is launched
# and nowhere else)
LAUNCH_COUNTS = {"gather_lane/direct": 0, "gather_lane/staged": 0, "gather_sub": 0}
# the JAX tool's line names -> the wrapper
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


def pick_route(rows: int, cols: int, route=None) -> str:
    """G1's route for x [rows, cols] int32: "staged" where x exceeds
    LANE_DIRECT_MAX_BYTES and a row fits in shared memory (at most
    LANE_STAGE_MAX_COLS columns), else "direct". ``route`` asks for one:
    returned as it is, or raises if the shape cannot take it."""
    stageable = cols <= LANE_STAGE_MAX_COLS
    if route is None:
        return "staged" if stageable and rows * cols * 4 > LANE_DIRECT_MAX_BYTES else "direct"
    if route not in LANE_ROUTES:
        raise ValueError(f"gather_lane: route {route!r} is none of {LANE_ROUTES}")
    if route == "staged" and not stageable:
        raise ValueError("gather_lane's staged route stages a whole row of x in shared memory: "
                         f"at most {LANE_STAGE_MAX_COLS} columns, got {cols}")
    return route


def lane_routes(x) -> tuple:
    """The routes G1 can take at x's shape, its wrapper's choice first."""
    chosen = pick_route(*x.shape)
    return (chosen, *(r for r in LANE_ROUTES if r != chosen
                      and (r == "direct" or x.shape[1] <= LANE_STAGE_MAX_COLS)))


def _check_args(x, idx, axis: int, what: str) -> str:
    kind = device_kind(what, x, idx)
    other = 1 - axis
    if (x.dtype != torch.int32 or idx.dtype != torch.int32 or x.dim() != 2 or idx.dim() != 2
            or x.shape[other] != idx.shape[other]):
        raise ValueError(f"{what} takes x and idx 2-D int32 of one extent along axis {other}, "
                         f"got {tuple(x.shape)} {x.dtype} and {tuple(idx.shape)} {idx.dtype}")
    if kind == "cuda" and max(x.numel(), idx.numel()) >= 2 ** 31:
        raise ValueError(f"{what}: the kernels index fewer than 2^31 ints, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    return kind


def _launch(fn_name: str, count: str, x, idx, *shape):
    """One gather kernel on CUDA tensors -> its output, idx's shape."""
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load(_build.TOOLS)
    x, idx = x.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    with torch.cuda.device(x.device):
        code = getattr(lib, fn_name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     *shape, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, fn_name)
    LAUNCH_COUNTS[count] += 1
    return out


def gather_lane(x, idx, check: bool = True, route=None):
    """G1: out[i, j] = x[i, idx[i, j]] (take_along_axis, axis 1) -> out
    idx's shape, int32. x [R, L], idx [R, M] int32, every index in [0, L).
    ``route``: None (pick_route's choice), "direct" or "staged"."""
    kind = _check_args(x, idx, 1, "gather_lane")
    route = pick_route(*x.shape, route)
    if check:
        check_indices(idx, x.shape[1], "gather_lane")
    if kind == "cpu":
        return gather_lane_plain(x, idx)
    return _launch("splat_probe_gather_lane", f"gather_lane/{route}", x, idx, x.shape[0],
                   x.shape[1], idx.shape[1], LANE_ROUTES.index(route))


def gather_lane_plain(x, idx):
    """gather_lane in PyTorch: x flattened, read at i * L + idx[i, j]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None] * x.shape[1]
    return x.reshape(-1)[rows + idx.long()]


def gather_sub(x, idx, check: bool = True):
    """G2: out[i, j] = x[idx[i, j], j] (take_along_axis, axis 0) -> out
    idx's shape, int32. x [R, L] with R at most SUB_MAX_ROWS, idx [M, L]
    int32, every index in [0, R)."""
    kind = _check_args(x, idx, 0, "gather_sub")
    if x.shape[0] > SUB_MAX_ROWS:
        raise ValueError("gather_sub stages a 32-column strip of x (128 B a row) in shared "
                         f"memory: at most {SUB_MAX_ROWS} rows, got {x.shape[0]}")
    if check:
        check_indices(idx, x.shape[0], "gather_sub")
    if kind == "cpu":
        return gather_sub_plain(x, idx)
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
    -> per probe its shape, its route (G1's pick_route choice; G2 "staged")
    and ms, G1's every route's ms, the bound, the plain version's ms,
    torch.gather's ms, ``equal`` (every route, the plain version and
    torch.gather alike) and ``max_abs_err`` (the routes against the plain
    version); the launch floor. The first launch of each route checks its
    indices; the timed ones do not."""
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms

    args = {"lane": (inputs["lane_x"], inputs["lane_idx"], 1),
            "sub": (inputs["sub_x"], inputs["sub_idx"], 0)}
    plain = {"lane": gather_lane_plain, "sub": gather_sub_plain}
    idx64 = {k: idx.long() for k, (_, idx, _) in args.items()}
    # each probe's kernel calls by route: G1 every route its shape can take
    kernel = {"lane": {r: lambda x, idx, check=False, r=r: gather_lane(x, idx, check, route=r)
                       for r in lane_routes(inputs["lane_x"])},
              "sub": {"staged": gather_sub}}
    equal, err = {}, {}
    calls = {f"launch_floor/{k}": fn
             for k, fn in launch_floor_calls(inputs["lane_x"].device).items()}
    for k, (x, idx, axis) in args.items():
        want = plain[k](x, idx)
        equal[k], err[k] = bool(torch.equal(torch.gather(x, axis, idx64[k]), want)), 0.0
        calls[f"{k}/plain"] = lambda k=k, x=x, idx=idx: plain[k](x, idx)
        calls[f"{k}/library"] = lambda k=k, x=x, axis=axis: torch.gather(x, axis, idx64[k])
        for r, fn in kernel[k].items():
            got = fn(x, idx, check=True)
            equal[k] = equal[k] and bool(torch.equal(got, want))
            err[k] = max(err[k], float((got - want).abs().max()))
            calls[f"{k}/{r}"] = lambda fn=fn, x=x, idx=idx: fn(x, idx, check=False)
        del want, got
    # rotated: no call always follows the same one, whose arrays it would
    # find in L2 or not (between 2 and 40 MB that sways a time by a third)
    ms = rounds_ms(calls, ITERS, rotate=True)
    floor = launch_floor(ms)
    result = {"iters": ITERS, **floor, "probes": {}}
    for k, (x, idx, axis) in args.items():
        nbytes = (x.numel() + 2 * idx.numel()) * 4
        route = next(iter(kernel[k]))
        result["probes"][k] = {
            "name": PROBES[k][0], "kernel": PROBES[k][1], "replaces": REPLACES[k],
            "x": list(x.shape), "idx": list(idx.shape), "axis": axis, "equal": equal[k],
            "max_abs_err": err[k], "route": route, "ms": ms[f"{k}/{route}"],
            **({"routes_ms": {r: ms[f"lane/{r}"] for r in kernel[k]}} if k == "lane" else {}),
            "bytes": nbytes, **bound_with_floor(nbytes, floor["launch_floor_ms"]),
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
              f"{r['route']}, {r['ms']:.4f} ms)", flush=True)
    report("probe_dyngather", measured, args.out)
    wrong = [k for k, r in measured["probes"].items() if not r["equal"]]
    if wrong:
        raise AssertionError(f"probe_dyngather: {wrong} differ from their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
