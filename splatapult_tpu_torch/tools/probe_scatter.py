"""The scatter half of a radix-sort pass on the GPU: the probes P1-P3.

    python -m splatapult_tpu_torch.tools.probe_scatter [--blocks 64] [--out FILE.json]

The counterpart of the JAX repo's tools/probe_scatter.py, at its shapes: rows
[NB * B, W] f32 with B = 1024 rows a block, W = 8 and NB = 64 blocks (65,536
rows), 128-row chunks. ``--blocks`` sets NB (4096: the baselines' 4,194,304
rows). The JAX tool asks which scatter mechanisms Mosaic can lower; each is a
hand-written CUDA kernel here (kernels/csrc/probe_scatter.cu), behind a
wrapper that launches it for CUDA tensors and takes the plain version for CPU
tensors:

  A  per-row dynamic store (P1, tools/probe_scatter.py:77, kernel_a):
     out[j*B + dest[j, i]] = rows[j*B + i]                    scatter_rows
  B  chunk store at dynamic offset (P2, :118, kernel_b): each 128-row chunk
     stored at its block's chunk destination                   scatter_chunks
  C  masked store at dynamic offset (P3, :161, kernel_c): the output zeroed,
     then the first 64 rows of each chunk stored so            scatter_half_chunks

Each block's table must be a permutation, as the JAX tool draws it (:62,
:104): the wrappers check that on the device before they launch and raise
otherwise (``check=False`` skips the check: the tool does so only in its timed
repeats, on tables it checked). Beside each wrapper: its plain PyTorch version
(a scatter_ along the blocks' [NB, B, W] or [NB, NCH, CH * W] view) and, timed
here as a yardstick only, the one library call that computes the same
function: index_copy_ with the global row or chunk index (for C a zero fill
and an index_copy_ of the halves: two calls).

The inputs are the JAX tool's: numpy's default_rng(0) draws the rows, the row
permutations, the chunk permutations and the baselines' rows and
permutation in the tool's order, so at the default shapes they are its
arrays. The baselines run at 4,194,304 rows of 8 f32, under the JAX
tool's names: "permutation row scatter [4M, 8]" (XLA's scatter there,
index_copy_ here) and "sort 1 key + 8 operands [4M]" (lax.sort there;
torch.sort of the int32 key, then the rows gathered in its order by the
port's ops.composite.gather_rows, here; the JSON also gives the key sort
alone and the sort with torch's index_select as the row gather).

Timing: profile_bin.rounds_ms (each call timed alone by CUDA events with the
stream held while the host issues it, the median of 30 after one warm-up,
the calls taking turns round by round, the order rotated by one each round),
not the JAX tool's minimum of host-timed calls. Bounds: the bytes each
function must move (each input read once, each output written once) at 3.35
TB/s (profile_phases.bound), raised to the launch floor where that is larger:
the lesser of a one-element copy_ and an empty kernel, timed in the same
rounds (``launch_floor_ms``; at the JAX tool's shapes the bytes take a
microsecond or less).

It prints the JAX tool's lines (``A per-row dynamic store: OK 0.5 ns/row
...``) and, last, one JSON line: per kernel its ms, ns_per_row, bound,
library call and time, and whether kernel, plain version and library call
agree bit for bit; the baselines' ms and ns/row; the launch floor; the
card's name and power limit as nvidia-smi reports them. No fallback: where the JAX tool prints
FAILED for a mechanism Mosaic cannot lower, a kernel here that fails to
build, launch or match raises. GPU only: with no CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

B, W, NB, CH = 1024, 8, 64, 128  # the JAX tool's rows a block, row width, blocks, chunk rows
BASELINE_ROWS = 4 << 20
ITERS = 30  # the JAX tool's repeats of each probe
# kernel launches by wrapper (incremented where the kernel is launched and
# nowhere else)
LAUNCH_COUNTS = {"scatter_rows": 0, "scatter_chunks": 0, "scatter_half_chunks": 0}
# the JAX tool's letters -> (its line's name, the wrapper's launch count)
PROBES = {"A": ("per-row dynamic store", "scatter_rows"),
          "B": ("chunk store at dynamic offset", "scatter_chunks"),
          "C": ("masked store at dynamic offset", "scatter_half_chunks")}
REPLACES = {"A": "tools/probe_scatter.py:77", "B": "tools/probe_scatter.py:118",
            "C": "tools/probe_scatter.py:161"}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def device_kind(what: str, *tensors) -> str:
    """"cpu" or "cuda", the one device every tensor lies on; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes tensors on one CPU or CUDA device, got {devices}")
    return next(iter(devices)).type


def check_block_permutation(table, width: int, what: str) -> None:
    """Raise unless every row of ``table`` [NB, width] int32 is a permutation
    of 0..width-1 (one readback)."""
    want = torch.arange(width, dtype=torch.int32, device=table.device)
    if not bool((torch.sort(table, dim=1).values == want).all()):
        raise ValueError(f"{what}: a row of the table is not a permutation of 0..{width - 1}")


def _check_args(rows, table, entry_rows: int, what: str) -> tuple:
    """The wrappers' checks -> (device kind, NB, the table's width, rows a
    block): rows [NB * width * entry_rows, W] float32, table [NB, width]
    int32; an entry of the table moves entry_rows rows (P1 1, P2 and P3 CH)."""
    kind = device_kind(what, rows, table)
    if table.dtype != torch.int32 or table.dim() != 2:
        raise ValueError(f"{what} takes a table [NB, width] int32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    nb, width = table.shape
    block_rows = width * entry_rows
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[0] != nb * block_rows:
        raise ValueError(f"{what} takes rows [{nb} x {block_rows}, W] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if kind == "cuda" and (rows.shape[1] % 4 != 0 or rows.numel() >= 2 ** 31):
        raise ValueError(f"{what}: the kernel moves rows in 16-byte parts (W a multiple of 4) "
                         f"and indexes fewer than 2^31 floats, got {tuple(rows.shape)}")
    return kind, nb, width, block_rows


def _launch(fn_name: str, count: str, rows, table, *shape):
    """One probe kernel on CUDA tensors -> its output rows."""
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load(_build.TOOLS)
    rows, table = rows.contiguous(), table.contiguous()
    out = torch.empty_like(rows)
    with torch.cuda.device(rows.device):
        code = getattr(lib, fn_name)(rows.data_ptr(), table.data_ptr(), out.data_ptr(), *shape,
                                     rows.shape[1] // 4, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, fn_name)
    LAUNCH_COUNTS[count] += 1
    return out


def scatter_rows(rows, dest, check: bool = True):
    """P1: out[j*B + dest[j, i]] = rows[j*B + i] -> out [NB * B, W] float32.
    rows [NB * B, W] float32, dest [NB, B] int32, each row a permutation."""
    kind, nb, b, _ = _check_args(rows, dest, 1, "scatter_rows")
    if check:
        check_block_permutation(dest, b, "scatter_rows")
    if kind == "cpu":
        return scatter_rows_plain(rows, dest)
    return _launch("splat_probe_scatter_rows", "scatter_rows", rows, dest, nb, b)


def scatter_rows_plain(rows, dest):
    """scatter_rows in PyTorch: a scatter_ along the blocks' [NB, B, W] view
    (rows no destination names stay 0, as the JAX tool's want)."""
    nb, b = dest.shape
    view = (nb, b, rows.shape[1])
    out = torch.zeros_like(rows)
    out.view(view).scatter_(1, dest.long()[:, :, None].expand(view), rows.reshape(view))
    return out


def scatter_chunks(rows, cdest, check: bool = True):
    """P2: out[j*B + cdest[j, c]*CH + r] = rows[j*B + c*CH + r] for r < CH ->
    out [NB * B, W] float32. cdest [NB, NCH] int32, each row a permutation;
    B = NCH * CH, CH = 128."""
    kind, nb, nch, b = _check_args(rows, cdest, CH, "scatter_chunks")
    if check:
        check_block_permutation(cdest, nch, "scatter_chunks")
    if kind == "cpu":
        return scatter_chunks_plain(rows, cdest)
    return _launch("splat_probe_scatter_chunks", "scatter_chunks", rows, cdest, nb, b)


def scatter_chunks_plain(rows, cdest):
    """scatter_chunks in PyTorch: a scatter_ along the [NB, NCH, CH * W] view."""
    nb, nch = cdest.shape
    view = (nb, nch, CH * rows.shape[1])
    out = torch.zeros_like(rows)
    out.view(view).scatter_(1, cdest.long()[:, :, None].expand(view), rows.reshape(view))
    return out


def scatter_half_chunks(rows, cdest, check: bool = True):
    """P3: the output zeroed, then out[j*B + cdest[j, c]*CH + r] =
    rows[j*B + c*CH + r] for r < CH / 2 only -> out [NB * B, W] float32."""
    kind, nb, nch, b = _check_args(rows, cdest, CH, "scatter_half_chunks")
    if check:
        check_block_permutation(cdest, nch, "scatter_half_chunks")
    if kind == "cpu":
        return scatter_half_chunks_plain(rows, cdest)
    return _launch("splat_probe_scatter_half_chunks", "scatter_half_chunks", rows, cdest, nb,
                   b)


def scatter_half_chunks_plain(rows, cdest):
    """scatter_half_chunks in PyTorch: the scatter_ of scatter_chunks_plain with
    an index that covers the first CH / 2 rows of each chunk only."""
    nb, nch = cdest.shape
    w = rows.shape[1]
    view = (nb, nch, CH * w)
    out = torch.zeros_like(rows)
    index = cdest.long()[:, :, None].expand(nb, nch, CH // 2 * w)
    out.view(view).scatter_(1, index, rows.reshape(view))
    return out


def library_calls(rows, dest, cdest) -> dict:
    """Per probe letter, the library call that computes the same function (a
    yardstick the port never calls): (its name, a function of no arguments
    -> its output). The global indices are made here, outside the calls."""
    nb, b = dest.shape
    nch, w = cdest.shape[1], rows.shape[1]
    g_rows = (torch.arange(nb, device=rows.device)[:, None] * b + dest.long()).reshape(-1)
    g_chunks = (torch.arange(nb, device=rows.device)[:, None] * nch + cdest.long()).reshape(-1)
    chunks = rows.view(nb * nch, CH, w)
    half = CH // 2

    def half_chunks():
        out = torch.zeros_like(rows)
        out.view(nb * nch, CH, w)[:, :half].index_copy_(0, g_chunks, chunks[:, :half])
        return out

    return {
        "A": ("index_copy_ (global row index)",
              lambda: torch.empty_like(rows).index_copy_(0, g_rows, rows)),
        "B": ("index_copy_ (global chunk index, 4 KiB slices)",
              lambda: torch.empty_like(rows).view(nb * nch, CH * w).index_copy_(
                  0, g_chunks, chunks.view(nb * nch, CH * w)).view(-1, w)),
        "C": ("zeros + index_copy_ of the halves (two calls)", half_chunks),
    }


def launch_floor_calls(device) -> dict:
    """Two launches that do next to nothing -> {name: function of no
    arguments}: "copy_", a one-element copy_ (4 bytes; ATen may issue it as
    a device-to-device memcpy, not a kernel), and "empty_kernel", an empty
    kernel of the tools library (splat_probe_empty, one thread). Timed in
    the same rounds as the probes; launch_floor takes the smaller."""
    src = torch.zeros(1, dtype=torch.int32, device=device)
    dst = torch.empty_like(src)

    def empty_kernel():
        from splatapult_tpu_torch.kernels import _build

        with torch.cuda.device(src.device):
            code = _build.load(_build.TOOLS).splat_probe_empty(
                torch.cuda.current_stream().cuda_stream)
        _build.check_launch(code, "splat_probe_empty")

    return {"copy_": lambda: dst.copy_(src), "empty_kernel": empty_kernel}


def launch_floor(ms: dict) -> dict:
    """The launch floor from rounds_ms's times, whose ``launch_floor/<name>``
    keys are launch_floor_calls' -> {"launch_floor_ms": the least of them,
    "launch_floor_calls_ms": {name: ms}}."""
    by_call = {k.split("/", 1)[1]: v for k, v in ms.items() if k.startswith("launch_floor/")}
    return {"launch_floor_ms": min(by_call.values()), "launch_floor_calls_ms": by_call}


def bound_with_floor(nbytes: int, floor_ms: float) -> dict:
    """profile_phases.bound of the bytes, raised to the launch floor where
    that is larger -> {"bound_ms", "bound_by" ("bytes" or "launch"),
    "bytes_bound_ms"}."""
    from splatapult_tpu_torch.tools.profile_phases import bound

    by_bytes = bound(nbytes, 0)["bound_ms"]
    if floor_ms > by_bytes:
        return {"bound_ms": floor_ms, "bound_by": "launch", "bytes_bound_ms": by_bytes}
    return {"bound_ms": by_bytes, "bound_by": "bytes", "bytes_bound_ms": by_bytes}


def scatter_bytes(letter: str, rows, cdest) -> int:
    """The bytes the probe's function must move: each input read once, each
    output written once (C reads only the halves it stores)."""
    rb, tb = rows.numel() * 4, rows.shape[0] * 4
    return {"A": 2 * rb + tb, "B": 2 * rb + cdest.numel() * 4,
            "C": rb // 2 + rb + cdest.numel() * 4}[letter]


def make_inputs(blocks: int = NB, seed: int = 0, baselines: bool = True) -> dict:
    """The JAX tool's arrays, drawn in its order (tools/probe_scatter.py:56-62,
    :101-104, :186-188) -> numpy arrays rows [blocks * B, W] f32, dest
    [blocks, B] and cdest [blocks, NCH] int32; with ``baselines`` also the
    baselines' base_rows [4M, W] f32 and base_dest [4M] int32."""
    rng = np.random.default_rng(seed)
    out = {"rows": rng.standard_normal((blocks * B, W)).astype(np.float32),
           "dest": np.stack([rng.permutation(B) for _ in range(blocks)]).astype(np.int32)}
    out["cdest"] = np.stack([rng.permutation(B // CH) for _ in range(blocks)]).astype(np.int32)
    if baselines:
        out["base_rows"] = rng.standard_normal((BASELINE_ROWS, W)).astype(np.float32)
        out["base_dest"] = rng.permutation(BASELINE_ROWS).astype(np.int32)
    return out


def measure(inputs: dict) -> dict:
    """Every probe kernel on the inputs (make_inputs' arrays as CUDA tensors)
    -> per letter its ms, ns_per_row, bound, the plain version's ms, the
    library call and its ms, ``equal`` (kernel, plain version and library
    call bit for bit) and ``max_abs_err`` (kernel against plain version);
    with the base_* inputs, the baselines; the launch floor (launch_floor),
    which each bound is raised to where the bytes take less. The first launch
    of each kernel checks its table; the timed ones do not."""
    from splatapult_tpu_torch.ops.composite import gather_rows
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms
    from splatapult_tpu_torch.tools.profile_phases import bound

    rows, dest, cdest = inputs["rows"], inputs["dest"], inputs["cdest"]
    kernel = {"A": lambda check=False: scatter_rows(rows, dest, check=check),
              "B": lambda check=False: scatter_chunks(rows, cdest, check=check),
              "C": lambda check=False: scatter_half_chunks(rows, cdest, check=check)}
    plain = {"A": lambda: scatter_rows_plain(rows, dest),
             "B": lambda: scatter_chunks_plain(rows, cdest),
             "C": lambda: scatter_half_chunks_plain(rows, cdest)}
    library = library_calls(rows, dest, cdest)
    equal, err = {}, {}
    for k in PROBES:
        want, got = plain[k](), kernel[k](check=True)
        equal[k] = bool(torch.equal(got, want) and torch.equal(library[k][1](), want))
        err[k] = float((got - want).abs().max())
    del want, got
    calls = {**kernel, **{f"{k}/plain": fn for k, fn in plain.items()},
             **{f"{k}/library": fn for k, (_, fn) in library.items()},
             **{f"launch_floor/{k}": fn for k, fn in launch_floor_calls(rows.device).items()}}
    base = {}
    if "base_rows" in inputs:
        b_rows, b_dest = inputs["base_rows"], inputs["base_dest"]
        b_dest64 = b_dest.long()  # index_copy_ takes an int64 index: made outside the call
        calls["baseline/scatter"] = lambda: torch.empty_like(b_rows).index_copy_(0, b_dest64,
                                                                                 b_rows)
        # the int32 key sorted as lax.sort sorts it, then the rows gathered in its
        # order as the port gathers rows (gather_rows: 16-byte elements); the key
        # sort alone, and torch's own row gather (index_select) beside it
        calls["baseline/sort"] = lambda: gather_rows(b_rows, torch.sort(b_dest).indices)
        calls["baseline/sort_keys"] = lambda: torch.sort(b_dest)
        calls["baseline/sort_index_select"] = lambda: b_rows.index_select(
            0, torch.sort(b_dest).indices)
        base = {"scatter": ("permutation row scatter [4M, 8]", "index_copy_", 2 * b_rows.numel() * 4
                            + b_dest.numel() * 4),
                "sort": ("sort 1 key + 8 operands [4M]", "torch.sort + gather_rows",
                         2 * (b_rows.numel() + b_dest.numel()) * 4)}
    ms = rounds_ms(calls, ITERS, rotate=True)
    n = rows.shape[0]
    floor = launch_floor(ms)
    result = {"rows": n, "blocks": dest.shape[0], "block_rows": dest.shape[1],
              "width": rows.shape[1], "chunk_rows": CH, "iters": ITERS, **floor, "probes": {}}
    for k, (name, count) in PROBES.items():
        nbytes = scatter_bytes(k, rows, cdest)
        result["probes"][k] = {
            "name": name, "kernel": count, "replaces": REPLACES[k], "equal": equal[k],
            "max_abs_err": err[k], "ms": ms[k], "ns_per_row": ms[k] * 1e6 / n,
            "bytes": nbytes, **bound_with_floor(nbytes, floor["launch_floor_ms"]),
            "plain_ms": ms[f"{k}/plain"],
            "library": library[k][0], "library_ms": ms[f"{k}/library"]}
    if base:
        nb_rows = inputs["base_rows"].shape[0]
        result["baselines"] = {
            k: {"name": name, "call": call, "ms": ms[f"baseline/{k}"],
                "ns_per_row": ms[f"baseline/{k}"] * 1e6 / nb_rows, "rows": nb_rows,
                "bytes": nbytes, **bound(nbytes, 0)}
            for k, (name, call, nbytes) in base.items()}
        result["baselines"]["sort"].update(key_sort_ms=ms["baseline/sort_keys"],
                                           with_index_select_ms=ms["baseline/sort_index_select"])
    return result


def on_device(inputs: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--blocks", type=int, default=NB, help="blocks of 1024 rows (NB)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap.parse_args(argv)


def report(tool: str, measured: dict, out_path) -> None:
    """Print (and with ``out_path`` write) the tool's JSON line."""
    from splatapult_tpu_torch.cli import gpu_name_and_power_limit

    text = json.dumps({"tool": tool, **measured, "device": torch.cuda.get_device_name(0),
                       "nvidia_smi_name_power_limit": gpu_name_and_power_limit()})
    print(text, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_scatter: no CUDA device (GPU only: a host timing would not be a device "
              "number)", file=sys.stderr)
        return 1
    measured = measure(on_device(make_inputs(args.blocks), "cuda"))
    for k, r in measured["probes"].items():
        extra = {"A": f"{measured['rows']} rows, ", "B": f"{CH}-row chunks, ", "C": ""}[k]
        print(f"{k} {r['name']}: {'OK' if r['equal'] else 'WRONG'} {r['ns_per_row']:.3f} ns/row "
              f"({extra}{r['ms']:.4f} ms)", flush=True)
    for r in measured["baselines"].values():
        print(f"{r['call']} {r['name']}: {r['ns_per_row']:.3f} ns/row", flush=True)
    report("probe_scatter", measured, args.out)
    wrong = [k for k, r in measured["probes"].items() if not r["equal"]]
    if wrong:
        raise AssertionError(f"probe_scatter: {wrong} differ from their plain versions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
