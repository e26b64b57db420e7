"""The roofline of one training step on the H100: the least time each phase of
one view's forward + backward + Adam step could take, beside the step.

    python -m splatapult_tpu_torch.tools.roofline [--splats 1500000]
        [--scene garden|ball] [--measured-ms X] [--device cuda|cpu]

The counterpart of the JAX repo's tools/roofline.py, priced on this card's
rates only. The scene and its view are bench.py's (tools/scenes.py). The
splats are prepared (unsorted, as the tiled path runs them) and the view's
tile-instance demand counted (ops/binning.instance_demand); the first line is
the JAX tool's geometry line from its formulas (demand, its emax of demand x
1.06 rounded up to 4096, mcap = emax + tiles x block, blocks, pairs = every
slot of every block against every pixel). The rows are priced at the
capacity render.calibrate_config allocates for the view (printed next), the
one the port's step runs at, under the default (exact) profile (roofline()
prices any config). Each row is the floor of one phase of the step:

- binning: the overflow drop's [N] depth sort and the main sort at the
  measured torch.sort rate, kernel B1 (expand fill) at its bytes bound, the
  tile histogram's bytes;
- instance gather: ops/composite.gather_rows at its measured rate per index
  for the filled slots, and for the slots that name the null row (the
  alignment pads, the unfilled capacity) the bytes of their index and row;
- fwd kernel, bwd kernel: B2's and B3's bounds on the view's own binning,
  tools/profile_phases.composite_bounds (the (slot, pixel) pairs above the
  alpha discard in the walked blocks; chip_smoke.py's bound_ms);
- backward tail: per_splat_sums' id sort at the measured rate and the bytes
  of its columns and its output;
- the phases the JAX model leaves out, each at the bytes it must read and
  write once: prepare_splats forward + VJP, pack_features forward +
  backward, and Adam (the parameters and both moments read and written, the
  gradient read: 7 passes over 59 floats a splat at SH degree 3).

Two totals follow, as in the JAX tool: the measured-rate floor (the sum of
the rows) and the radix-bytes floor (each sort at the bytes of an LSD radix
sort: a read and a write of key and 4-byte index per 8-bit digit of the
key's bits), then the pure-bytes line (every row's bytes in one pass at the
memory rate), and with ``--measured-ms`` the share of each total. The last
line is one JSON object with every row, the totals and, on the card, its
name and power limit.

The memory and fp32 rates are tools/profile_phases.py's (HBM_BYTES_PER_S,
FP32_FLOP_PER_S): the roofline and the kernels' bounds have one source.
The sort and gather rates are curves measured on the card (measure_curves;
chip_smoke.py phase roofline prints them beside the recorded ones). There is
no matrix-unit term and no per-grid-step term: B2 and B3 use no tensor core
and have no sequential grid.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys

import torch

from splatapult_tpu_torch.tools.profile_phases import (FP32_FLOP_PER_S, HBM_BYTES_PER_S,
                                                       bounds_of_counts, composite_counts)

# the card and the run that measured the curves below (measure_curves), as
# nvidia-smi --query-gpu=name,power.limit --format=csv,noheader gives them
CURVES_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CURVES_SOURCE = ("measure_curves() in chip_smoke.py phase roofline: CUDA events with the "
                 "stream held, median of 5")
# torch.sort(key, stable=True) -> (keys, int64 indices), by the key's bytes:
# seconds per row per operand (two: the key and the index) at the row counts
# of the JAX tool's curve
SORT_ROWS = (1_330_000, 2_660_000, 5_320_000, 10_640_000)
SORT_CURVES = {
    8: [(1_330_000, 1.0532e-10), (2_660_000, 8.513e-11), (5_320_000, 7.367e-11),
        (10_640_000, 6.812e-11)],
    4: [(1_330_000, 4.899e-11), (2_660_000, 4.170e-11), (5_320_000, 3.347e-11),
        (10_640_000, 2.964e-11)],
}
# gather_rows of a [T, row bytes] table at GATHER_INDEX_RATIO x T uniform
# random int64 indices in ascending order (the table read in address order:
# the gather's best order; a view's tile-sorted ids come close to it, uniform
# random ones do not), by the row's bytes: seconds per index at table sizes
# that bracket 1.5M and 5M splats
GATHER_TABLE_ROWS = (1_000_000, 2_000_000, 4_000_000, 8_000_000)
GATHER_INDEX_RATIO = 2
GATHER_CURVES = {
    64: [(1_000_000, 7.190e-11), (2_000_000, 6.905e-11), (4_000_000, 6.710e-11),
         (8_000_000, 6.608e-11)],
    32: [(1_000_000, 4.278e-11), (2_000_000, 4.070e-11), (4_000_000, 3.876e-11),
         (8_000_000, 3.769e-11)],
}
ADAM_PASSES = 7  # parameter, first and second moment read and written, gradient read
PREPARE_OUT_FLOATS = 13  # mean2d 2, conic 3, rgb 3, alpha, depth, radius, extent 2 (+ a mask byte)
PACK_IN_FLOATS = 9  # mean2d, conic, rgb, alpha: the columns pack_features reads
INDEX_BYTES = 4  # the index a radix sort carries, and the gather's splat id (int32)


def sort_ns_row_op(rows: float, curve) -> float:
    """Seconds per row per operand of a sort of ``rows`` rows (the JAX tool's
    name and rule): log-linear in the row count between the curve's points
    [(rows, seconds)], flat beyond its ends."""
    if rows <= curve[0][0]:
        return curve[0][1]
    if rows >= curve[-1][0]:
        return curve[-1][1]
    for (r0, c0), (r1, c1) in zip(curve, curve[1:]):
        if r0 <= rows <= r1:
            t = (math.log(rows) - math.log(r0)) / (math.log(r1) - math.log(r0))
            return c0 + t * (c1 - c0)
    return curve[-1][1]


def gather_ns_idx(table_rows: float, steps) -> float:
    """Seconds per index of a gather from a table of ``table_rows`` rows (the
    JAX tool's name and rule): the cost of the first step [(rows, seconds)]
    whose table is at least as large, the last step's beyond them."""
    for rows, cost in steps:
        if table_rows <= rows:
            return cost
    return steps[-1][1]


def radix_sort_s(rows: float, op_bytes: float, key_bits: int,
                 hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """An LSD radix sort's bytes floor: each row's operands read and written
    once per 8-bit digit of the key."""
    return math.ceil(key_bits / 8) * rows * op_bytes * 2 / hbm_bytes_per_s


def jax_geometry(demand: int, tiles: int, tile_pixels: int, block: int) -> dict:
    """The JAX tool's geometry (its tools/roofline.py formulas): emax the
    demand with 6 % headroom rounded up to 4096, mcap the worst-case aligned
    capacity, every slot of every block against every pixel."""
    emax = int(demand * 1.06 // 4096 + 1) * 4096
    mcap = emax + tiles * block
    blocks = mcap // block
    return {"demand": demand, "emax": emax, "mcap": mcap, "blocks": blocks,
            "pairs": blocks * block * tile_pixels}


def geometry_line(scene: str, n: int, g: dict) -> str:
    return (f"scene={scene} n={n} demand={g['demand']} emax={g['emax']} mcap={g['mcap']} "
            f"blocks={g['blocks']} pairs={g['pairs'] / 1e9:.2f}G")


def view_inputs(scene, cam, cfg, grid=None, row_offset=None, y_shift: float = 0.0) -> dict:
    """One view binned at ``cfg``'s grid (or ``grid``, a band's: an
    interleaved band's with its ``row_offset``, or a contiguous band's with
    the splats' y shifted down by ``y_shift``, as parallel/mesh.py bins
    them) -> what the rows are priced on: the grid, the splat count and the
    parameter floats a splat, the instance rows, each tile's block range and
    the blocks the forward walks (all of them without an early stop; with
    one, the forward is run to find them)."""
    from splatapult_tpu_torch.ops import binning as B, composite as C, tiled

    R = importlib.import_module("splatapult_tpu_torch.render")
    n = scene.means.shape[0]
    grid = grid or tiled._grid_from_config(cfg, n)
    with torch.no_grad():
        d = R.prepare_splats(scene, cam, cfg, sort=False)
        if y_shift:
            d["mean2d"] = d["mean2d"] - d["mean2d"].new_tensor([0.0, y_shift])
        bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"], row_offset)
        feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
        inst = C.gather_rows(C.pack_src(feats, grid), bins["inst_splat"].long())
        start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
        if grid.early_stop_eps > 0.0:
            walked = C.composite_fwd(inst, start, nblk, grid, checkpoints=True)[1].walked
        else:
            walked = nblk
    return {"grid": grid, "n": n, "param_floats": 11 + 3 * scene.sh.shape[-1], "inst": inst,
            "start": start, "seg": C.Segments(ckpt=None, walked=walked),
            "filled": int(bins["tile_count"].sum()),
            "culled": int(bins["num_culled_instances"])}


def step_rows(v: dict) -> list:
    """The floor of each phase of one view's step on the binning ``v``
    (view_inputs) -> [{"name", "s": measured-rate floor, "radix_s":
    radix-bytes floor, "bytes": the bytes of one pass, "frame_s": the part a
    forward-only frame runs, "stage": the measured call it is held
    against}], seconds."""
    from splatapult_tpu_torch.ops import binning as B, composite as C

    grid, n, p_floats = v["grid"], v["n"], v["param_floats"]
    emax, mcap, tiles = grid.emax, grid.mcap, grid.num_tiles
    hbm = HBM_BYTES_PER_S
    mode = B.sort_key_mode(grid)
    key_bytes = 4 if B._PACKED_BITS[mode] else 8
    key_bits = (tiles - 1).bit_length() + (B._PACKED_BITS[mode] or 32)

    def sort_s(rows, nbytes):
        return rows * 2 * sort_ns_row_op(rows, SORT_CURVES[nbytes])

    # binning: the [N] float32 depth sort, the main sort, B1's bytes (each
    # table column read once, the [3, emax] rows written once), the histogram
    # (the tile ids read, the counts written)
    b1_hist = 16 * n + 12 * emax + 4 * emax + 4 * tiles
    binning = sort_s(n, 4) + sort_s(mcap, key_bytes) + b1_hist / hbm
    binning_radix = (radix_sort_s(n, 4 + INDEX_BYTES, 32)
                     + radix_sort_s(mcap, key_bytes + INDEX_BYTES, key_bits) + b1_hist / hbm)
    binning_bytes = 2 * (n * (4 + INDEX_BYTES) + mcap * (key_bytes + INDEX_BYTES)) + b1_hist
    row_bytes = 4 * C.num_feats(grid)
    # the filled slots at the measured rate; the alignment pads and the
    # sentinels all name the null row, which stays in cache: their index
    # read and row written
    filled = v["filled"]
    gather_bytes = filled * (2 * row_bytes + INDEX_BYTES) + (mcap - filled) * (
        row_bytes + INDEX_BYTES)
    gather = filled * gather_ns_idx(n, GATHER_CURVES[row_bytes]) + (mcap - filled) * (
        row_bytes + INDEX_BYTES) / hbm
    counts = composite_counts(v["inst"], v["start"], v["seg"], grid,
                              4 if grid.accum_dtype == "float32" else 2)
    bounds = bounds_of_counts(counts)
    fwd = bounds["composite_fwd"]["bound_ms"] / 1e3
    bwd = bounds["composite_bwd"]["bound_ms"] / 1e3
    # the tail: the id sort (int32 ids in [0, N]); the nine columns read,
    # seg_offs and seg_cnt read, the [N + 1, 16] gradients written
    tail_bytes = 4 * C.NUM_GRAD_COLS * mcap + 8 * n + 4 * C.NUM_FEATS * (n + 1)
    tail = sort_s(mcap, 4) + tail_bytes / hbm
    tail_radix = radix_sort_s(mcap, 4 + INDEX_BYTES, n.bit_length()) + tail_bytes / hbm
    # prepare: the parameters read, its outputs written; its VJP: the
    # parameters and the four read columns' cotangents read, the gradients
    # written
    prep_fwd = n * (4 * (p_floats + PREPARE_OUT_FLOATS) + 1)
    prep = prep_fwd + n * 4 * (2 * p_floats + PACK_IN_FLOATS)
    # pack_features: nine columns in, the [N + 1, 16] table out; backward: the
    # nine used columns of its cotangent in, their gradients out
    pack_fwd = n * 4 * PACK_IN_FLOATS + (n + 1) * 4 * C.NUM_FEATS
    pack = pack_fwd + n * 4 * 2 * PACK_IN_FLOATS
    adam = n * 4 * p_floats * ADAM_PASSES

    def row(name, s, radix_s, nbytes, frame_s, stage, **extra):
        return {"name": name, "s": s, "radix_s": radix_s, "bytes": nbytes,
                "frame_s": frame_s, "stage": stage, **extra}

    return [
        row("binning (sorts+expand)", binning, binning_radix, binning_bytes, binning,
            "bin_splats", key=mode),
        row("instance gather", gather, gather, gather_bytes, gather,
            "gather_rows", row_bytes=row_bytes),
        row("fwd kernel", fwd, fwd, counts["fwd_bytes"], fwd,
            "composite_fwd storing checkpoints", bound_by=bounds["composite_fwd"]["bound_by"]),
        row("bwd kernel", bwd, bwd, counts["bwd_bytes"], 0.0, "composite_bwd",
            bound_by=bounds["composite_bwd"]["bound_by"]),
        row("backward tail", tail, tail_radix, 2 * mcap * (4 + INDEX_BYTES) + tail_bytes, 0.0,
            "per_splat_sums"),
        row("prepare_splats fwd+VJP", prep / hbm, prep / hbm, prep, prep_fwd / hbm,
            "prepare_splats forward + VJP"),
        row("pack_features fwd+bwd", pack / hbm, pack / hbm, pack, pack_fwd / hbm,
            "pack_features forward + backward"),
        row("adam", adam / hbm, adam / hbm, adam, 0.0, "adam step"),
    ]


def totals(rows) -> dict:
    """Both floors, the pure-bytes line and the frame's floor -> ms and GB."""
    nbytes = sum(r["bytes"] for r in rows)
    return {"measured_rate_floor_ms": sum(r["s"] for r in rows) * 1e3,
            "radix_bytes_floor_ms": sum(r["radix_s"] for r in rows) * 1e3,
            "pure_bytes_gb": nbytes / 1e9, "pure_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "frame_floor_ms": sum(r["frame_s"] for r in rows) * 1e3}


def roofline(scene, cam, cfg) -> dict:
    """The view's geometry and every row and total at ``cfg``'s capacity
    (calibrate it first to price what the port allocates)."""
    from splatapult_tpu_torch.ops import binning as B

    v = view_inputs(scene, cam, cfg)
    grid, rows = v["grid"], step_rows(v)
    # the view's demand: every instance its rects enumerate, dropped or not
    demand = v["filled"] + v["culled"]
    return {"n": v["n"],
            "geometry": jax_geometry(demand, grid.num_tiles, grid.tile_pixels, grid.block),
            "capacity": {"max_instance_mult": cfg.max_instance_mult, "emax": grid.emax,
                         "mcap": grid.mcap, "tiles": grid.num_tiles,
                         "sort_key": B.sort_key_mode(grid), "culled": v["culled"]},
            "rows": rows, "totals": totals(rows)}


def measure_curves(device="cuda", iters: int = 5) -> dict:
    """The sort and gather curves on the card, timed with the stream held
    (tools/profile_bin.rounds_ms, median of ``iters``) -> {"sort": {key
    bytes: [(rows, seconds per row per operand)]}, "gather": {row bytes:
    [(table rows, seconds per index)]}}, in the recorded curves' form.
    Random int64 (8-byte) and int32 (4-byte) keys; random rows, and random
    indices in ascending order, from a seeded generator on the card."""
    from splatapult_tpu_torch.ops.composite import gather_rows
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms

    gen = torch.Generator(device=device).manual_seed(0)
    out = {"sort": {8: [], 4: []}, "gather": {64: [], 32: []}}
    for rows in SORT_ROWS:
        keys = {8: torch.randint(0, 2 ** 62, (rows,), generator=gen, device=device),
                4: torch.randint(0, 2 ** 31 - 1, (rows,), generator=gen, device=device,
                                 dtype=torch.int32)}
        ms = rounds_ms({b: (lambda k=k: torch.sort(k, stable=True)) for b, k in keys.items()},
                       iters)
        for b in keys:
            out["sort"][b].append((rows, ms[b] / 1e3 / (rows * 2)))
    for rows in GATHER_TABLE_ROWS:
        idx = torch.sort(torch.randint(0, rows, (GATHER_INDEX_RATIO * rows,), generator=gen,
                                       device=device))[0]
        tables = {b: torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, b // 4), generator=gen,
                                   device=device, dtype=torch.int32) for b in (64, 32)}
        ms = rounds_ms({b: (lambda t=t: gather_rows(t, idx)) for b, t in tables.items()}, iters)
        for b in tables:
            out["gather"][b].append((rows, ms[b] / 1e3 / idx.numel()))
    return out


def measure_stages(scene, start, cam, frame_cfg, iters: int = 3,
                   prepare_splats=()) -> dict:
    """One view's frame, its training step and the call each row is held
    against (a row's "stage"), on the card: each timed with the stream held
    (tools/profile_bin.rounds_ms, median of ``iters``), the stages on kept
    inputs of the view as tools/profile_phases.py and tools/profile_bwd.py
    cut the step, the step an Adam step of ``start`` towards the view of
    ``scene``; the frame and the step also by the card's busy time (the
    profiler's sum of kernel times); and prepare_splats forward + VJP on the
    first m splats of ``start`` for each m of ``prepare_splats`` (a tile
    shard's block of the sharded prepare) -> {"stages_ms", "device_busy_ms",
    "prepare_ms_by_splats": m -> ms (N's too), "binning": composite_bounds'
    arguments on the view's binning}. ``frame_cfg`` is the calibrated
    forward-only config; the step runs it with its backward."""
    import dataclasses

    from splatapult_tpu_torch import train
    from splatapult_tpu_torch.ops import binning as B, composite as C, tiled
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms
    from splatapult_tpu_torch.tools.profile_phases import _profile

    R = importlib.import_module("splatapult_tpu_torch.render")
    cfg = dataclasses.replace(frame_cfg, forward_only=False)
    grid = tiled._grid_from_config(cfg, scene.means.shape[0])
    params = train.leaf_copy(start)
    opt = train.default_optimizer(params, 1e-3)
    target = R.render(scene, cam, frame_cfg)
    with torch.no_grad():
        d = R.prepare_splats(scene, cam, cfg, sort=False)
    bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"])
    feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    src, ids = C.pack_src(feats, grid), bins["inst_splat"].long()
    inst = C.gather_rows(src, ids)
    first, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
    out, seg = C.composite_fwd(inst, first, nblk, grid, checkpoints=True)
    dout = torch.full_like(out, 1e-3)
    d_inst = C.composite_bwd(inst, first, nblk, out, dout, grid, seg)
    tail_args = (d_inst, bins["inst_splat"], bins["seg_offs"], bins["seg_cnt"], grid)
    d_feats = C.per_splat_sums(*tail_args)
    pack_in = [d[k].detach().requires_grad_(True) for k in ("mean2d", "conic", "rgb", "alpha")]

    def prepare_fwd(p=params):
        return R.prepare_splats(p, cam, cfg, sort=False)

    def prepare_fwd_vjp(p=params):
        dp = prepare_fwd(p)
        torch.autograd.grad(dp["mean2d"].sum() + dp["conic"].sum() + dp["rgb"].sum()
                            + dp["alpha"].sum(), [getattr(p, f.name) for f in
                                                  dataclasses.fields(p)])

    train.train_step(params, opt, cam, target, cfg)  # Adam's state and gradients exist
    calls = {
        "frame": lambda: R.render(scene, cam, frame_cfg),
        "step": lambda: train.train_step(params, opt, cam, target, cfg),
        "bin_splats": lambda: B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"]),
        "gather_rows": lambda: C.gather_rows(src, ids),
        "composite_fwd storing checkpoints": lambda: C.composite_fwd(
            inst, first, nblk, grid, checkpoints=True),
        "composite_fwd as served": lambda: C.composite_fwd(inst, first, nblk, grid),
        "composite_bwd": lambda: C.composite_bwd(inst, first, nblk, out, dout, grid, seg),
        "per_splat_sums": lambda: C.per_splat_sums(*tail_args),
        "prepare_splats forward": prepare_fwd,
        "prepare_splats forward + VJP": prepare_fwd_vjp,
        "pack_features forward + backward": lambda: torch.autograd.grad(
            tiled.pack_features(*pack_in), pack_in, d_feats),
        "adam step": opt.step,
    }
    n = scene.means.shape[0]
    parts = {m: train.leaf_copy(R.GaussianScene(**{f.name: getattr(start, f.name)[:m]
                                                   for f in dataclasses.fields(start)}))
             for m in sorted(set(prepare_splats) - {n})}
    for m, part in parts.items():
        calls[f"prepare_splats forward + VJP on {m} splats"] = (
            lambda part=part: prepare_fwd_vjp(part))
    ms = rounds_ms(calls, iters)
    busy = {k: _profile(calls[k], 2, ms[k])["device_busy_ms"] for k in ("frame", "step")}
    prep = {m: ms.pop(f"prepare_splats forward + VJP on {m} splats") for m in parts}
    prep[n] = ms["prepare_splats forward + VJP"]
    return {"stages_ms": ms, "device_busy_ms": busy, "prepare_ms_by_splats": prep,
            "binning": {"inst": inst, "start": first, "seg": seg, "grid": grid,
                        "val_bytes": out.element_size()}}


def report_lines(scene_name: str, res: dict, measured_ms=None) -> list:
    """The JAX tool's text lines for ``res`` (roofline())."""
    cap = res["capacity"]
    lines = [geometry_line(scene_name, res["n"], res["geometry"]),
             f"calibrated (render.calibrate_config): emax={cap['emax']} mcap={cap['mcap']} "
             f"mult={cap['max_instance_mult']:.4f} tiles={cap['tiles']} key={cap['sort_key']}",
             ""]
    for r in res["rows"]:
        lines.append(f"  {r['name']:28s} {r['s'] * 1e3:7.3f} ms")
    t = res["totals"]
    lines.append(f"  {'TOTAL model floor':28s} {t['measured_rate_floor_ms']:7.3f} ms  "
                 f"(sort phases at MEASURED torch.sort rates)")
    lines.append(f"  {'TOTAL radix-bytes floor':28s} {t['radix_bytes_floor_ms']:7.3f} ms  "
                 f"(sort phases at bytes x radix passes; kernels/gather unchanged)")
    lines.append(f"\n  pure-HBM single-pass bytes ~{t['pure_bytes_gb']:.2f} GB "
                 f"-> {t['pure_bytes_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e9:.0f} GB/s")
    if measured_ms:
        lines.append(
            f"  measured step: {measured_ms:.3f} ms -> "
            f"{100 * t['measured_rate_floor_ms'] / measured_ms:.0f}% of the measured-rate "
            f"model, {100 * t['radix_bytes_floor_ms'] / measured_ms:.0f}% of the radix-bytes "
            f"floor")
    return lines


def main(argv=None) -> int:
    from splatapult_tpu_torch._device import resolve_device
    from splatapult_tpu_torch.tools.scenes import SCENES, bench_camera, make_bench_scene

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=1_500_000)
    ap.add_argument("--scene", choices=SCENES, default="garden")
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="measured step ms to compare against")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    R = importlib.import_module("splatapult_tpu_torch.render")
    w, h = 1920, 1080
    scene = make_bench_scene(args.scene, args.splats, seed=0, device=dev)
    cam = bench_camera(args.scene, w, h, device=dev)
    cfg = R.calibrate_config(scene, cam, R.RenderConfig(width=w, height=h, pipeline="tiled",
                                                        forward_only=False))
    res = roofline(scene, cam, cfg)
    for line in report_lines(args.scene, res, args.measured_ms):
        print(line)
    t = res["totals"]
    out = {"tool": "roofline", "scene": args.scene, "splats": args.splats, "width": w,
           "height": h, "profile": R.profile_name(cfg), "device": str(dev),
           "geometry": res["geometry"], "capacity": res["capacity"],
           "rows": [{**r, "ms": r["s"] * 1e3, "radix_ms": r["radix_s"] * 1e3,
                     "frame_ms": r["frame_s"] * 1e3} for r in res["rows"]],
           "totals": t, "measured_ms": args.measured_ms,
           "shares": ({k: t[k] / args.measured_ms for k in (
               "measured_rate_floor_ms", "radix_bytes_floor_ms")} if args.measured_ms else None),
           "rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_flop_per_s": FP32_FLOP_PER_S,
                     "curves_card": CURVES_CARD, "curves_source": CURVES_SOURCE}}
    if dev.type == "cuda":
        from splatapult_tpu_torch.cli import gpu_name_and_power_limit

        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi_name_power_limit"] = gpu_name_and_power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
