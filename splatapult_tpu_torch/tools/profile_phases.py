"""Where one forward render, and one training step, spend their time on the GPU.

    python -m splatapult_tpu_torch.tools.profile_phases [--splats N] [--width W]
        [--height H] [--iters K] [--out FILE.json] [--profile exact|production]
        [--packed-colors on|off] [--packed-feats16] [--grad-sort-dtype D]
        [--early-stop EPS] [--fp16]

Renders the garden stand-in (default: 1.5M splats at 1920x1080, exact
profile, calibrated capacity) and prints one JSON object with, under
``render`` (forward only, as the viewer runs it):

- ``frame_ms``: median milliseconds per ``render`` call by CUDA events;
- ``phases_ms``: the same frame cut at the pipeline's public stage boundaries
  (prepare_splats, bin_splats, pack_features + row gather (the packing into
  the row layout included; the gather alone as ``row_gather``, beside
  torch's indexing of whole rows), composite_fwd and
  each of its two launches, the segment pass and the combine,
  assemble_image), each timed with CUDA events over ``--iters`` repeats;
- ``device_busy_ms``, ``idle_ms`` and ``idle_share`` per frame from
  ``torch.profiler`` (sum of device kernel time against the frame time; the
  idle milliseconds are the host's and do not shrink when a kernel does, the
  share does not compare across changes of the busy time), and ``top_kernels``: the
  device kernels by total time, with launches per frame;

and under ``train`` (one view per step, ``forward_only=False``, the target a
render of the same scene, the start a copy with seeded noise):

- ``step_ms``: median milliseconds per ``train.train_step`` by CUDA events;
- ``phases_ms``: one step cut into prepare_splats, bin_splats, pack_features +
  row gather, composite_fwd (and its two launches), assemble + loss, and the
  backward in its parts:
  assemble + loss backward (to the composite's cotangent), composite_bwd (B3),
  per_splat_sums (the tail), autograd back through pack_features and
  prepare_splats, and the Adam step; also pack_features forward + backward
  alone, beside a variant that stacks the columns instead of writing slices;
- ``chains``: what the composite kernels' design rests on — the histogram of
  blocks per tile (tiles over 8, 16, 32, 64 blocks and their share of the
  live slots); the share of (instance row, warp) pairs of the composite
  kernels (forward and backward alike) with any pixel above the alpha
  discard, for warps laid out as 32 x 1 strips and as 8 x 4 patches, and the
  share of (instance row, pixel) pairs above it, overall and in the 32
  deepest tiles; the forward's and the backward's time on all tiles beside
  their time on the tiles of at most 16 blocks (how much of a kernel's time
  the few deep chains take);
- ``device_busy_ms``, ``idle_ms``, ``idle_share``, launches per step and
  ``top_kernels`` from ``torch.profiler`` over whole steps;

and the card's name and power limit as nvidia-smi reports them.

``--profile`` picks the precision profile (render.PROFILES: exact, or the
JAX package's production profile); each knob flag then overrides one field
of it, so one knob at a time can be measured against the profile it would
join: ``--packed-colors`` (i32x8 rows), ``--packed-feats16`` (i32x4 rows),
``--grad-sort-dtype`` (the backward tail's columns), ``--early-stop`` (the
transmittance threshold), ``--fp16`` (bf16 accumulation). The result names
the knobs it ran with (``config``), the row layout's bytes per slot and the
share of blocks the early stop leaves unwalked (``train.early_stop``).

GPU only: a host timing would not be a device number.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import statistics
import sys

import torch


def _event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _profile(fn, n_prof: int, wall_ms: float) -> dict:
    """Device busy time, idle share and kernels by time over ``n_prof`` calls
    of ``fn``, against ``wall_ms`` per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            # host-side ops, and annotations projected onto the device (the
            # optimizer's "Optimizer.step#..." range), repeat their kernels'
            # device time
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / n_prof, ev.count / n_prof))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {
        "device_busy_ms": busy, "idle_ms": max(0.0, wall_ms - busy),
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_kernel_launches": sum(r[2] for r in rows),
        # the package's own kernels by their device time alone (CUDA events
        # around a wrapper also see the host's time to issue a short kernel)
        "own_kernels_device_ms": {k: ms for k, ms, _ in rows
                                  if "expand_fill_kernel" in k or "composite_" in k},
        "top_kernels": [{"name": k[:120], "ms": ms, "launches": c} for k, ms, c in rows[:20]],
    }


def _pack_features_stacked(mean2d, conic, rgb, alpha):
    """ops/tiled.pack_features written the other way, for timing only: the
    sixteen columns stacked along dim 0, one transposing copy, the null row
    appended. The shipped form writes column slices into a zeros table, which
    costs one full-table pass per slice in the backward."""
    zero = torch.zeros_like(alpha)
    cols = [mean2d[:, 0], mean2d[:, 1], conic[:, 0] * -0.5, conic[:, 1] * -1.0,
            conic[:, 2] * -0.5, torch.log(torch.clamp_min(alpha, 1e-37)),
            rgb[:, 0], rgb[:, 1], rgb[:, 2]] + [zero] * 7
    null = torch.zeros((1, 16), dtype=alpha.dtype, device=alpha.device)
    null[0, 5] = -100.0
    return torch.cat([torch.stack(cols, 0).t(), null], 0)


def _depth_histogram(nblk) -> dict:
    """How uneven the tiles' chains are: tiles deeper than 8, 16, 32 and 64
    blocks and the share of all live slots they hold."""
    total = int(nblk.sum())
    hist = {"tiles": int(nblk.numel()), "live_blocks": total,
            "mean_blocks": total / max(int(nblk.numel()), 1), "max_blocks": int(nblk.max())}
    for thr in (8, 16, 32, 64):
        deep = nblk > thr
        hist[f"over_{thr}_blocks"] = {"tiles": int(deep.sum()),
                                      "share_of_live_slots": int(nblk[deep].sum()) / max(total, 1)}
    return hist


def touched_shares(inst, start, nblk, grid) -> dict:
    """Share of (instance row, warp) pairs of the composite kernels in which
    at least one of the warp's 32 pixels passes the alpha discard, for a warp
    laid out as a 32 x 1 strip of the tile and as an 8 x 4 patch, and the
    share (and count) of (instance row, pixel) pairs that pass it: over every
    live row of every tile (rows [start, start + nblk) blocks), and within the
    32 deepest tiles. Counted with the plain weights' exponent on the rows
    decoded from the grid's layout, on the card, tile by tile."""
    import math

    from splatapult_tpu_torch.ops import composite as C

    dev = inst.device
    ts, p, block = grid.tile_size, grid.tile_pixels, grid.block
    if ts % 8 != 0 or p % 32 != 0 or grid.alpha_cutoff <= 0.0:
        raise ValueError("touched shares need a tile side that is a multiple of 8 and a discard")
    ln_cut = math.log(grid.alpha_cutoff)
    px, py = C._pixel_coords(grid, dev)
    geo = C.unpack_feats(inst, grid)[0]
    # (row, warp) pairs, of them touched as strip and as patch, touched pixels
    counts = torch.zeros((grid.num_tiles, 4), dtype=torch.int64, device=dev)
    start_h, nblk_h = start.tolist(), nblk.tolist()
    for t in range(grid.num_tiles):
        r0, r1 = start_h[t] * block, (start_h[t] + nblk_h[t]) * block
        for c0 in range(r0, r1, 4096):
            f = geo[c0:min(c0 + 4096, r1)]
            dx = px[t][None, :] - f[:, C.F_MX, None]
            dy = py[t][None, :] - f[:, C.F_MY, None]
            hit = (f[:, C.F_QA, None] * dx * dx + f[:, C.F_QB, None] * dx * dy
                   + f[:, C.F_QC, None] * dy * dy + f[:, C.F_LNA, None]) > ln_cut  # [R, P]
            strip = hit.reshape(-1, p // 32, 32).any(dim=2)
            patch = hit.reshape(-1, ts // 4, 4, ts // 8, 8).any(dim=4).any(dim=2)
            counts[t, 0] += strip.numel()
            counts[t, 1] += strip.sum()
            counts[t, 2] += patch.sum()
            counts[t, 3] += hit.sum()
    deepest = torch.argsort(nblk, descending=True)[:32]

    def shares(c):
        pairs, strip, patch, pixels = (int(x) for x in c.sum(dim=0))
        return {"pairs": pairs, "strip_32x1": strip / max(pairs, 1),
                "patch_8x4": patch / max(pairs, 1),
                "row_pixel_pairs_above_discard": pixels,
                "pixel": pixels / max(pairs * 32, 1)}

    return {"all_tiles": shares(counts), "deepest_32_tiles": shares(counts[deepest])}


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores


# multiply-adds per (slot, pixel) pair above the discard, by piece: the
# forward's ~15 (the exp counted as 4) and the backward's ~40 (the replay of
# the forward's weights and T, then the rest); and per walked slot, one test
# against its tile's rectangle. The ablation tools count each variant's
# function by changing the pieces it changes.
FWD_PAIR_MADDS = {"exponent": 6, "exp": 4, "weight": 1, "colour": 3, "transmittance": 1}
BWD_PAIR_MADDS = {"replay": 15, "cdot": 3, "eff_and_s": 2, "dw": 6, "dqh_and_t": 2,
                  "products": 9, "pixel_sums": 3}
SLOT_MADDS = 25


def bound(nbytes, flop) -> dict:
    """The larger of the bytes' time at the memory rate and the operations'
    at the fp32 rate -> {"bound_ms", "bound_by"}."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def composite_counts(inst, start, seg, grid, val_bytes: int) -> dict:
    """What composite_bounds counts on these inputs: the walked slots and
    blocks, the live segments, the (slot, pixel) pairs above the discard, and
    the bytes each function must move -> a dict of those ("fwd_bytes",
    "bwd_bytes"; "rows_bytes": the walked rows read, "out_bytes": the
    forward's output rows written, "cols_bytes": the backward's nine columns
    written)."""
    from splatapult_tpu_torch.ops import composite as C

    p = grid.tile_pixels
    walked_blocks = int(seg.walked.sum())
    needed_slots = walked_blocks * grid.block
    live_segments = int(C.segment_table(start, seg.walked, grid)[2].sum())
    touched = touched_shares(inst, start, seg.walked, grid)["all_tiles"]
    row_bytes = inst.element_size() * inst.shape[1]
    # the tiles whose rows the function must write (a band's own: the
    # others' rows are written, but nobody reads them)
    tiles_out = grid.num_tiles // grid.row_stride
    rows_bytes = row_bytes * needed_slots + 8 * tiles_out
    out_bytes = 8 * val_bytes * tiles_out * p
    cols_bytes = 4 * C.NUM_GRAD_COLS * needed_slots
    # (the forward's locals, written and read once between its two kernels,
    # are the design's traffic, not the function's); the backward reads five
    # rows each of the forward's output and its cotangent per pixel, and per
    # pixel and segment a checkpoint of four floats
    return {"walked_blocks": walked_blocks, "walked_slots": needed_slots,
            "live_segments": live_segments, "tile_pixels": p,
            "pairs_above": touched["row_pixel_pairs_above_discard"],
            "patch_8x4": touched["patch_8x4"], "rows_bytes": rows_bytes,
            "out_bytes": out_bytes, "cols_bytes": cols_bytes,
            "fwd_bytes": rows_bytes + out_bytes,
            "bwd_bytes": (rows_bytes + cols_bytes + 10 * val_bytes * tiles_out * p
                          + 16 * live_segments * p)}


def composite_bounds(inst, start, seg, grid, val_bytes: int) -> dict:
    """The least time the card could take for B2 (composite_fwd) and B3
    (composite_bwd) on these inputs -> {"walked_slots", "live_segments",
    "pairs": the (slot, pixel) pair counts, "composite_fwd" and
    "composite_bwd": {"bound_ms", "bound_by"}}. ``seg`` is the forward's
    Segments (its walked blocks), ``val_bytes`` the bytes of one value of
    its output rows.

    Each input is read once, each output written once (composite_counts);
    operations are counted on the (slot, pixel) pairs above the alpha
    discard in the blocks the walk needs (the early stop's walked blocks: a
    pair past it changes no output), counted with the plain weights'
    exponent on the decoded rows (touched_shares), plus one test of each
    such slot against its tile's rectangle (SLOT_MADDS). Per pair the
    forward does FWD_PAIR_MADDS (~15, exp included); the backward
    BWD_PAIR_MADDS: that replay and about 25 more (cdot 3, eff and S 2, dw
    with its division 6, dqh and T 2, the nine products 9, and the pixel
    sums' adds). The layout changes the bytes (4 x num_feats per slot), not
    the operations (the decode is a few integer operations per row)."""
    return bounds_of_counts(composite_counts(inst, start, seg, grid, val_bytes))


def bounds_of_counts(n: dict) -> dict:
    """composite_bounds' result from composite_counts' ``n`` (for a caller
    that needs the counts too: the count of touched pairs walks every tile)."""
    slots, pairs_above = n["walked_slots"], n["pairs_above"]
    c_flop = 2 * sum(FWD_PAIR_MADDS.values()) * pairs_above + 2 * SLOT_MADDS * slots
    b_flop = 2 * sum(BWD_PAIR_MADDS.values()) * pairs_above + 2 * SLOT_MADDS * slots
    return {"walked_slots": slots, "live_segments": n["live_segments"], "pairs": pair_shares(n),
            "composite_fwd": bound(n["fwd_bytes"], c_flop),
            "composite_bwd": bound(n["bwd_bytes"], b_flop)}


def pair_shares(n: dict) -> dict:
    """The (slot, pixel) pair counts of composite_counts' ``n``."""
    pairs = n["walked_slots"] * n["tile_pixels"]
    return {"slot_pixel_pairs": pairs, "pairs_above_discard": n["pairs_above"],
            "share_above_discard": n["pairs_above"] / max(pairs, 1),
            "row_warp_pairs_touched_as_8x4_patch": n["patch_8x4"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=1_500_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--profile", choices=("exact", "production"), default="exact")
    ap.add_argument("--packed-colors", choices=("on", "off"), default=None,
                    help="override the profile's packed_colors")
    ap.add_argument("--packed-feats16", action="store_true", help="i32x4 instance rows")
    ap.add_argument("--grad-sort-dtype", choices=("float32", "bfloat16"), default=None,
                    help="override the profile's grad_sort_dtype")
    ap.add_argument("--early-stop", type=float, default=None,
                    help="override the profile's early_stop_eps")
    ap.add_argument("--fp16", action="store_true", help="bf16 accumulation")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_phases: no CUDA device", file=sys.stderr)
        return 1

    from splatapult_tpu_torch import kernels, train
    from splatapult_tpu_torch.cli import gpu_name_and_power_limit
    from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
    from splatapult_tpu_torch.ops import binning as B, composite as C, tiled

    R = importlib.import_module("splatapult_tpu_torch.render")
    scene = make_garden_scene(args.splats, seed=0)
    cam = garden_cameras(1, width=args.width, height_px=args.height)
    cfg = R.apply_profile(R.RenderConfig(width=args.width, height=args.height,
                                         pipeline="tiled", forward_only=True), args.profile)
    knobs = {"packed_feats16": args.packed_feats16 or None,
             "packed_colors": None if args.packed_colors is None else args.packed_colors == "on",
             "grad_sort_dtype": args.grad_sort_dtype, "early_stop_eps": args.early_stop,
             "accum_dtype": "bfloat16" if args.fp16 else None}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in knobs.items() if v is not None})
    cfg = R.calibrate_config(scene, cam, cfg)
    grid = tiled._grid_from_config(cfg, scene.num_gaussians)

    # ---- the forward render, as the viewer runs it
    frame_ms = _event_ms(lambda: R.render(scene, cam, cfg), args.iters)

    # the stages of ops/tiled.composite_tiled, one at a time on kept inputs
    d = R.prepare_splats(scene, cam, cfg, sort=False)
    bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"])
    feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    inst = C.gather_rows(C.pack_src(feats, grid), bins["inst_splat"].long())
    start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
    out = C.composite_fwd(inst, start, nblk, grid)
    locs = C.composite_fwd_segments(inst, start, nblk, grid)
    table = B.expand_table(d["mean2d"], d["extent"], grid, d["depth"])
    packed = C.pack_src(feats, grid)
    splat_ids = bins["inst_splat"].long()
    if not torch.equal(C.gather_rows(packed, splat_ids), packed[splat_ids]):
        raise AssertionError("gather_rows differs from torch's row indexing")
    phases = {
        "prepare_splats": lambda: R.prepare_splats(scene, cam, cfg, sort=False),
        "bin_splats": lambda: B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"]),
        "bin_splats/expand_table": lambda: B.expand_table(
            d["mean2d"], d["extent"], grid, d["depth"]),
        "bin_splats/expand_fill": lambda: B.expand_fill(
            table["ends"], table["tile0"], table["nx"], table["dbits"], grid.emax,
            grid.tiles_x),
        "pack_features+gather": lambda: C.gather_rows(C.pack_src(tiled.pack_features(
            d["mean2d"], d["conic"], d["rgb"], d["alpha"]), grid), bins["inst_splat"].long()),
        # the gather alone (ops/composite.gather_rows: 16-byte elements of a
        # 1-D view), beside torch's indexing of whole rows
        "row_gather": lambda: C.gather_rows(packed, splat_ids),
        "row_gather/torch row indexing": lambda: packed[splat_ids],
        "composite_fwd": lambda: C.composite_fwd(inst, start, nblk, grid),
        "composite_fwd/segments": lambda: C.composite_fwd_segments(inst, start, nblk, grid),
        "composite_fwd/combine": lambda: C.combine_segments(locs, inst, start, nblk, grid),
        "assemble_image": lambda: tiled.assemble_image(out, bins["tile_ok"], grid, cfg),
    }
    phases_ms = {k: _event_ms(fn, args.iters) for k, fn in phases.items()}
    render_result = {"frame_ms": frame_ms, "phases_ms": phases_ms,
                     **_profile(lambda: R.render(scene, cam, cfg), 3, frame_ms)}

    # ---- one training step (one view)
    tcfg = dataclasses.replace(cfg, forward_only=False)
    tgrid = tiled._grid_from_config(tcfg, scene.num_gaussians)
    target = R.render(scene, cam, tcfg)
    gen = torch.Generator(device=scene.means.device).manual_seed(2)
    params = R.GaussianScene(**{
        f.name: (getattr(scene, f.name) + 0.01 * torch.randn(
            getattr(scene, f.name).shape, generator=gen, device=scene.means.device)
        ).requires_grad_(True) for f in dataclasses.fields(scene)})
    leaves = [getattr(params, f.name) for f in dataclasses.fields(params)]
    opt = train.default_optimizer(params, 1e-3)
    kernels.reset_launch_counts()
    step_ms = _event_ms(lambda: train.train_step(params, opt, cam, target, tcfg), args.iters)
    launches_per_step = {k: v / (args.iters + 1) for k, v in kernels.LAUNCH_COUNTS.items()}

    # the step's stages, each timed alone on kept inputs
    dp = R.prepare_splats(params, cam, tcfg, sort=False)
    feats_p = tiled.pack_features(dp["mean2d"], dp["conic"], dp["rgb"], dp["alpha"])
    bins_p = B.bin_splats(dp["mean2d"].detach(), dp["extent"], tgrid, dp["depth"])
    out_p = C.composite_from_feats(feats_p, bins_p, tgrid)
    loss = train.l2_image_loss(tiled.assemble_image(out_p, bins_p["tile_ok"], tgrid, tcfg),
                               target)
    dout = torch.autograd.grad(loss, out_p, retain_graph=True)[0]
    inst_p = C.gather_rows(C.pack_src(feats_p.detach(), tgrid), bins_p["inst_splat"].long())
    start_p, nblk_p = C.tile_block_ranges(bins_p["tile_count"], tgrid.block)
    seg_p = C.composite_fwd(inst_p, start_p, nblk_p, tgrid, checkpoints=True)[1]
    locs_p = C.composite_fwd_segments(inst_p, start_p, nblk_p, tgrid)
    d_inst = C.composite_bwd(inst_p, start_p, nblk_p, out_p.detach(), dout, tgrid, seg_p)
    d_feats = C.per_splat_sums(d_inst, bins_p["inst_splat"], bins_p["seg_offs"],
                               bins_p["seg_cnt"], tgrid)
    pack_in = [dp[k].detach().requires_grad_(True) for k in ("mean2d", "conic", "rgb", "alpha")]

    def loss_of(o):
        return train.l2_image_loss(tiled.assemble_image(o, bins_p["tile_ok"], tgrid, tcfg),
                                   target)

    def pack_fwd_bwd():
        torch.autograd.grad(tiled.pack_features(*pack_in), pack_in, d_feats)

    def pack_stacked_fwd_bwd():
        torch.autograd.grad(_pack_features_stacked(*pack_in), pack_in, d_feats)

    if not torch.equal(_pack_features_stacked(*pack_in), tiled.pack_features(*pack_in)):
        raise AssertionError("the stacked pack_features differs from the shipped one")

    def adam_step():
        opt.step()

    out_leaf = out_p.detach().requires_grad_(True)
    train_phases = {
        "prepare_splats (with graph)": lambda: R.prepare_splats(params, cam, tcfg, sort=False),
        "bin_splats": lambda: B.bin_splats(dp["mean2d"].detach(), dp["extent"], tgrid,
                                           dp["depth"]),
        "pack_features+gather": lambda: C.gather_rows(C.pack_src(tiled.pack_features(
            dp["mean2d"], dp["conic"], dp["rgb"], dp["alpha"]), tgrid), bins_p["inst_splat"].long()),
        "composite_fwd": lambda: C.composite_fwd(inst_p, start_p, nblk_p, tgrid,
                                                 checkpoints=True),
        "composite_fwd without checkpoints (as served)": lambda: C.composite_fwd(
            inst_p, start_p, nblk_p, tgrid),
        "composite_fwd/segments": lambda: C.composite_fwd_segments(
            inst_p, start_p, nblk_p, tgrid),
        # it writes the checkpoints over its input: at eps = 0 its work does
        # not depend on the values it reads, so repeats time the same work
        "composite_fwd/combine storing checkpoints": lambda: C.combine_segments(
            locs_p, inst_p, start_p, nblk_p, tgrid, checkpoints=True),
        "assemble+loss": lambda: loss_of(out_p.detach()),
        "backward/assemble+loss": lambda: torch.autograd.grad(loss_of(out_leaf), out_leaf),
        "backward/composite_bwd": lambda: C.composite_bwd(
            inst_p, start_p, nblk_p, out_p.detach(), dout, tgrid, seg_p),
        "backward/per_splat_sums": lambda: C.per_splat_sums(
            d_inst, bins_p["inst_splat"], bins_p["seg_offs"], bins_p["seg_cnt"], tgrid),
        "backward/pack_features+prepare_splats": lambda: torch.autograd.grad(
            feats_p, leaves, d_feats, retain_graph=True),
        "pack_features forward+backward alone": pack_fwd_bwd,
        "pack_features forward+backward alone, stacked variant": pack_stacked_fwd_bwd,
        "adam_step": adam_step,
    }
    # the chains: how uneven they are, how many (row, warp) pairs the backward
    # really has to work on, and what the deep tiles cost it
    # the blocks the early stop leaves unwalked (B2's segment pass walks them
    # all the same; the combine and B3 do not)
    early_stop = {"eps": tgrid.early_stop_eps, "blocks": int(nblk_p.sum()),
                  "blocks_walked": int(seg_p.walked.sum()),
                  "share_unwalked": 1.0 - int(seg_p.walked.sum()) / max(int(nblk_p.sum()), 1),
                  "tiles_stopped_early": int((seg_p.walked < nblk_p).sum())}
    shallow = torch.where(nblk_p <= 16, nblk_p, 0)
    out_s, seg_s = C.composite_fwd(inst_p, start_p, shallow, tgrid, checkpoints=True)
    chains = {
        "tile_nblk": _depth_histogram(nblk_p),
        # the same rows reach the forward's warps as the backward's
        "touched_row_warp_pairs": touched_shares(inst_p, start_p, nblk_p, tgrid),
        "composite_fwd_ms": {
            "all_tiles": _event_ms(train_phases["composite_fwd"], args.iters),
            "tiles_of_at_most_16_blocks": _event_ms(lambda: C.composite_fwd(
                inst_p, start_p, shallow, tgrid, checkpoints=True), args.iters),
            "all_tiles_as_served": _event_ms(
                train_phases["composite_fwd without checkpoints (as served)"], args.iters),
            "tiles_of_at_most_16_blocks_as_served": _event_ms(lambda: C.composite_fwd(
                inst_p, start_p, shallow, tgrid), args.iters)},
        "composite_bwd_ms": {
            "all_tiles": _event_ms(train_phases["backward/composite_bwd"], args.iters),
            "tiles_of_at_most_16_blocks": _event_ms(lambda: C.composite_bwd(
                inst_p, start_p, shallow, out_s, dout, tgrid, seg_s), args.iters),
            "share_of_live_slots_in_those_tiles": int(shallow.sum()) / max(int(nblk_p.sum()), 1)},
    }
    del out_s, seg_s
    train_phases_ms = {k: _event_ms(fn, args.iters) for k, fn in train_phases.items()}
    # "assemble+loss" is inside "backward/assemble+loss" (grad needs a forward)
    train_phases_ms["backward/assemble+loss"] -= train_phases_ms["assemble+loss"]
    del dp, feats_p, out_p, loss, dout, d_inst, d_feats, inst_p, out_leaf, seg_p, locs_p
    train_result = {
        "step_ms": step_ms, "views_per_step": 1, "phases_ms": train_phases_ms,
        "early_stop": early_stop,
        "kernel_launches_per_step": launches_per_step, "chains": chains,
        **_profile(lambda: train.train_step(params, opt, cam, target, tcfg), 3, step_ms)}

    result = {
        "splats": scene.num_gaussians, "width": args.width, "height": args.height,
        "profile": R.profile_name(cfg),
        "config": {k: getattr(cfg, k) for k in (
            "depth_bits", "packed_colors", "packed_feats16", "early_stop_eps",
            "grad_sort_dtype", "accum_dtype")},
        "row_bytes_per_slot": 4 * C.num_feats(grid),
        "emax": grid.emax, "mcap": grid.mcap,
        "instances": int(table["ends"][-1]),
        "render": render_result, "train": train_result,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi_name_power_limit": gpu_name_and_power_limit(),
    }
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
