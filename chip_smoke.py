#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: python3 chip_smoke.py

Needs one NVIDIA GPU (built for sm_90a: an H100), nvcc and PyTorch with CUDA;
needs no network. It

1. checks for a CUDA device (exits 1 without one, printing no result);
2. builds the CUDA kernels from splatapult_tpu_torch/kernels/csrc/;
3. holds each kernel against its plain PyTorch version on the card — the
   composite forward's two kernels (segment pass, combine) each against its
   own plain version and together against the plain serial walk — on
   mid-size cases (40k-splat garden, interleaved row ownership, capacity
   overflow, early stop; hand-made chains of 0, 1, K-1, K, K+1, 2K, 2K+1 and
   3K blocks for the K-block segments the composite kernels work by, with
   an early stop before the first segment ends, at a segment boundary, inside
   a later segment and inside the last one, and a wall on a chain's last
   block that stops nothing), in each of the three instance-row layouts
   (f32x16, packed_colors' i32x8, packed_feats16's i32x4: the garden with
   the early stop and the chains in every layout) and with bf16
   accumulation; and at the shapes the full-size renders give them, where it
   also times kernel, plain version, and the nearest single library call, and
   computes the roofline bound from that run's inputs (for the composite
   kernels: from the (slot, pixel) pairs above the alpha discard in the
   blocks this view's walk needs, counted with the plain weights), one row
   of the kernels line per layout; there it also times the backward's
   per-splat tail, in f32 and with bf16 columns, beside the scatter
   (index_add_) that it replaces;
4. renders the 1.5M-splat SH-degree-3 garden stand-in at 1920x1080
   (calibrated capacity) through splatapult_tpu_torch.render.render a few
   times with the launch counters zeroed just before, and checks that every
   forward kernel was launched once per render and the backward never: under
   the exact profile (render_full), the production profile (20-bit depth
   key, packed_colors, early stop at 1e-4, bf16 gradient tail;
   render_full_production) and the production profile with packed_feats16
   forced on (render_full_feats16);
5. trains: the same scene with seeded noise on its colours, opacities and
   positions is fitted to 1920x1080 renders of the true scene through
   splatapult_tpu_torch.train.fit_scene (a few steps with a per-step callback,
   a few in the chunked loop), launch counters zeroed just before; losses
   must be finite and fall, every parameter's gradient finite and non-zero,
   and each of the four kernels launched views x steps times: under the exact
   profile (train_full), the production profile (train_full_production) and,
   for fewer steps, with packed_feats16 forced on (train_full_feats16);
6. checks the output: finite, the expected shape, agreeing with the
   JAX-made golden images under tests/golden/ on the two small scenes, the
   GPU render agreeing with the port's CPU render (exact and production),
   the full-size production and packed_feats16 frames near the exact frame,
   and exactly zero alpha for a camera looking away;
7. drives the CLI (synth, render to PNG, render --packed-colors --fp16,
   bench --profile production, fit) in subprocesses.

Each phase prints one JSON line; any failure raises and the exit code is not 0.
The last line is {"ok": true, "device": {...}}.

Tolerances. expand_fill: bit-exact (integers). composite_fwd against its plain
version: max abs <= 1e-4, except that at most a 1e-4 fraction of values may
differ by up to 5e-3 — the 1/256 alpha discard is a hard threshold on the
exponent, and float rounding (fused multiply-adds in the kernel, cumprod
versus a running product in the plain version) can flip it for single
(instance, pixel) pairs. The packed layouts' decode is exact, so they are
held to the same tolerance. With bf16 accumulation the rows are bf16 and the
carried state is rounded to bf16 once per segment on both sides: two nearly
equal f32 states near a rounding boundary can round one bf16 step apart, so
each bound above is widened by one bf16 step of the value (2^-7 of its
magnitude at most); the combine kernel against the plain combine fed its
own locals rounds the same values and is held to the same. composite_bwd
against its plain version: each of the
nine gradient columns is scaled by the plain version's largest magnitude in
that column; on that scale max abs <= 2e-4 (the kernel sums pixels by warp
shuffles and warps in fixed order, the plain version by cumsum and matrix
products: rounding and order differ), except that at most a 1e-4 fraction of
values may differ by up to 2e-2: the same threshold flips apply, and one flip
removes a (pixel, instance) term of weight 1/256 from all nine columns of that
instance and rescales what lies behind it in that pixel. With bf16
accumulation the plain version is started from the kernel's own checkpoints
(the forward's rounded state at every segment boundary): a state the two
forwards round one bf16 step apart would otherwise move a whole segment's
gradients by 2^-8 of their size. The cotangent is
standard normal from a seeded generator, so rows 0-4 are all non-zero.
The forward's segment checkpoints (colour so far and T of every pixel at each
segment's first block) are held to the composite_fwd tolerance, against the
plain version's own checkpoints and, on the mid-size cases, against the plain
forward run on the first j segments of every tile; the walked-block counts
must be equal. The forward's two passes one at a time, to the same
tolerance: the segment kernel's locals against composite_fwd_segments_plain,
and the combine kernel's rows, checkpoints and walked-block counts against
combine_segments_plain fed the kernel's own locals. Two runs on the same
inputs must give the same bits. Goldens: atol 3e-3 (they are stored as
float16). A full-size frame under the production profile, or with
packed_feats16, against the exact frame: mean abs <= 2e-3, the mean of the
JAX package's contract for packed_feats16 against exact
(tests/test_tiled.py); the max is recorded but not held, since the 20-bit
depth key orders near-equal depths differently by design.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_SPLATS, FULL_W, FULL_H = 1_500_000, 1920, 1080
# a kernel of the kernels line -> the launch counters of its wrapper(s)
KERNEL_COUNTERS = {"expand_fill": ("expand_fill",),
                   "composite_fwd": ("composite_fwd_segments", "composite_fwd_combine"),
                   "composite_bwd": ("composite_bwd",)}
# the composite kernels' row layouts, by the RenderConfig knobs that pick them
LAYOUT_KNOBS = {"f32x16": {}, "i32x8": {"packed_colors": True}, "i32x4": {"packed_feats16": True}}
N_RENDERS = 5
TRAIN_VIEWS, TRAIN_STEPS_CALLBACK, TRAIN_STEPS_CHUNKED = 2, 4, 4
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to the value, at most


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_ms_once(fn):
    """One call, no warm-up -> (milliseconds by CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), result


def composite_close(got, want, what: str, bf16: bool = False) -> float:
    """The composite tolerance of the module docstring -> max abs error; with
    ``bf16`` each bound is widened by one bf16 step of the value."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    excess = err - BF16_STEP * want.abs() if bf16 else err
    max_excess = float(excess.max())
    frac = float((excess > 1e-4).float().mean())
    if max_excess > 5e-3 or frac > 1e-4:
        raise AssertionError(
            f"{what}: max abs err {float(err.max()):.3e} (beyond the bf16 step "
            f"{max_excess:.3e}), fraction over 1e-4 = {frac:.3e}")
    return float(err.max())


def grad_cols_close(got, want, what: str) -> float:
    """The composite_bwd tolerance of the module docstring -> max abs error
    on the per-column scale."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or non-finite values")
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    err = (got - want).abs() / scale
    max_err = float(err.max())
    frac = float((err > 2e-4).float().mean())
    if max_err > 2e-2 or frac > 1e-4:
        raise AssertionError(
            f"{what}: max scaled err {max_err:.3e}, fraction over 2e-4 = {frac:.3e}")
    return max_err


def checkpoints_close(seg, ref_seg, reached, what: str, bf16: bool = False):
    """The kernel's Segments against the plain version's: the same
    walked-block counts, and every checkpoint the forward reached (the bool
    mask ``reached`` over the segment numbers) within the composite tolerance
    -> (segments reached, max abs error)."""
    if not torch.equal(seg.walked, ref_seg.walked):
        raise AssertionError(f"{what}: segments.walked differs from the plain version's")
    n = int(reached.sum())
    if n == 0:
        return 0, 0.0
    return n, composite_close(seg.ckpt[reached], ref_seg.ckpt[reached], f"{what}: checkpoints",
                              bf16)


def seeded_cotangent(out):
    gen = torch.Generator(device=out.device).manual_seed(1)
    return torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)


def main() -> int:
    # ---- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from splatapult_tpu_torch import kernels
    from splatapult_tpu_torch.cli import gpu_name_and_power_limit
    from splatapult_tpu_torch.io.gaussians import make_debug_scene
    from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
    from splatapult_tpu_torch.kernels import _build
    from splatapult_tpu_torch.core import transforms as T
    from splatapult_tpu_torch.ops import binning as B, composite as C, tiled
    from splatapult_tpu_torch import train
    from splatapult_tpu_torch.tools.profile_phases import touched_shares

    # the package re-exports the render() function under the module's name
    R = importlib.import_module("splatapult_tpu_torch.render")

    kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_power_limit()
    if not smi:
        raise RuntimeError("nvidia-smi gave no name and power limit")
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi_name_power_limit": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build_seconds,
          "ptxas": [ln.strip() for ln in _build.last_build_log.splitlines()
                    if "Used" in ln or "spill" in ln],
          "library": os.path.relpath(lib_path, ROOT),
          "sources": [os.path.relpath(p, ROOT) for p in _build.sources()]})

    dev = torch.device("cuda")

    def kernel_inputs(scene, cam, cfg, row_stride=1, row_offset=None):
        """The tensors the kernels' wrappers receive on the render path (the
        instance rows in the config's layout)."""
        d = R.prepare_splats(scene, cam, cfg)
        grid = tiled._grid_from_config(cfg, scene.num_gaussians, row_stride)
        table = B.expand_table(d["mean2d"], d["extent"], grid, d["depth"], row_offset)
        bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"], row_offset)
        feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
        inst = C.gather_rows(C.pack_src(feats, grid), bins["inst_splat"].long())
        start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
        return grid, table, bins, inst, start, nblk

    def layout_of(grid):
        return {C.NUM_FEATS: "f32x16", C.NUM_FEATS_PACKED: "i32x8",
                C.NUM_FEATS_PACKED16: "i32x4"}[C.num_feats(grid)]

    def is_bf16(grid):
        return grid.accum_dtype == "bfloat16"

    K = C.SEGMENT_BLOCKS

    def segments_reached(start, seg, grid):
        """Mask over the segment numbers: those whose first block the forward
        walked (it wrote their checkpoints, the backward walks them)."""
        return C.segment_table(start, seg.walked, grid)[2]

    def check_fwd_passes(inst, start, nblk, grid, what):
        """The composite forward's two kernels one at a time: the segment
        kernel's locals against the plain segment pass, the combine kernel's
        rows, checkpoints and walked-block counts against the plain combine
        fed the kernel's own locals -> their max abs errors."""
        live = C.segment_table(start, nblk, grid)[2]
        locs = C.composite_fwd_segments(inst, start, nblk, grid)
        ref_locs = C.composite_fwd_segments_plain(inst, start, nblk, grid)
        torch.cuda.synchronize()
        errs = {}
        if bool(live.any()):
            errs["segments_max_abs_err"] = composite_close(
                locs[live], ref_locs[live], f"composite_fwd_segments ({what})")
        del ref_locs
        ref_out, ref_seg = C.combine_segments_plain(locs.clone(), inst, start, nblk, grid,
                                                    checkpoints=True)
        out, seg = C.combine_segments(locs, inst, start, nblk, grid, checkpoints=True)
        torch.cuda.synchronize()
        if not torch.equal(seg.walked, ref_seg.walked):
            raise AssertionError(f"combine_segments ({what}): walked differs from the plain "
                                 f"version's")
        errs["combine_max_abs_err"] = composite_close(out, ref_out, f"combine_segments ({what})",
                                                      is_bf16(grid))
        if bool(live.any()):
            errs["combine_checkpoints_max_abs_err"] = composite_close(
                seg.ckpt[live], ref_seg.ckpt[live], f"combine_segments ({what}): checkpoints",
                is_bf16(grid))
        return errs

    def same_twice(inst, start, nblk, grid, out, seg, what):
        """A second run of the forward on the same inputs gives the same bits:
        rows, walked-block counts, and the checkpoint (or local) of every
        segment of every chain."""
        live = C.segment_table(start, nblk, grid)[2]
        out2, seg2 = C.composite_fwd(inst, start, nblk, grid, checkpoints=True)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(seg.walked, seg2.walked)
                and torch.equal(seg.ckpt[live], seg2.ckpt[live])):
            raise AssertionError(f"{what} differs between two runs on the same inputs")

    def check_composite(inst, start, nblk, grid, what):
        """Both composite forward kernels, the backward kernel, and the
        checkpoints between them, against their plain versions on one
        instance buffer."""
        bf16 = is_bf16(grid)
        out, seg = C.composite_fwd(inst, start, nblk, grid, checkpoints=True)
        ref, ref_seg = C.composite_fwd_plain(inst, start, nblk, grid, checkpoints=True)
        torch.cuda.synchronize()
        if not torch.equal(out, C.composite_fwd(inst, start, nblk, grid)):
            raise AssertionError(f"composite_fwd ({what}): storing checkpoints changed the rows")
        same_twice(inst, start, nblk, grid, out, seg, f"composite_fwd ({what})")
        err = composite_close(out, ref, f"composite_fwd ({what})", bf16)
        n_seg, ck_err = checkpoints_close(seg, ref_seg, segments_reached(start, seg, grid),
                                          f"composite_fwd ({what})", bf16)
        passes = check_fwd_passes(inst, start, nblk, grid, what)
        seg0 = C.first_segments(start)
        # the first segments' checkpoints once more, against the plain forward
        # cut off after j segments of every tile
        for j in range(1, min(4, -(-int(nblk.max()) // K))):
            at = seg.walked > j * K
            if not bool(at.any()):
                break
            head = C.composite_fwd_plain(inst, start, torch.clamp_max(nblk, j * K), grid).float()
            ck_err = max(ck_err, composite_close(
                seg.ckpt[(seg0 + j)[at].long()], torch.cat([head[at, :3], head[at, 4:5]], dim=1),
                f"composite_fwd ({what}): checkpoints of segment {j}", bf16))
        dout = seeded_cotangent(out)
        d_inst = C.composite_bwd(inst, start, nblk, out, dout, grid, seg)
        d_ref = C.composite_bwd_plain(inst, start, nblk, out, dout, grid,
                                      segments=seg if bf16 else None)
        torch.cuda.synchronize()
        b_err = grad_cols_close(d_inst, d_ref, f"composite_bwd ({what})")
        return {"case": what, "layout": layout_of(grid), "rows": str(out.dtype),
                "mcap": grid.mcap, "segments_reached": n_seg,
                "deepest_tile_blocks": int(nblk.max()),
                "tiles_stopped_early": int((seg.walked < nblk).sum()),
                "composite_max_abs_err": err, "checkpoints_max_abs_err": ck_err, **passes,
                "composite_bwd_max_scaled_err": b_err}, seg.walked

    def check_pair(scene, cam, cfg, what, row_stride=1, row_offset=None):
        grid, table, bins, inst, start, nblk = kernel_inputs(
            scene, cam, cfg, row_stride, row_offset)
        args = (table["ends"], table["tile0"], table["nx"], table["dbits"],
                grid.emax, grid.tiles_x * grid.row_stride)
        got = B.expand_fill(*args)
        want = B.expand_fill_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"expand_fill != plain version ({what})")
        return {**check_composite(inst, start, nblk, grid, what)[0], "emax": grid.emax,
                "culled": int(bins["num_culled_instances"])}

    def check_chains(early_stop_eps, tile_size, block, knobs=None):
        """Hand-made chains: tiles of exactly 0, 1, K-1, K, K+1, 2K, 2K+1 and
        3K blocks of random splats near the tile's centre; in five of the
        3K-block tiles one block of flat, nearly opaque splats ends the tile
        under an early stop before its first segment ends (block 2), at a
        segment boundary (block K-1), inside the second segment (K+2) and
        inside the last one (2K+3); the fifth fills the chain's last block,
        where T falls under eps only after the chain ends: no block is
        skipped, and the combine walks that last segment again to find out.
        The rows are made in f32 and packed into the layout ``knobs`` pick."""
        knobs = knobs or {}
        depths = [0, 1, K - 1, K, K + 1, 2 * K, 2 * K + 1] + [3 * K] * 6
        walls = {8: 2, 9: K - 1, 10: K + 2, 11: 2 * K + 3, 12: 3 * K - 1}
        rows = sum(depths) * block
        grid = B.TileGrid.create(width=len(depths) * tile_size, height=tile_size, num_splats=1,
                                 tile_size=tile_size, block=block, max_instance_mult=rows,
                                 early_stop_eps=early_stop_eps, **knobs)
        rng = np.random.default_rng(3)
        # small splats (each covers about 2 % of a tile) whose opacities put an
        # optical depth of about 2 on the deepest chain: T is still well above
        # zero in a chain's last segment
        alpha = min(0.5, 2.0 / (0.023 * max(depths) * block))
        inst = np.zeros((grid.mcap, C.NUM_FEATS), np.float32)
        inst[:, C.F_LNA] = C.NULL_LN_ALPHA
        nblk = np.asarray(depths, np.int32)
        start = (np.cumsum(nblk) - nblk).astype(np.int32)
        for t, depth in enumerate(depths):
            r0, n = start[t] * block, depth * block
            centre = np.asarray([(t + 0.5) * tile_size, 0.5 * tile_size], np.float32)
            inst[r0:r0 + n, 0:2] = centre + rng.uniform(-0.6, 0.6, (n, 2)) * tile_size
            spread = rng.uniform(0.02, 0.1, (n, 2)) * tile_size  # gaussian sigma in pixels
            inst[r0:r0 + n, C.F_QA] = -0.5 / spread[:, 0] ** 2
            inst[r0:r0 + n, C.F_QC] = -0.5 / spread[:, 1] ** 2
            inst[r0:r0 + n, C.F_QB] = rng.uniform(-0.3, 0.3, n) / (spread[:, 0] * spread[:, 1])
            inst[r0:r0 + n, C.F_LNA] = np.log(rng.uniform(0.3, 1.7, n) * alpha)
            inst[r0:r0 + n, C.F_R:C.F_B + 1] = rng.uniform(0, 1, (n, 3))
            if t in walls:
                w0 = r0 + walls[t] * block
                inst[w0:w0 + block, C.F_QA:C.F_QC + 1] = [-1e-9, 0.0, -1e-9]
                inst[w0:w0 + block, C.F_LNA] = np.log(0.9)
        res, walked = check_composite(
            C.pack_src(torch.from_numpy(inst).to(dev), grid), torch.from_numpy(start).to(dev),
            torch.from_numpy(nblk).to(dev), grid,
            f"chains of {depths} blocks, tile {tile_size} block {block} eps {early_stop_eps} "
            f"{layout_of(grid)} {grid.accum_dtype}")
        # the block after a wall is the first one skipped, if there is one
        want = [min(walls[t] + 1, d) if t in walls and early_stop_eps > 0.0 else d
                for t, d in enumerate(depths)]
        if walked.tolist() != want:
            raise AssertionError(f"{res['case']}: walked {walked.tolist()}, expected {want}")
        return res

    # ---- phase 3a: kernels against their plain versions, mid-size cases
    mid = make_garden_scene(40_000, seed=0, device=dev)
    mid_cam = garden_cameras(1, width=320, height_px=192, device=dev)
    mid_cfg = R.RenderConfig(width=320, height=192, pipeline="tiled",
                             forward_only=True)
    mid_cfg = R.calibrate_config(mid, mid_cam, mid_cfg)
    cases = [check_pair(mid, mid_cam, mid_cfg, "garden 40k 320x192")]
    for off in (0, 1):
        cases.append(check_pair(mid, mid_cam, mid_cfg, f"row_stride=2 offset={off}",
                                row_stride=2, row_offset=off))
    over = check_pair(mid, mid_cam,
                      dataclasses.replace(mid_cfg, max_instance_mult=0.1),
                      "overflow (max_instance_mult=0.1)")
    if over["culled"] <= 0:
        raise AssertionError("overflow case dropped no instance")
    cases.append(over)
    cases.append(check_pair(mid, mid_cam,
                            dataclasses.replace(mid_cfg, depth_bits=20, tile_size=16,
                                                tile_block=8),
                            "depth_bits=20 tile 16 block 8"))
    # the early stop, the chains and bf16 accumulation in every row layout
    for name, knobs in LAYOUT_KNOBS.items():
        cases.append(check_pair(mid, mid_cam,
                                dataclasses.replace(mid_cfg, early_stop_eps=1e-4, **knobs),
                                f"{name} early_stop_eps=1e-4"))
        cases.append(check_pair(mid, mid_cam,
                                dataclasses.replace(mid_cfg, early_stop_eps=1e-4,
                                                    accum_dtype="bfloat16", **knobs),
                                f"{name} bf16 rows early_stop_eps=1e-4"))
        cases.append(check_chains(1e-3, tile_size=32, block=128, knobs=knobs))
        cases.append(check_chains(1e-3, tile_size=16, block=8, knobs=knobs))
    cases.append(check_chains(0.0, tile_size=32, block=128))
    cases.append(check_chains(1e-3, tile_size=32, block=128, knobs={"accum_dtype": "bfloat16"}))
    emit({"phase": "kernel_cases", "segment_blocks": K, "cases": cases})
    del mid

    # ---- phases 4 and 5 at full size: the garden view, under three configs
    t0 = time.perf_counter()
    scene = make_garden_scene(FULL_SPLATS, seed=0, device=dev)
    cam = garden_cameras(1, width=FULL_W, height_px=FULL_H, device=dev)
    base = R.RenderConfig(width=FULL_W, height=FULL_H, pipeline="tiled",
                          tile_size=32, tile_block=128, forward_only=True)
    n = scene.num_gaussians
    views = garden_cameras(TRAIN_VIEWS, width=FULL_W, height_px=FULL_H, device=dev)
    view_list = [R.Camera(cam_to_world=m, proj=q)
                 for m, q in zip(views.cam_to_world, views.proj)]
    def make_train_start():
        """The training start: the scene with seeded noise (the same in every
        training phase; made there, so the render phases' peak memory does
        not hold it)."""
        gen = torch.Generator(device=dev).manual_seed(2)

        def noisy(t, sigma):
            return t + sigma * torch.randn(t.shape, generator=gen, device=dev)

        return dataclasses.replace(scene, sh=noisy(scene.sh, 0.1),
                                   opacities=noisy(scene.opacities, 0.3),
                                   means=noisy(scene.means, 0.005))

    setup_s = time.perf_counter() - t0

    def render_phase(phase, cfg):
        """N_RENDERS renders with the counters zeroed just before -> (the
        phase's JSON, the last frame, the launch counts)."""
        for _ in range(2):  # warm-up
            R.render(scene, cam, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frame_ms = []
        kernels.reset_launch_counts()
        for _ in range(N_RENDERS):
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
            img = R.render(scene, cam, cfg)
            end_ev.record()
            torch.cuda.synchronize()
            frame_ms.append(start_ev.elapsed_time(end_ev))
        launches = dict(kernels.LAUNCH_COUNTS)
        peak_bytes = torch.cuda.max_memory_allocated()
        want_launches = {"expand_fill": N_RENDERS, "composite_fwd_segments": N_RENDERS,
                         "composite_fwd_combine": N_RENDERS, "composite_bwd": 0}
        if launches != want_launches:
            raise AssertionError(f"{phase}: kernel launches in {N_RENDERS} renders: "
                                 f"{launches}, expected {want_launches}")
        if img.shape != (FULL_H, FULL_W, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{phase}: wrong shape or non-finite values")
        alpha_max = float(img[..., 3].max())
        if alpha_max <= 0.1:
            raise AssertionError(f"{phase}: alpha.max() = {alpha_max}")
        return {"phase": phase, "splats": n, "width": FULL_W, "height": FULL_H,
                "profile": R.profile_name(cfg), "layout": layout_of(
                    tiled._grid_from_config(cfg, n)),
                "max_instance_mult": cfg.max_instance_mult,
                "ms_per_frame_median": statistics.median(frame_ms), "ms_per_frame_all": frame_ms,
                "pixels_per_s": FULL_W * FULL_H / (statistics.median(frame_ms) * 1e-3),
                "peak_memory_bytes": peak_bytes, "alpha_max": alpha_max,
                "launches": launches}, img, launches

    def frame_near_exact(img, exact_img, exact20_img, what):
        """The frame against the exact frame: the mean of the JAX package's
        packed_feats16 contract. (Its max is recorded, not held: the 20-bit
        depth key of these profiles orders splats whose depths agree to
        2.4e-4 as they come, which moves single pixels by up to the
        difference of two splats' colours; the kernels are held to their
        plain versions under the same config above.)"""
        diff = (img - exact_img).abs()
        out = {"max_abs_diff_vs_exact": float(diff.max()),
               "mean_abs_diff_vs_exact": float(diff.mean()),
               "share_over_0.05_vs_exact": float((diff > 0.05).float().mean()),
               # the same key: what is left is the row layout and the early stop
               "max_abs_diff_vs_exact_with_depth_bits_20": float(
                   (img - exact20_img).abs().max())}
        if not out["mean_abs_diff_vs_exact"] <= 2e-3:
            raise AssertionError(f"{what}: frame against the exact frame {out}")
        return out

    def composite_rows(cfg, launches_fwd, exact_tables=False):
        """B2 and B3 at the full-size view's shapes in cfg's row layout:
        against their plain versions, timed, with their bounds -> (the two
        rows of the kernels line, extras). With ``exact_tables`` also B1's
        row and the tail's timings (the layout does not touch either)."""
        grid, table, bins, inst, tstart, nblk = kernel_inputs(scene, cam, cfg)
        layout, bf16 = layout_of(grid), is_bf16(grid)
        culled = int(bins["num_culled_instances"])
        if culled != 0:
            raise AssertionError(f"{layout}: {culled} culled instances")
        live_slots = int(nblk.sum()) * grid.block
        extra, rows = {"culled": culled}, []
        if exact_tables:
            total = int(table["ends"][-1])
            e_args = (table["ends"], table["tile0"], table["nx"], table["dbits"],
                      grid.emax, grid.tiles_x)
            got = B.expand_fill(*e_args)
            want = B.expand_fill_plain(*e_args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError("expand_fill != plain version at full size")
            e_err = float((got - want).abs().max())
            del got, want
            slots = torch.arange(grid.emax, dtype=torch.int32, device=dev)
            e_ms = event_ms(lambda: B.expand_fill(*e_args), 20)
            e_plain = event_ms(lambda: B.expand_fill_plain(*e_args), 5)
            e_lib = event_ms(lambda: torch.searchsorted(table["ends"], slots, right=True), 20)
            e_bytes = 12 * grid.emax + 16 * n
            e_ops = grid.emax * (3 * math.ceil(math.log2(max(n, 2))) + 10)  # search + closed form
            e_bound_b = e_bytes / HBM_BYTES_PER_S * 1e3
            e_bound_o = e_ops / (FP32_FLOP_PER_S / 2) * 1e3  # one instruction per lane-clock
            rows.append(
                {"name": "expand_fill", "route": "cuda",
                 "source": "splatapult_tpu_torch/kernels/csrc/expand.cu",
                 "replaces": "splatapult_tpu/ops/binning.py:472",
                 "launches": None,  # filled in from render_full
                 "max_abs_err": e_err, "ms": e_ms, "plain_ms": e_plain,
                 "bound_ms": max(e_bound_b, e_bound_o),
                 "bound_by": "bytes" if e_bound_b >= e_bound_o else "operations",
                 "library_ms": e_lib, "library_call": "torch.searchsorted",
                 "shape": {"n": n, "emax": grid.emax, "filled_slots": total}})
            del slots
        out, seg = C.composite_fwd(inst, tstart, nblk, grid, checkpoints=True)
        if not torch.equal(out, C.composite_fwd(inst, tstart, nblk, grid)):
            raise AssertionError(f"composite_fwd ({layout}): storing checkpoints changed the "
                                 f"rows at full size")
        same_twice(inst, tstart, nblk, grid, out, seg, f"composite_fwd ({layout}) at full size")
        c_plain, (ref, ref_seg) = event_ms_once(
            lambda: C.composite_fwd_plain(inst, tstart, nblk, grid, checkpoints=True))
        c_err = composite_close(out, ref, f"composite_fwd ({layout}) at full size", bf16)
        live_segments, ck_err = checkpoints_close(
            seg, ref_seg, segments_reached(tstart, seg, grid),
            f"composite_fwd ({layout}) at full size", bf16)
        del ref, ref_seg
        c_pass_errs = check_fwd_passes(inst, tstart, nblk, grid, f"{layout} full size")
        dout = seeded_cotangent(out)
        d_inst = C.composite_bwd(inst, tstart, nblk, out, dout, grid, seg)
        b_plain, d_ref = event_ms_once(lambda: C.composite_bwd_plain(
            inst, tstart, nblk, out, dout, grid, segments=seg if bf16 else None))
        b_err = grad_cols_close(d_inst, d_ref, f"composite_bwd ({layout}) at full size")
        del d_ref
        if not torch.equal(d_inst, C.composite_bwd(inst, tstart, nblk, out, dout, grid, seg)):
            raise AssertionError(f"composite_bwd ({layout}) differs between two runs on the "
                                 f"same inputs")
        c_ms = event_ms(lambda: C.composite_fwd(inst, tstart, nblk, grid), 10)
        c_ckpt_ms = event_ms(lambda: C.composite_fwd(inst, tstart, nblk, grid,
                                                     checkpoints=True), 10)
        # each launch of the forward alone (the combine as served: it leaves
        # its input as it found it)
        c_locs = C.composite_fwd_segments(inst, tstart, nblk, grid)
        c_by_launch = {
            "composite_fwd_segments_kernel": event_ms(
                lambda: C.composite_fwd_segments(inst, tstart, nblk, grid), 10),
            "composite_fwd_combine_kernel": event_ms(
                lambda: C.combine_segments(c_locs, inst, tstart, nblk, grid), 10)}
        del c_locs
        b_ms = event_ms(lambda: C.composite_bwd(inst, tstart, nblk, out, dout, grid, seg), 10)
        # the row gather that feeds both kernels, in this layout
        feats = tiled.pack_features(*(torch.zeros((n, k), device=dev) for k in (2, 3, 3)),
                                    torch.full((n,), 0.5, device=dev))
        src = C.pack_src(feats, grid)
        splat_ids = bins["inst_splat"].long()
        extra["row_gather_ms"] = event_ms(lambda: C.gather_rows(src, splat_ids), 10)
        extra["row_gather_torch_row_indexing_ms"] = event_ms(lambda: src[splat_ids], 10)
        extra["pack_src_ms"] = event_ms(lambda: C.pack_src(feats, grid), 10)
        extra["inst_bytes"] = inst.numel() * inst.element_size()
        extra["rows_bytes"] = out.numel() * out.element_size()
        del feats, src
        if exact_tables:
            # the backward's tail on these columns, in f32 and with bf16
            # columns, beside the scatter it replaces (index_add_ sums with
            # atomics: faster or not, its result changes from run to run in
            # the last bits, the tail's does not)
            tail_args = (d_inst, bins["inst_splat"], bins["seg_offs"], bins["seg_cnt"])
            bf16_grid = dataclasses.replace(grid, grad_sort_dtype="bfloat16")

            def scatter(dtype=torch.float32):
                return torch.zeros((n + 1, C.NUM_GRAD_COLS), dtype=dtype,
                                   device=dev).index_add_(0, splat_ids, d_inst.t().to(dtype))

            extra["tail_ms"] = {
                "per_splat_sums": event_ms(lambda: C.per_splat_sums(*tail_args, grid), 10),
                "per_splat_sums_bf16_columns": event_ms(
                    lambda: C.per_splat_sums(*tail_args, bf16_grid), 10),
                "index_add_": event_ms(scatter, 10)}
            d_feats = C.per_splat_sums(*tail_args, grid)
            if not torch.equal(d_feats, C.per_splat_sums(*tail_args, grid)):
                raise AssertionError("per_splat_sums differs between two runs on the same "
                                     "inputs")
            exact = scatter(torch.float64)
            col_scale = exact.abs().amax(dim=0).clamp_min(1e-30)

            def scaled_err(x):
                return float(((x[:, :C.NUM_GRAD_COLS].double() - exact).abs()
                              / col_scale).max())

            extra["tail_max_scaled_err_vs_float64"] = {
                "per_splat_sums": scaled_err(d_feats),
                "per_splat_sums_bf16_columns": scaled_err(
                    C.per_splat_sums(*tail_args, bf16_grid)),
                "index_add_": scaled_err(scatter())}
            # float32 prefix sums over 2.6M slots: the rounding is relative to
            # the running total, so it is stated on the per-column scale; bf16
            # columns round every instance value by up to 2^-9 of itself
            if not extra["tail_max_scaled_err_vs_float64"]["per_splat_sums"] <= 1e-4:
                raise AssertionError(f"per_splat_sums: {extra}")
            if not extra["tail_max_scaled_err_vs_float64"]["per_splat_sums_bf16_columns"] <= 4e-3:
                raise AssertionError(f"per_splat_sums with bf16 columns: {extra}")
            del exact, d_feats

        # Bounds from this run's inputs: each input read once, each output
        # written once; operations counted on the (slot, pixel) pairs above
        # the alpha discard in the blocks the walk needs (the early stop's
        # walked blocks: a pair past it changes no output), counted with the
        # plain weights' exponent on the decoded rows, plus one test of each
        # such slot against its tile's rectangle (~25 multiply-adds). Per pair
        # the forward does ~15 multiply-adds, exp included; the backward that
        # replay and about 25 more: cdot 3, eff and S 2, dw with its division
        # 6, dqh and T 2, the nine products 9, and the pixel sums' adds. The
        # layout changes the bytes (4 x num_feats per slot), not the
        # operations (the decode is a few integer operations per row).
        p = grid.tile_pixels
        walked = seg.walked
        needed_slots = int(walked.sum()) * grid.block
        touched = touched_shares(inst, tstart, walked, grid)["all_tiles"]
        pairs_above = touched["row_pixel_pairs_above_discard"]
        pairs_shape = {"slot_pixel_pairs": needed_slots * p, "pairs_above_discard": pairs_above,
                       "share_above_discard": pairs_above / max(needed_slots * p, 1),
                       "row_warp_pairs_touched_as_8x4_patch": touched["patch_8x4"]}
        row_bytes, val_bytes = inst.element_size() * inst.shape[1], out.element_size()
        # (the forward's locals, written and read once between its two
        # kernels, are the design's traffic, not the function's)
        c_bytes = row_bytes * needed_slots + 8 * val_bytes * grid.num_tiles * p + 8 * grid.num_tiles
        c_flop = 2 * 15 * pairs_above + 2 * 25 * needed_slots
        c_bound_b = c_bytes / HBM_BYTES_PER_S * 1e3
        c_bound_o = c_flop / FP32_FLOP_PER_S * 1e3
        # backward bytes: per slot a row read and nine floats written, per
        # pixel five rows each of the forward's output and its cotangent
        # read, per pixel and segment a checkpoint of four floats
        b_bytes = ((row_bytes + 4 * C.NUM_GRAD_COLS) * needed_slots
                   + 10 * val_bytes * grid.num_tiles * p + 16 * live_segments * p
                   + 8 * grid.num_tiles)
        b_flop = 2 * 40 * pairs_above + 2 * 25 * needed_slots
        b_bound_b = b_bytes / HBM_BYTES_PER_S * 1e3
        b_bound_o = b_flop / FP32_FLOP_PER_S * 1e3
        shape = {"layout": layout, "row_bytes": row_bytes, "rows_dtype": str(out.dtype),
                 "early_stop_eps": grid.early_stop_eps, "mcap": grid.mcap,
                 "live_slots": live_slots, "walked_slots": needed_slots,
                 "tiles_stopped_early": int((walked < nblk).sum()),
                 "tiles": grid.num_tiles, "tile_pixels": p,
                 "max_blocks_in_a_tile": int(nblk.max()), **pairs_shape, "segment_blocks": K,
                 "segment_ctas_launched": C.num_segments_cap(grid)}
        suffix = "" if layout == "f32x16" else f"[{layout}]"
        rows.append(
            {"name": "composite_fwd" + suffix, "route": "cuda",
             "source": "splatapult_tpu_torch/kernels/csrc/composite_fwd.cu",
             "replaces": "splatapult_tpu/ops/composite.py:532",
             "launches": launches_fwd, "max_abs_err": c_err,
             "ms": c_ms, "ms_by_launch": c_by_launch, "ms_storing_checkpoints": c_ckpt_ms,
             "checkpoints_max_abs_err": ck_err, **c_pass_errs, "plain_ms": c_plain,
             "bound_ms": max(c_bound_b, c_bound_o),
             "bound_by": "bytes" if c_bound_b >= c_bound_o else "operations",
             "library_ms": None,
             "shape": {**shape, "segments": int(C.segment_table(tstart, nblk, grid)[2].sum()),
                       "segment_scratch_bytes": 16 * C.num_segments_cap(grid) * p}})
        rows.append(
            {"name": "composite_bwd" + suffix, "route": "cuda",
             "source": "splatapult_tpu_torch/kernels/csrc/composite_bwd.cu",
             "replaces": "splatapult_tpu/ops/composite.py:581",
             "launches": None,  # filled in from this layout's training phase
             "max_abs_err": b_err, "max_abs_err_scale": "each column over its largest magnitude",
             "ms": b_ms, "plain_ms": b_plain,
             "bound_ms": max(b_bound_b, b_bound_o),
             "bound_by": "bytes" if b_bound_b >= b_bound_o else "operations",
             "library_ms": None,
             "shape": {**shape, "segments": live_segments}})
        return rows, extra

    def train_phase(phase, cfg, steps_callback, steps_chunked):
        """fit_scene at full size from train_start towards renders of the
        true scene, counters zeroed just before -> (the phase's JSON, the
        launch counts)."""
        train_start = make_train_start()
        train_cfg = R.calibrate_config(train_start, views,
                                       dataclasses.replace(cfg, forward_only=False))
        targets = torch.stack([R.render(scene, v, train_cfg) for v in view_list])

        def culled_instances(sc):
            with torch.no_grad():
                return sum(int(tiled.composite_tiled(
                    R.prepare_splats(sc, v, train_cfg), train_cfg,
                    return_aux=True)[1]["num_culled_instances"]) for v in view_list)

        train_culled = culled_instances(train_start)
        step_events = [torch.cuda.Event(enable_timing=True)]
        first_grads = {}

        def on_step(step, params, loss):
            step_events.append(torch.cuda.Event(enable_timing=True))
            step_events[-1].record()
            if step == 0:
                for f in dataclasses.fields(params):
                    g = getattr(params, f.name).grad
                    first_grads[f.name] = {"finite": bool(torch.isfinite(g).all()),
                                           "abs_max": float(g.abs().max())}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        step_events[0].record()
        fitted, losses_cb = train.fit_scene(train_start, views, targets, train_cfg,
                                            steps=steps_callback, callback=on_step)
        chunk_ms, (fitted, losses_chunk) = event_ms_once(
            lambda: train.fit_scene(fitted, views, targets, train_cfg, steps=steps_chunked))
        train_launches = dict(kernels.LAUNCH_COUNTS)
        train_peak = torch.cuda.max_memory_allocated()
        step_ms = [a.elapsed_time(b) for a, b in zip(step_events[:-1], step_events[1:])]
        n_launch = TRAIN_VIEWS * (steps_callback + steps_chunked)
        if any(c != n_launch for c in train_launches.values()):
            raise AssertionError(f"{phase}: kernel launches {train_launches}, expected "
                                 f"{n_launch} each (views x steps)")
        for losses in (losses_cb, losses_chunk):
            if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
                raise AssertionError(f"{phase}: losses not finite or not falling: {losses}")
        for name, st in first_grads.items():
            if not st["finite"] or not st["abs_max"] > 0.0:
                raise AssertionError(f"{phase}: gradient of {name} after the first step: {st}")
        if len(first_grads) != 5:
            raise AssertionError(f"{phase}: gradients seen for {sorted(first_grads)}")
        train_culled += culled_instances(fitted)
        if train_culled != 0:
            raise AssertionError(f"{phase}: {train_culled} culled instances")
        return {"phase": phase, "splats": n, "views": TRAIN_VIEWS, "width": FULL_W,
                "height": FULL_H, "profile": R.profile_name(train_cfg),
                "layout": layout_of(tiled._grid_from_config(train_cfg, n)),
                "max_instance_mult": train_cfg.max_instance_mult,
                "losses_callback_loop": losses_cb, "losses_chunked_loop": losses_chunk,
                "ms_per_step_median": statistics.median(step_ms), "ms_per_step_all": step_ms,
                "ms_per_step_chunked_loop": chunk_ms / steps_chunked,
                "first_step_grads": first_grads, "launches": train_launches,
                "peak_memory_bytes": train_peak, "num_culled_instances": train_culled,
                "device": kind, "nvidia_smi_name_power_limit": smi}, train_launches

    def fwd_launches(launches):
        return sum(launches[c] for c in KERNEL_COUNTERS["composite_fwd"])

    # exact profile: f32x16 rows
    cfg = R.calibrate_config(scene, cam, R.apply_profile(base, "exact"))
    setup_s += time.perf_counter() - t0
    render_json, exact_img, launches = render_phase("render_full", cfg)
    kernel_rows, extra = composite_rows(cfg, fwd_launches(launches), exact_tables=True)
    kernel_rows[0]["launches"] = launches["expand_fill"]
    emit({**render_json, "emax": tiled._grid_from_config(cfg, n).emax,
          "mcap": tiled._grid_from_config(cfg, n).mcap,
          "kernel_ms": {r["name"]: r["ms"] for r in kernel_rows}, **extra,
          "scene_and_calibration_seconds": setup_s,
          "device": kind, "nvidia_smi_name_power_limit": smi})
    train_json, train_launches = train_phase("train_full", cfg, TRAIN_STEPS_CALLBACK,
                                             TRAIN_STEPS_CHUNKED)
    kernel_rows[2]["launches"] = train_launches["composite_bwd"]
    for row in kernel_rows:
        row["launches_by_path"] = {
            path: sum(counts[c] for c in KERNEL_COUNTERS[row["name"]])
            for path, counts in (("render_full", launches), ("train_full", train_launches))}
    emit(train_json)

    # the production profile (i32x8 rows), then with packed_feats16 forced on
    # (i32x4 rows): a render phase, the kernels at its shapes, a training phase
    prod = R.calibrate_config(scene, cam, R.apply_profile(base, "production"))
    exact20_img = R.render(scene, cam, dataclasses.replace(cfg, depth_bits=20))
    for layout, cfg_l, suffix, steps in (
            ("i32x8", prod, "production", (TRAIN_STEPS_CALLBACK, TRAIN_STEPS_CHUNKED)),
            ("i32x4", R.calibrate_config(scene, cam, dataclasses.replace(
                prod, packed_feats16=True)), "feats16", (2, 2))):
        render_json, img, launches = render_phase(f"render_full_{suffix}", cfg_l)
        rows, extra = composite_rows(cfg_l, fwd_launches(launches))
        emit({**render_json, **frame_near_exact(img, exact_img, exact20_img,
                                                render_json["phase"]),
              "kernel_ms": {r["name"]: r["ms"] for r in rows}, **extra,
              "device": kind, "nvidia_smi_name_power_limit": smi})
        del img
        train_json, train_launches = train_phase(f"train_full_{suffix}", cfg_l, *steps)
        emit(train_json)
        rows[1]["launches"] = train_launches["composite_bwd"]
        for row, counter in zip(rows, ("composite_fwd", "composite_bwd")):
            row["launches_by_path"] = {
                path: sum(counts[c] for c in KERNEL_COUNTERS[counter])
                for path, counts in ((render_json["phase"], launches),
                                     (train_json["phase"], train_launches))}
        kernel_rows += rows
    del exact_img, exact20_img

    # ---- phase 6: output checks on small inputs
    away = R.Camera.from_fov(
        # outside the scene's 25 m background shell, facing outward
        T.look_at(eye=[100.0, 1.6, 0.0], target=[200.0, 1.6, 0.0], up=[0, 1, 0]),
        fovy=np.pi / 4, width=FULL_W, height=FULL_H, device=dev)
    img_away = R.render(scene, away, cfg)
    torch.cuda.synchronize()
    if float(img_away[..., 3].abs().max()) != 0.0:
        raise AssertionError("render_away: alpha is not exactly 0")
    del scene, img_away

    def golden(name):
        return np.load(os.path.join(ROOT, "tests", "golden", name + ".npy")).astype(np.float32)

    dbg_cfg = R.RenderConfig(width=128, height=128, pipeline="tiled", tile_size=16,
                             tile_block=8, max_instance_mult=24)
    dbg_cam = R.Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=128, height=128, device=dev)
    dbg = R.render(make_debug_scene(device=dev), dbg_cam, dbg_cfg).cpu().numpy()
    mid = make_garden_scene(40_000, seed=0, device=dev)
    g40_cfg = R.RenderConfig(width=320, height=192, pipeline="tiled", tile_size=16,
                             tile_block=8, max_instance_mult=8)
    g40 = R.render(mid, mid_cam, g40_cfg)
    g40_cpu = R.render(mid.to("cpu"), mid_cam.to("cpu"), g40_cfg)
    gold_err = {}
    for name, got_img in (("debug_tiled", dbg), ("garden_40k_tiled", g40.cpu().numpy())):
        err = float(np.abs(got_img - golden(name)).max())
        if not err <= 3e-3:
            raise AssertionError(f"golden {name}: max abs err {err}")
        gold_err[name] = err
    cpu_err = {"exact": composite_close(g40.cpu(), g40_cpu,
                                        "GPU render vs CPU render (garden 40k)")}
    for name, cfg_s in (("production", R.apply_profile(g40_cfg, "production")),
                        ("production_bf16_rows", dataclasses.replace(
                            R.apply_profile(g40_cfg, "production"), accum_dtype="bfloat16"))):
        cpu_err[name] = composite_close(
            R.render(mid, mid_cam, cfg_s).cpu(), R.render(mid.to("cpu"), mid_cam.to("cpu"), cfg_s),
            f"GPU render vs CPU render (garden 40k, {name})", cfg_s.accum_dtype == "bfloat16")
    emit({"phase": "output_checks", "render_away_alpha_max": 0.0,
          "golden_max_abs_err": gold_err, "gpu_vs_cpu_render_max_abs_err": cpu_err})

    # ---- phase 7: the CLI in subprocesses
    from splatapult_tpu_torch.cli import _orbit_rig
    from splatapult_tpu_torch.io.gaussians import load_gaussian_ply, save_gaussian_ply
    from splatapult_tpu_torch.utils.image import load_png

    with tempfile.TemporaryDirectory() as tmp:
        ply, png = os.path.join(tmp, "garden.ply"), os.path.join(tmp, "garden.png")
        cli = [sys.executable, "-m", "splatapult_tpu_torch.cli"]
        size = ["--width", "640", "--height", "384"]

        def run_cli(args):
            return subprocess.run(cli + args, cwd=ROOT, check=True, timeout=600,
                                  stdout=subprocess.PIPE, text=True).stdout

        run_cli(["synth", "garden", "--splats", "20000", "-o", ply])
        run_cli(["render", ply, "-o", png, *size,
                 "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0"])
        png_bytes = os.path.getsize(png)
        if png_bytes <= 0:
            raise AssertionError("cli render wrote an empty PNG")
        if load_png(png).shape != (384, 640, 3):
            raise AssertionError("cli render wrote a PNG of the wrong size")
        packed_png = os.path.join(tmp, "packed.png")
        run_cli(["render", ply, "-o", packed_png, *size, "--packed-colors", "--fp16",
                 "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0"])
        packed_diff = float(np.abs(load_png(packed_png) - load_png(png)).max())
        if not packed_diff <= 0.05:
            raise AssertionError(f"cli render --packed-colors --fp16: {packed_diff} from the "
                                 f"exact PNG")
        bench_line = json.loads(run_cli(
            ["bench", ply, *size, "--profile", "production", "--iters", "3",
             "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0"]).strip().splitlines()[-1])
        if bench_line["profile"] != "production" or not bench_line["ms_per_frame"] > 0.0:
            raise AssertionError(f"cli bench --profile production: {bench_line}")
        # fit: two orbit views of the true scene rendered to PNG with `render`,
        # then a copy with dimmed colours fitted back for a few steps
        small = load_gaussian_ply(ply, device="cpu")
        rig = _orbit_rig(small, 2, 640, 384, fovy=np.deg2rad(45.0), device="cpu")
        center = [repr(float(x)) for x in small.means.numpy().mean(0)]
        for i in range(2):
            eye = [repr(float(x)) for x in rig.cam_to_world[i, :3, 3]]
            run_cli(["render", ply, "-o", os.path.join(tmp, f"target{i}.png"), *size,
                     "--eye", *eye, "--target", *center])
        dim_ply, fitted_ply = os.path.join(tmp, "dim.ply"), os.path.join(tmp, "fitted.ply")
        save_gaussian_ply(dim_ply, dataclasses.replace(small, sh=small.sh * 0.8))
        fit_line = json.loads(run_cli(
            ["fit", dim_ply, "--targets", os.path.join(tmp, "target*.png"), "-o", fitted_ply,
             "--steps", "5"]).strip().splitlines()[-1])
        if (fit_line["steps"], fit_line["views"], fit_line["splats"]) != (5, 2, 20000):
            raise AssertionError(f"cli fit: {fit_line}")
        if not (math.isfinite(fit_line["loss_last"])
                and fit_line["loss_last"] < fit_line["loss_first"]):
            raise AssertionError(f"cli fit: loss did not fall: {fit_line}")
        if load_gaussian_ply(fitted_ply, device="cpu").num_gaussians != 20000:
            raise AssertionError("cli fit wrote a .ply of the wrong size")
    emit({"phase": "cli", "png_bytes": png_bytes, "packed_fp16_png_max_abs_diff": packed_diff,
          "bench_production_ms_per_frame": bench_line["ms_per_frame"],
          "fit": {k: fit_line[k] for k in ("steps", "views", "loss_first", "loss_last",
                                           "seconds")}})

    emit({"kernels": kernel_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
