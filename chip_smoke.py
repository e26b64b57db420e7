#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port: python3 chip_smoke.py

Needs one NVIDIA GPU (built for sm_90a: an H100), nvcc and PyTorch with CUDA;
needs no network. It

1. checks for a CUDA device (exits 1 without one, printing no result);
2. builds the CUDA kernels from splatapult_tpu_torch/kernels/csrc/;
3. holds each kernel against its plain PyTorch version on the card — on
   mid-size cases (40k-splat garden, interleaved row ownership, capacity
   overflow, early stop) and at the shapes the full-size render gives it,
   where it also times kernel, plain version, and the nearest single library
   call, and computes the roofline bound from that run's inputs;
4. renders the 1.5M-splat SH-degree-3 garden stand-in at 1920x1080 (exact
   profile, calibrated capacity) through splatapult_tpu_torch.render.render a
   few times with the launch counters zeroed just before, and checks that
   every kernel was launched once per render;
5. checks the output: finite, the expected shape, agreeing with the
   JAX-made golden images under tests/golden/ on the two small scenes, the
   GPU render agreeing with the port's CPU render, and exactly zero alpha for
   a camera looking away;
6. drives the CLI (synth + render to PNG) in a subprocess.

Each phase prints one JSON line; any failure raises and the exit code is not 0.
The last line is {"ok": true, "device": {...}}.

Tolerances. expand_fill: bit-exact (integers). composite_fwd against its plain
version: max abs <= 1e-4, except that at most a 1e-4 fraction of values may
differ by up to 5e-3 — the 1/256 alpha discard is a hard threshold on the
exponent, and float rounding (fused multiply-adds in the kernel, cumprod
versus a running product in the plain version) can flip it for single
(instance, pixel) pairs. Goldens: atol 3e-3 (they are stored as float16).
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
N_RENDERS = 5


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


def composite_close(got, want, what: str) -> float:
    """The composite tolerance of the module docstring -> max abs error."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    max_err = float(err.max())
    frac = float((err > 1e-4).float().mean())
    if max_err > 5e-3 or frac > 1e-4:
        raise AssertionError(
            f"{what}: max abs err {max_err:.3e}, fraction over 1e-4 = {frac:.3e}")
    return max_err


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
        """The tensors the two wrappers receive on the render path."""
        d = R.prepare_splats(scene, cam, cfg)
        grid = tiled._grid_from_config(cfg, scene.num_gaussians, row_stride)
        table = B.expand_table(d["mean2d"], d["extent"], grid, d["depth"], row_offset)
        bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"], row_offset)
        feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
        inst = feats[bins["inst_splat"].long()]
        start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
        return grid, table, bins, inst, start, nblk

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
        out = C.composite_fwd(inst, start, nblk, grid)
        ref = C.composite_fwd_plain(inst, start, nblk, grid)
        torch.cuda.synchronize()
        err = composite_close(out, ref, f"composite_fwd ({what})")
        return {"case": what, "emax": grid.emax, "mcap": grid.mcap,
                "culled": int(bins["num_culled_instances"]),
                "composite_max_abs_err": err}

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
                            dataclasses.replace(mid_cfg, early_stop_eps=1e-4),
                            "early_stop_eps=1e-4"))
    cases.append(check_pair(mid, mid_cam,
                            dataclasses.replace(mid_cfg, depth_bits=20, tile_size=16,
                                                tile_block=8),
                            "depth_bits=20 tile 16 block 8"))
    emit({"phase": "kernel_cases", "cases": cases})

    # ---- phase 3b + 4: the full-size render and the kernels at its shapes
    t0 = time.perf_counter()
    scene = make_garden_scene(FULL_SPLATS, seed=0, device=dev)
    cam = garden_cameras(1, width=FULL_W, height_px=FULL_H, device=dev)
    cfg = R.apply_profile(
        R.RenderConfig(width=FULL_W, height=FULL_H, pipeline="tiled",
                       tile_size=32, tile_block=128, forward_only=True), "exact")
    cfg = R.calibrate_config(scene, cam, cfg)
    setup_s = time.perf_counter() - t0

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
    for name, count in launches.items():
        if count != N_RENDERS:
            raise AssertionError(
                f"kernel {name} launched {count} times in {N_RENDERS} renders")
    if img.shape != (FULL_H, FULL_W, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render_full: wrong shape or non-finite values")
    alpha_max = float(img[..., 3].max())
    if alpha_max <= 0.1:
        raise AssertionError(f"render_full: alpha.max() = {alpha_max}")

    grid, table, bins, inst, tstart, nblk = kernel_inputs(scene, cam, cfg)
    culled = int(bins["num_culled_instances"])
    if culled != 0:
        raise AssertionError(f"render_full: {culled} culled instances")
    n = scene.num_gaussians
    total = int(table["ends"][-1])
    live_slots = int(nblk.sum()) * grid.block
    e_args = (table["ends"], table["tile0"], table["nx"], table["dbits"],
              grid.emax, grid.tiles_x)
    got = B.expand_fill(*e_args)
    want = B.expand_fill_plain(*e_args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("expand_fill != plain version at full size")
    e_err = float((got - want).abs().max())
    out = C.composite_fwd(inst, tstart, nblk, grid)
    ref = C.composite_fwd_plain(inst, tstart, nblk, grid)
    torch.cuda.synchronize()
    c_err = composite_close(out, ref, "composite_fwd at full size")
    del ref

    slots = torch.arange(grid.emax, dtype=torch.int32, device=dev)
    e_ms = event_ms(lambda: B.expand_fill(*e_args), 20)
    e_plain = event_ms(lambda: B.expand_fill_plain(*e_args), 5)
    e_lib = event_ms(lambda: torch.searchsorted(table["ends"], slots, right=True), 20)
    c_ms = event_ms(lambda: C.composite_fwd(inst, tstart, nblk, grid), 10)
    c_plain = event_ms(lambda: C.composite_fwd_plain(inst, tstart, nblk, grid), 1, warmup=0)

    # bounds from this run's inputs: each input read once, each output written
    # once; operations counted on the slots this view really fills
    e_bytes = 12 * grid.emax + 16 * n
    e_ops = grid.emax * (3 * math.ceil(math.log2(max(n, 2))) + 10)  # compare/step + closed form
    e_bound_b = e_bytes / HBM_BYTES_PER_S * 1e3
    e_bound_o = e_ops / (FP32_FLOP_PER_S / 2) * 1e3  # one instruction per lane-clock
    p = grid.tile_pixels
    c_bytes = 64 * live_slots + 32 * grid.num_tiles * p + 8 * grid.num_tiles
    c_flop = 2 * 15 * live_slots * p  # ~15 multiply-adds per (slot, pixel), exp included
    c_bound_b = c_bytes / HBM_BYTES_PER_S * 1e3
    c_bound_o = c_flop / FP32_FLOP_PER_S * 1e3
    kernel_rows = [
        {"name": "expand_fill", "route": "cuda",
         "source": "splatapult_tpu_torch/kernels/csrc/expand.cu",
         "replaces": "splatapult_tpu/ops/binning.py:472",
         "launches": launches["expand_fill"], "max_abs_err": e_err,
         "ms": e_ms, "plain_ms": e_plain,
         "bound_ms": max(e_bound_b, e_bound_o),
         "bound_by": "bytes" if e_bound_b >= e_bound_o else "operations",
         "library_ms": e_lib, "library_call": "torch.searchsorted",
         "shape": {"n": n, "emax": grid.emax, "filled_slots": total}},
        {"name": "composite_fwd", "route": "cuda",
         "source": "splatapult_tpu_torch/kernels/csrc/composite_fwd.cu",
         "replaces": "splatapult_tpu/ops/composite.py:532",
         "launches": launches["composite_fwd"], "max_abs_err": c_err,
         "ms": c_ms, "plain_ms": c_plain,
         "bound_ms": max(c_bound_b, c_bound_o),
         "bound_by": "bytes" if c_bound_b >= c_bound_o else "operations",
         "library_ms": None,
         "shape": {"mcap": grid.mcap, "live_slots": live_slots,
                   "tiles": grid.num_tiles, "tile_pixels": p,
                   "max_blocks_in_a_tile": int(nblk.max())}},
    ]

    emit({"phase": "render_full", "splats": n, "width": FULL_W, "height": FULL_H,
          "profile": R.profile_name(cfg), "max_instance_mult": cfg.max_instance_mult,
          "emax": grid.emax, "mcap": grid.mcap, "instances": total,
          "ms_per_frame_median": statistics.median(frame_ms), "ms_per_frame_all": frame_ms,
          "pixels_per_s": FULL_W * FULL_H / (statistics.median(frame_ms) * 1e-3),
          "kernel_ms": {"expand_fill": e_ms, "composite_fwd": c_ms},
          "peak_memory_bytes": peak_bytes, "alpha_max": alpha_max,
          "num_culled_instances": culled, "launches": launches,
          "scene_and_calibration_seconds": setup_s,
          "device": kind, "nvidia_smi_name_power_limit": smi})

    # ---- phase 5: output checks on small inputs
    away = R.Camera.from_fov(
        # outside the scene's 25 m background shell, facing outward
        T.look_at(eye=[100.0, 1.6, 0.0], target=[200.0, 1.6, 0.0], up=[0, 1, 0]),
        fovy=np.pi / 4, width=FULL_W, height=FULL_H, device=dev)
    img_away = R.render(scene, away, cfg)
    torch.cuda.synchronize()
    if float(img_away[..., 3].abs().max()) != 0.0:
        raise AssertionError("render_away: alpha is not exactly 0")
    del scene, inst, out, img_away

    def golden(name):
        return np.load(os.path.join(ROOT, "tests", "golden", name + ".npy")).astype(np.float32)

    dbg_cfg = R.RenderConfig(width=128, height=128, pipeline="tiled", tile_size=16,
                             tile_block=8, max_instance_mult=24)
    dbg_cam = R.Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=128, height=128, device=dev)
    dbg = R.render(make_debug_scene(device=dev), dbg_cam, dbg_cfg).cpu().numpy()
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
    cpu_err = composite_close(g40.cpu(), g40_cpu, "GPU render vs CPU render (garden 40k)")
    emit({"phase": "output_checks", "render_away_alpha_max": 0.0,
          "golden_max_abs_err": gold_err, "gpu_vs_cpu_render_max_abs_err": cpu_err})

    # ---- phase 6: the CLI in a subprocess
    with tempfile.TemporaryDirectory() as tmp:
        ply, png = os.path.join(tmp, "garden.ply"), os.path.join(tmp, "garden.png")
        cli = [sys.executable, "-m", "splatapult_tpu_torch.cli"]
        for cmd in (
            cli + ["synth", "garden", "--splats", "20000", "-o", ply],
            cli + ["render", ply, "-o", png, "--width", "640", "--height", "384",
                   "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0"],
        ):
            subprocess.run(cmd, cwd=ROOT, check=True, timeout=600,
                           stdout=subprocess.DEVNULL)
        png_bytes = os.path.getsize(png)
        if png_bytes <= 0:
            raise AssertionError("cli render wrote an empty PNG")
        from splatapult_tpu_torch.utils.image import load_png
        if load_png(png).shape != (384, 640, 3):
            raise AssertionError("cli render wrote a PNG of the wrong size")
    emit({"phase": "cli", "png_bytes": png_bytes})

    emit({"kernels": kernel_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
