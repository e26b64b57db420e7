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
   and with adaptive density (train_adaptive, exact profile): from every
   other splat of the perturbed start (750,000) through
   densify.fit_scene_adaptive, 12 steps with an event every 4, the default
   DensifyConfig; every event must clone or split and grow the scene, no
   chunk may drop an instance (the capacity is calibrated again after each
   event), the loss must fall, the gradients of the first step after each
   event be finite, each kernel launched views x steps times; then B1, B2
   (both launches) and B3 against their plain versions and timed at the
   grown shape; and a train state checkpointed and resumed (fit_resume,
   production profile, at the fit demo's 200,000-splat garden and the two
   training views at 1920x1080): train.train_step with
   train.default_optimizer for 4 steps, io/checkpoint.save_train_state, 4
   steps live, then load_train_state into fresh leaves and a fresh optimizer
   (load_state_dict) and the same 4 steps again: the resumed losses and
   parameters equal to the live ones bit for bit; the checkpoint's size and
   the seconds to write and read it; then B1, B2 and B3 against their plain
   versions and timed at this phase's shape (the resumed scene, one view);
6. renders the same scene through the rest of the viewer, counters zeroed
   just before each: supersample 2 at 1920x1080 (3840x2160 inside,
   calibrated at that size; render_supersample), the 8-view orbit path
   through render_batch (render_path) and an asymmetric stereo pair through
   render_batch, differentiated once (render_stereo); each view equal to
   render() of its camera alone bit for bit, the supersampled frame to the
   3840x2160 frame box-filtered down, and B1 and both composite forward
   launches held against their plain versions on the 3840x2160 grid; then
   shared binning against per-view rendering of the same views: the view's
   symmetric stereo pair (ipd 0.064) binned once through
   stereo.render_stereo against render_batch of the two eyes
   (render_stereo_shared: forward and forward + backward of mean(img ** 2)
   timed, the production profile's forward too, capacities, peak memory,
   what the per-eye capacity drops on the union; each eye, in both
   profiles, equal to render() of it within the composite tolerance), and
   four path views 0.02 rad apart on the garden orbit through
   cluster.render_path_clustered in clusters of 2 and of 4 against
   render_batch (render_cluster: timed the same way; each view's difference
   from its per-view frame printed, the reference views held to the
   composite tolerance; the "auto" gate's decision); at the stereo union
   (exact and production rows), the k=2 and the k=4 union B1 bit for bit
   and B2's two launches (and, on the paths that run it, B3) against their
   plain versions, on rows of splats that the view culls (B3 must give them
   exactly zero), and no instance dropped under the union calibration;
   then several ranks (parallel/): every rank's band of 2 and 4 tile shards,
   interleaved and contiguous, run in turn in this process through
   parallel/mesh.py's band functions at both training views, counters
   zeroed just before (mesh_bands: each deinterleaved image against
   render(), no instance dropped in any band, B1, B2 and B3 against their
   plain versions and timed at rank 0's band of 4, what the other ranks'
   empty tiles cost B2, the 2 bands' gradients summed against the
   unsharded step's, band demand peak / mean for 2, 4 and 8 shards, and each
   rank's device busy time with the prepare replicated or sharded beside
   the frame's); and the torch.distributed path in spawned ranks (mesh_dist:
   2 ranks over gloo sharing this card on a 1 x 2 and a 2 x 1 mesh, 1 rank
   over NCCL brought up from torchrun's environment, and NCCL over up to 4
   cards where the machine has several; each rank's render_sharded, one
   sharded_train_step and 3 steps of zero_fit_steps against its own
   single-device render, step and 3 replicated sharded steps, its launches
   counted, and the SH all-reduce each replicated step issued inside its
   backward counted and timed from the issue to the backward's end; A / B /
   C and the overlap of tools/profile_overlap on the 1 x 2 gloo mesh, a
   mechanism check for two ranks sharing one card; every rank must agree);
7. checks the output: finite, the expected shape, agreeing with the
   JAX-made golden images under tests/golden/ on the two small scenes, the
   GPU render agreeing with the port's CPU render (exact and production),
   the full-size production and packed_feats16 frames near the exact frame,
   and exactly zero alpha for a camera looking away;
8. renders a 4000-splat garden at the default 1024x768 window with
   pipeline="auto", which picks the global pipeline (no kernel launched):
   timed, against the port's CPU render and the float64 oracle
   (reference/raster.py) at 256x256, against the tiled pipeline, and one
   backward at 1024x768 with its peak memory held to GLOBAL_BWD_PEAK_BYTES,
   its gradients against the CPU's at 128x128 (render_global);
9. drives the CLI: render to PNG through `python -m` in a process of its
   own; synth, render --packed-colors --fp16, bench --profile production and
   fit (orbit rig) in this process; then, beside a cameras.json of orbit
   views: path --every 2 and
   path --batch, render --camera-index --show-cameras, render --stereo
   --eye-tan-angles, render --stereo --shared-bins (one binning, within one
   8-bit step of the per-eye PNG), render --supersample 2, render of a 2000-splat scene
   with the default --pipeline auto (global), points, export --prune, info,
   save-pose (and the floor it saves in the next render), and fit and fit
   --adaptive against the cameras.json with a <ply>_vr.json present.

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
(tests/test_tiled.py); the max is not held there, since the 20-bit depth key
orders near-equal depths differently by design. Against the exact profile
with the same 20-bit key, what is left is the row layout and the early stop:
the production frame's max is held to 2^-13 (packed_colors' rounding of each
colour, under weights that sum to at most 1) + eps x max(1, largest colour)
(what the early stop leaves out) + 1e-6, and the packed_feats16 frame's to
< 0.05 (its quantized means move splats by up to 0.09 px; JAX's
packed_feats16 contract, tests/test_tiled.py). The composite tolerance does
not apply there: the colour rounding moves many pixels by up to 1.2e-4, not
a few threshold flips.
The global pipeline (plain PyTorch, no kernel): against the port's CPU render
and against the tiled pipeline, the composite tolerance; against the float64
oracle, the bounds of tests/test_render.py (mean < 5e-5, 99.5th percentile <
1e-4, max < 0.05: the 1/256 discard flips between float32 and float64); its
gradients against the CPU's, within 2e-4 of each field's largest.
Supersample: equal to the 3840x2160 frame box-filtered down within 1e-6.
render_batch views and stereo eyes: equal to render() of the camera alone,
bit for bit. Multi-device (mesh_bands, mesh_dist): an interleaved band keeps
the image's tiles and pixel coordinates, so the deinterleaved bands and
render_sharded equal render() bit for bit; a contiguous band (the JAX shift
of mean2d, which rounds it) is held to the composite tolerance. The bands'
gradients summed over the tile shards, against the unsharded step's: each
field within 2e-4 of its largest (the interleaved bands; for the contiguous
ones, which round mean2d, at most a 1e-4 fraction of the values may differ
by up to 2e-2, the flips composite_bwd's tolerance allows). Losses rtol
1e-5; ZeRO against the replicated sharded fit: losses rtol 1e-4.
Shared binning: a shared-stereo eye, and each cluster's
reference view, against render() of that view, the composite tolerance
(longer chains cut into segments elsewhere change the float association);
under the production profile the mean abs <= 2e-3 of the production contract
(the 20-bit key orders both eyes by the left eye's depth); a cluster's other
views are an approximation (view 0's depth order) and are printed, not held.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import shutil
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
ADAPTIVE_STEPS, ADAPTIVE_EVERY = 12, 4  # train_adaptive: densify events at steps 4 and 8
# fit_resume: the fit demo's scene (splatapult_tpu_torch/tools/fit_demo.py);
# steps before the checkpoint, and after it live and resumed
RESUME_SPLATS, RESUME_STEPS, RESUME_LR = 200_000, 4, 2e-2
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to the value, at most
PATH_VIEWS = 8
STEREO_IPD = 0.064
CLUSTER_VIEWS, CLUSTER_STEP = 4, 0.02  # rad between path views: about 1.15 degrees
GLOBAL_SPLATS = 4000  # below 4096: pipeline="auto" picks the global pipeline
# The global pipeline's backward at 1024x768 keeps each 64-splat block's
# incoming (colour, T) carry, 63 x 786432 x 16 B = 0.8 GB, and recomputes one
# block at a time (its [64, P] temporaries, ~0.2 GB each); an eager loop
# under autograd would keep every block's temporaries, tens of GB.
GLOBAL_BWD_PEAK_BYTES = 8 * 2 ** 30
MESH_SHARDS = (2, 4)  # mesh_bands: tile shards (ranks) run in turn in one process
BAND_LAYOUTS = ("interleaved", "contiguous")
MESH_STEPS = 3  # mesh_dist: steps of the replicated and the ZeRO fit on each mesh
OVERLAP_ITERS = 2  # mesh_dist: timed rounds of A, B and C (after two to warm up)
MESH_WORLD_TIMEOUT_S = 300.0


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the script
    started, so where the run's time goes shows in its output."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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


def write_cameras_json(path, n, width, height, radius=4.2, height_m=1.6, target=(0.0, 0.8, 0.0)):
    """n orbit cameras in the INRIA trainer's cameras.json form (rotation
    columns: the camera's x, y (down) and z (forward) axes in the world)."""
    cams = []
    for i, a in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False)):
        eye = np.asarray([np.cos(a) * radius, height_m, np.sin(a) * radius])
        fwd = np.asarray(target) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        focal = 0.5 * width / math.tan(math.pi / 6)
        cams.append({"id": i, "img_name": f"{i:05d}", "width": width, "height": height,
                     "position": eye.tolist(), "rotation": np.stack([right, -up, fwd], 1).tolist(),
                     "fx": focal, "fy": focal})
    with open(path, "w") as f:
        json.dump(cams, f)


def cli_in_process(args) -> str:
    """splatapult_tpu_torch.cli.main(args) in this process -> its stdout."""
    import contextlib
    import io

    from splatapult_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(args)
    return out.getvalue()


def cli_with_cameras_json(tmp, scene, width=640, height=384) -> dict:
    """The CLI commands that discover a cameras.json and a <ply>_vr.json,
    in this process, at width x height on the card: path, render --camera-index
    --show-cameras, render --stereo (--eye-tan-angles, and --shared-bins
    against the per-eye PNG), render --supersample, render with the
    default --pipeline auto on a 2000-splat scene (global), points, export
    --prune, info, save-pose, fit, fit --adaptive -> the phase's JSON."""
    from splatapult_tpu_torch import kernels
    from splatapult_tpu_torch.io.gaussians import load_gaussian_ply, save_gaussian_ply
    from splatapult_tpu_torch.io.points import make_debug_points, save_point_ply
    from splatapult_tpu_torch.io.synth import make_garden_scene
    from splatapult_tpu_torch.utils.image import load_png

    d = os.path.join(tmp, "scene")
    os.makedirs(d)
    ply = os.path.join(d, "garden.ply")
    save_gaussian_ply(ply, scene)
    write_cameras_json(os.path.join(d, "cameras.json"), 4, width, height)
    size = ["--width", str(width), "--height", str(height)]
    out = {}

    def png(name):
        return os.path.join(d, name)

    cli_in_process(["path", ply, "-o", png("p.png"), "--every", "2", *size])
    cli_in_process(["path", ply, "-o", png("b.png"), "--every", "2", "--batch", *size])
    for i in range(2):
        frame = load_png(png(f"p_{i:04d}.png"))
        if frame.shape != (height, width, 3) or not frame.max() > 0.1:
            raise AssertionError(f"cli path: frame {i} is empty or of the wrong size")
        if not np.array_equal(frame, load_png(png(f"b_{i:04d}.png"))):
            raise AssertionError(f"cli path --batch: frame {i} differs from path's")
    if os.path.exists(png("p_0002.png")):
        raise AssertionError("cli path --every 2 wrote more than 2 frames")
    cli_in_process(["render", ply, "-o", png("ci.png"), "--camera-index", "1", *size])
    cli_in_process(["render", ply, "-o", png("cis.png"), "--camera-index", "1", "--show-cameras",
                    *size])
    out["show_cameras_pixels_drawn"] = int(
        (np.abs(load_png(png("cis.png")) - load_png(png("ci.png"))).max(axis=-1) > 0).sum())
    if out["show_cameras_pixels_drawn"] == 0:
        raise AssertionError("cli render --show-cameras drew nothing")
    cli_in_process(["render", ply, "-o", png("st.png"), "--stereo", "--eye-tan-angles",
                    "-0.75", "0.45", "0.41", "-0.41", "-0.45", "0.75", "0.41", "-0.41", *size])
    if load_png(png("st.png")).shape != (height, 2 * width, 3):
        raise AssertionError("cli render --stereo: not twice as wide")
    # --shared-bins (20,000 splats: auto picks the tiled pipeline) bins once
    # for both eyes: one B1 launch, and a PNG within one 8-bit step of the
    # per-eye one
    cli_in_process(["render", ply, "-o", png("pe.png"), "--stereo", *size])
    kernels.reset_launch_counts()
    cli_in_process(["render", ply, "-o", png("sb.png"), "--stereo", "--shared-bins", *size])
    out["stereo_shared_bins_launches"] = dict(kernels.LAUNCH_COUNTS)
    shared, per_eye = load_png(png("sb.png")), load_png(png("pe.png"))
    out["stereo_shared_bins_png_max_abs_diff_vs_per_eye"] = float(np.abs(shared - per_eye).max())
    if (shared.shape != (height, 2 * width, 3)
            or out["stereo_shared_bins_launches"]["expand_fill"] != 1
            or out["stereo_shared_bins_launches"]["composite_fwd_segments"] != 2
            or not out["stereo_shared_bins_png_max_abs_diff_vs_per_eye"] <= 1.0 / 255.0 + 1e-6):
        raise AssertionError(f"cli render --stereo --shared-bins: {out}")
    cli_in_process(["render", ply, "-o", png("ss.png"), "--supersample", "2", *size])
    if load_png(png("ss.png")).shape != (height, width, 3):
        raise AssertionError("cli render --supersample 2: wrong size")
    small_ply = os.path.join(d, "small.ply")
    save_gaussian_ply(small_ply, make_garden_scene(2000, seed=1, device="cpu"))
    kernels.reset_launch_counts()
    cli_in_process(["render", small_ply, "-o", png("g.png"), *size])
    out["auto_2000_splats_launches"] = dict(kernels.LAUNCH_COUNTS)
    if any(kernels.LAUNCH_COUNTS.values()) or not load_png(png("g.png")).max() > 0.1:
        raise AssertionError(f"cli render --pipeline auto on 2000 splats did not go global: "
                             f"{out['auto_2000_splats_launches']}")
    pts = os.path.join(d, "points.ply")
    save_point_ply(pts, make_debug_points())
    cli_in_process(["points", pts, "-o", png("pts.png"), "--eye", "1.2", "1.1", "1.3",
                    "--target", "0.3", "0.3", "0.3", *size])
    if not load_png(png("pts.png")).max() > 0.1:
        raise AssertionError("cli points: empty image")
    cli_in_process(["export", ply, "-o", os.path.join(d, "pruned.ply"), "--prune", "1000"])
    if load_gaussian_ply(os.path.join(d, "pruned.ply"), device="cpu").num_gaussians != 1000:
        raise AssertionError("cli export --prune 1000: wrong splat count")
    info = cli_in_process(["info", ply])
    if f"splats:      {scene.num_gaussians}" not in info or "cameras:     4" not in info:
        raise AssertionError(f"cli info: {info}")
    cli_in_process(["render", ply, "-o", png("before.png"), *size])
    cli_in_process(["save-pose", ply, "--eye", "0", "1.6", "4.2", "--target", "0", "0.8", "0"])
    cli_in_process(["render", ply, "-o", png("after.png"), *size])
    out["save_pose_render_max_abs_change"] = float(
        np.abs(load_png(png("after.png")) - load_png(png("before.png"))).max())
    if not out["save_pose_render_max_abs_change"] > 0.05:
        raise AssertionError("cli save-pose: the next render did not pick up the floor")
    # fit against the cameras.json views (targets: path's frames of the true
    # scene), from a dimmed copy, with the <ply>_vr.json beside it
    cli_in_process(["path", ply, "-o", os.path.join(tmp, "target.png"), *size])
    dim = os.path.join(d, "dim.ply")
    save_gaussian_ply(dim, dataclasses.replace(scene, sh=scene.sh * 0.8))
    shutil.copy(os.path.join(d, "garden_vr.json"), os.path.join(d, "dim_vr.json"))
    fit_line = json.loads(cli_in_process(
        ["fit", dim, "--targets", os.path.join(tmp, "target_*.png"), "-o",
         os.path.join(d, "fitted.ply"), "--steps", "5"]).strip().splitlines()[-1])
    if (fit_line["views"], fit_line["splats"]) != (4, scene.num_gaussians) or not (
            math.isfinite(fit_line["loss_last"])
            and fit_line["loss_last"] < fit_line["loss_first"]):
        raise AssertionError(f"cli fit with cameras.json: {fit_line}")
    out["fit_cameras_json"] = {k: fit_line[k] for k in ("steps", "views", "loss_first",
                                                         "loss_last", "seconds")}
    # the same fit with adaptive density: one event, at step 2
    ad_line = json.loads(cli_in_process(
        ["fit", dim, "--targets", os.path.join(tmp, "target_*.png"), "-o",
         os.path.join(d, "fitted_adaptive.ply"), "--steps", "4", "--adaptive",
         "--densify-every", "2"]).strip().splitlines()[-1])
    events = ad_line["densify_events"]
    if (len(events) != 1 or events[0]["cloned"] + events[0]["split"] < 1
            or ad_line["splats"] != events[0]["num_splats"]
            or ad_line["splats"] == scene.num_gaussians
            or not math.isfinite(ad_line["loss_last"])):
        raise AssertionError(f"cli fit --adaptive: {ad_line}")
    if load_gaussian_ply(os.path.join(d, "fitted_adaptive.ply"),
                         device="cpu").num_gaussians != ad_line["splats"]:
        raise AssertionError("cli fit --adaptive wrote a .ply of the wrong size")
    out["fit_adaptive"] = {k: ad_line[k] for k in ("steps", "views", "loss_first", "loss_last",
                                                   "splats", "densify_events", "seconds")}
    return out


def perturbed(scene):
    """The training start: the scene with seeded noise on its colours,
    opacities and positions (the same in every training phase and rank)."""
    dev = scene.means.device
    gen = torch.Generator(device=dev).manual_seed(2)

    def noisy(t, sigma):
        return t + sigma * torch.randn(t.shape, generator=gen, device=dev)

    return dataclasses.replace(scene, sh=noisy(scene.sh, 0.1),
                               opacities=noisy(scene.opacities, 0.3),
                               means=noisy(scene.means, 0.005))


def scaled_grad_errs(leaf, ref_grads, what: str, allow: float = 2e-4) -> dict:
    """Each field's gradient error over that field's largest reference
    gradient -> {field: max error, field + "_share_over_2e-4": the share of
    values above 2e-4}. Every value within 2e-4; with ``allow`` > 2e-4, a
    share of at most 1e-4 of the values may differ by up to ``allow`` (the
    module docstring says where and why)."""
    errs = {}
    for f, want in ref_grads.items():
        got = getattr(leaf, f).grad
        scale = float(want.abs().max())
        err = (got - want).abs() / max(scale, 1e-30)
        errs[f] = float(err.max())
        errs[f + "_share_over_2e-4"] = float((err > 2e-4).float().mean())
        ok = errs[f] <= 2e-4 or (errs[f] <= allow and errs[f + "_share_over_2e-4"] <= 1e-4)
        if not (scale > 0.0 and bool(torch.isfinite(got).all()) and ok):
            raise AssertionError(f"{what}: {f} gradient {errs[f]:.3e} of its largest {scale:.3e} "
                                 f"({errs[f + '_share_over_2e-4']:.2e} of the values over 2e-4)")
    return errs


def mesh_rank(rank, world, backend, port, out_dir, meshes):
    """One rank of phase mesh_dist, on the card: the full-width garden and
    its two training views; per mesh (views, tiles) of ``meshes``, with the
    launch counters zeroed just before, render_sharded of view 0, one
    sharded_train_step over both views, MESH_STEPS steps of the replicated
    sharded fit and of zero_fit_steps; each held against this process's
    single-device render and step (composite tolerance; gradients within
    2e-4 of each field's largest) and ZeRO's losses against the replicated
    fit's (rtol 1e-4). The SH all-reduce that every replicated step issued
    inside its backward is counted (1 a step; in a one-rank world it runs no
    collective), with the milliseconds from its issue to the backward's end
    by CUDA events (parallel.mesh.sh_allreduce_trace). On the 1 x 2 mesh of
    the gloo world, after the counted run, A / B / C and the overlap from
    tools/profile_overlap.measure_overlap (two ranks sharing this card: a
    mechanism check). "nccl": torchrun's environment, initialize_distributed,
    card ``rank``; "gloo": init_process_group itself, every rank on card 0.
    Pickles its results into ``out_dir``."""
    import pickle

    import torch.distributed as dist

    from splatapult_tpu_torch import kernels, train
    from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
    from splatapult_tpu_torch.ops.tiled import _grid_from_config
    from splatapult_tpu_torch.parallel import distributed as PD
    from splatapult_tpu_torch.parallel import mesh as PM
    from splatapult_tpu_torch.tools.profile_overlap import measure_overlap

    R = importlib.import_module("splatapult_tpu_torch.render")
    if backend == "nccl":
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        if not PD.initialize_distributed():
            raise RuntimeError("initialize_distributed found no world")
    else:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    fields = ("means", "sh", "opacities", "log_scales", "quats")
    scene = make_garden_scene(FULL_SPLATS, seed=0, device=dev)
    views = garden_cameras(TRAIN_VIEWS, width=FULL_W, height_px=FULL_H, device=dev)
    view_list = train._views(views)
    exact = R.apply_profile(R.RenderConfig(width=FULL_W, height=FULL_H, pipeline="tiled"),
                            "exact")
    fwd = dataclasses.replace(exact, forward_only=True)
    start = perturbed(scene)
    true_cfg = R.calibrate_config(scene, views, exact)
    targets = torch.stack([R.render(scene, v, true_cfg) for v in view_list])
    with torch.no_grad():
        ref_img = R.render(scene, view_list[0], R.calibrate_config(scene, view_list[0], fwd))
    ref = train.leaf_copy(start)
    ref_loss = float(train._batch_value_and_grad(ref, views, targets,
                                                 R.calibrate_config(start, views, exact)))
    ref_grads = {f: getattr(ref, f).grad for f in fields}

    def factory(s):
        return train.default_optimizer(s, 1e-2)

    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "reference_loss": ref_loss}
    for v_sh, t_sh in meshes:
        mesh = PM.make_render_mesh(t_sh, v_sh)
        band_cfg = PM.calibrate_config_sharded(start, views, exact, mesh)
        img_cfg = PM.calibrate_config_sharded(scene, view_list[0], fwd, mesh)
        full = PM.shard_targets(targets, band_cfg, mesh)
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with PM.sh_allreduce_trace() as markers:
            img = PM.render_sharded(scene, view_list[0], img_cfg, mesh)
            leaf = train.leaf_copy(start)
            loss, _ = PM.sharded_train_step(leaf, views, full, band_cfg, mesh)
            rep = train.leaf_copy(start)
            rep_losses = PM.make_sharded_fit_steps(band_cfg, mesh, factory(rep), MESH_STEPS)(
                rep, views, full)
            zero, _, zero_losses = PM.zero_fit_steps(start, views, targets, band_cfg, mesh,
                                                     factory, MESH_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCH_COUNTS)
        what = f"mesh_dist {backend} {world} ranks, mesh {v_sh}x{t_sh}, rank {rank}"
        per = TRAIN_VIEWS // v_sh
        want = {"expand_fill": 1 + per * (1 + 2 * MESH_STEPS),
                "composite_fwd_segments": 1 + per * (1 + 2 * MESH_STEPS),
                "composite_fwd_combine": 1 + per * (1 + 2 * MESH_STEPS),
                "composite_bwd": per * (1 + 2 * MESH_STEPS)}
        if launches != want:
            raise AssertionError(f"{what}: kernel launches {launches}, expected {want}")
        # the replicated steps' SH all-reduces: the step, the fit's steps
        # (ZeRO has none); a one-rank world runs no collective
        issued = [(m.issued, m.collectives) for m in markers]
        want_issued = [(1, 1 if world > 1 else 0)] * (1 + MESH_STEPS)
        if issued != want_issued:
            raise AssertionError(f"{what}: SH all-reduces (issued, collectives) a step "
                                 f"{issued}, expected {want_issued}")
        windows = [m.window_ms() for m in markers]
        img_err = composite_close(img, ref_img, f"{what}: render_sharded against render")
        if not torch.equal(img, ref_img):  # the interleaved bands are render's rows
            raise AssertionError(f"{what}: render_sharded is not render's image bit for bit")
        grad_err = scaled_grad_errs(leaf, ref_grads, f"{what}: sharded_train_step")
        rep_l, zero_l = rep_losses.tolist(), zero_losses.tolist()
        if not (abs(float(loss) - ref_loss) <= 1e-5 * ref_loss
                and np.allclose(zero_l, rep_l, rtol=1e-4, atol=0.0) and rep_l[-1] < rep_l[0]):
            raise AssertionError(f"{what}: loss {float(loss)} against {ref_loss}; ZeRO losses "
                                 f"{zero_l} against the replicated fit's {rep_l}")
        param_diff = {f: float((getattr(zero, f) - getattr(rep, f).detach()).abs().max())
                      for f in fields}
        demands = [PM.band_instance_demands(start, v, exact, t_sh).tolist() for v in view_list]
        overlap = None
        if backend == "gloo" and (v_sh, t_sh) == (1, 2):
            overlap = measure_overlap(train.leaf_copy(start), views, full, band_cfg, mesh,
                                      iters=OVERLAP_ITERS)
            overlap["label"] = "mechanism check: two ranks sharing one card over gloo"
            if overlap["sh_allreduces_per_step"] != [1] * OVERLAP_ITERS or not all(
                    math.isfinite(overlap[k]) for k in (
                        "full_step_ms", "no_collective_ms", "collectives_ms",
                        "sh_allreduce_issue_to_backward_end_ms")):
                raise AssertionError(f"{what}: overlap measurement {overlap}")
        out[f"{v_sh}x{t_sh}"] = {
            "seconds": seconds, "launches": launches, "render_max_abs_err": img_err,
            "step_loss": float(loss), "step_grad_max_scaled_err": grad_err,
            "sh_allreduces_issued_collectives_per_step": issued,
            "sh_allreduce_issue_to_backward_end_ms": {
                "step": windows[0], "fit_steps": windows[1:]},
            "overlap": overlap,
            "replicated_fit_losses": rep_l, "zero_fit_losses": zero_l,
            "zero_vs_replicated_params_max_abs_diff": param_diff,
            "max_instance_mult": band_cfg.max_instance_mult,
            "emax": _grid_from_config(band_cfg, FULL_SPLATS).emax, "band_demands": demands}
        del img, leaf, rep, zero
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(world: int, backend: str, meshes, timeout_s: float = MESH_WORLD_TIMEOUT_S):
    """mesh_rank in ``world`` spawned processes -> (each rank's results,
    seconds). A rank that raises fails the script; a world that outlives
    ``timeout_s`` is killed and fails it too."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(mesh_rank, args=(world, backend, port, out_dir, meshes),
                                 nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(1.0, t0 + timeout_s - time.perf_counter())):
                if time.perf_counter() > t0 + timeout_s:
                    raise AssertionError(f"mesh_dist: {backend} world of {world} did not finish "
                                         f"in {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results, time.perf_counter() - t0


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
    from splatapult_tpu_torch.parallel import mesh as PM
    from splatapult_tpu_torch.tools.profile_phases import _profile as profile_device
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

    def kernel_inputs(scene, cam, cfg, row_stride=1, row_offset=None, grid=None):
        """The tensors the kernels' wrappers receive on the render path (the
        instance rows in the config's layout); ``grid``: another grid than
        the config's (an interleaved band's, parallel/mesh.py)."""
        d = R.prepare_splats(scene, cam, cfg, sort=False)
        grid = grid or tiled._grid_from_config(cfg, scene.num_gaussians, row_stride)
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
        """The training start (made in each training phase, so the render
        phases' peak memory does not hold it)."""
        return perturbed(scene)

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

    def frame_near_exact(img, exact_img, exact20_img, what, cfg_f):
        """The frame against the exact frame: the mean of the JAX package's
        packed_feats16 contract. (Its max is not held there: the 20-bit
        depth key of these profiles orders splats whose depths agree to
        2.4e-4 as they come, which moves single pixels by up to the
        difference of two splats' colours.) Against the exact frame with the
        same 20-bit key, what is left is the row layout and the early stop,
        and the max is held to what they allow: packed_colors' colours are
        rounded to steps of 2^-12, which moves a pixel by at most 2^-13
        (the weights of a pixel sum to at most 1); the early stop leaves
        out at most eps x the largest colour (or 1, for alpha). With
        packed_feats16 (quantized means, f16 conics) JAX's max < 0.05."""
        diff = (img - exact_img).abs()
        out = {"max_abs_diff_vs_exact": float(diff.max()),
               "mean_abs_diff_vs_exact": float(diff.mean()),
               "share_over_0.05_vs_exact": float((diff > 0.05).float().mean())}
        if not out["mean_abs_diff_vs_exact"] <= 2e-3:
            raise AssertionError(f"{what}: frame against the exact frame {out}")
        diff20 = (img - exact20_img).abs()
        out["max_abs_diff_vs_exact_with_depth_bits_20"] = float(diff20.max())
        out["share_over_1e-4_vs_exact_with_depth_bits_20"] = float((diff20 > 1e-4).float().mean())
        if cfg_f.packed_feats16:
            out["bound_vs_exact_with_depth_bits_20"] = 0.05
        else:
            with torch.no_grad():
                rgb_max = float(
                    R.prepare_splats(scene, cam, cfg_f, sort=False)["rgb"].abs().max())
            out["bound_vs_exact_with_depth_bits_20"] = (
                (2.0 ** -13 if cfg_f.packed_colors else 0.0)
                + cfg_f.early_stop_eps * max(1.0, rgb_max) + 1e-6)  # + float rounding
        if not out["max_abs_diff_vs_exact_with_depth_bits_20"] <= out[
                "bound_vs_exact_with_depth_bits_20"]:
            raise AssertionError(f"{what}: against the exact frame with the same key {out}")
        return out

    def composite_rows(cfg, launches_fwd, exact_tables=False, at=None, band=None):
        """B2 and B3 at the full-size view's shapes in cfg's row layout:
        against their plain versions, timed, with their bounds -> (the two
        rows of the kernels line, extras). With ``exact_tables`` also B1's
        row and the tail's timings (the layout does not touch either).
        ``at``: another (scene, camera) than the garden view. ``band``:
        (shards, rank) of an interleaved tile-row band (parallel/mesh.py);
        its bounds count the band's own tiles."""
        scene_at, cam_at = at or (scene, cam)
        n = scene_at.num_gaussians
        if band is None:
            grid, table, bins, inst, tstart, nblk = kernel_inputs(scene_at, cam_at, cfg)
        else:
            grid, table, bins, inst, tstart, nblk = kernel_inputs(
                scene_at, cam_at, cfg, band[0], band[1], PM._band_grid(cfg, n, band[0]))
        layout, bf16 = layout_of(grid), is_bf16(grid)
        culled = int(bins["num_culled_instances"])
        if culled != 0:
            raise AssertionError(f"{layout}: {culled} culled instances")
        live_slots = int(nblk.sum()) * grid.block
        extra, rows = {"culled": culled}, []
        if exact_tables:
            total = int(table["ends"][-1])
            e_args = (table["ends"], table["tile0"], table["nx"], table["dbits"],
                      grid.emax, grid.tiles_x * grid.row_stride)
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
            # both column types, whichever the profile picks (production: bf16)
            f32_grid = dataclasses.replace(grid, grad_sort_dtype="float32")
            bf16_grid = dataclasses.replace(grid, grad_sort_dtype="bfloat16")

            def scatter(dtype=torch.float32):
                return torch.zeros((n + 1, C.NUM_GRAD_COLS), dtype=dtype,
                                   device=dev).index_add_(0, splat_ids, d_inst.t().to(dtype))

            extra["tail_ms"] = {
                "per_splat_sums": event_ms(lambda: C.per_splat_sums(*tail_args, f32_grid), 10),
                "per_splat_sums_bf16_columns": event_ms(
                    lambda: C.per_splat_sums(*tail_args, bf16_grid), 10),
                "index_add_": event_ms(scatter, 10)}
            d_feats = C.per_splat_sums(*tail_args, f32_grid)
            if not torch.equal(d_feats, C.per_splat_sums(*tail_args, f32_grid)):
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
            # stated on the per-column scale (the tail's float64 prefix sums
            # round relative to the running total); bf16 columns round every
            # instance value by up to 2^-9 of itself
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
        # the tiles whose rows the function must write (a band's own: the
        # others' rows are written, but nobody reads them)
        tiles_out = grid.num_tiles // grid.row_stride
        # (the forward's locals, written and read once between its two
        # kernels, are the design's traffic, not the function's)
        c_bytes = row_bytes * needed_slots + 8 * val_bytes * tiles_out * p + 8 * tiles_out
        c_flop = 2 * 15 * pairs_above + 2 * 25 * needed_slots
        c_bound_b = c_bytes / HBM_BYTES_PER_S * 1e3
        c_bound_o = c_flop / FP32_FLOP_PER_S * 1e3
        # backward bytes: per slot a row read and nine floats written, per
        # pixel five rows each of the forward's output and its cotangent
        # read, per pixel and segment a checkpoint of four floats
        b_bytes = ((row_bytes + 4 * C.NUM_GRAD_COLS) * needed_slots
                   + 10 * val_bytes * tiles_out * p + 16 * live_segments * p
                   + 8 * tiles_out)
        b_flop = 2 * 40 * pairs_above + 2 * 25 * needed_slots
        b_bound_b = b_bytes / HBM_BYTES_PER_S * 1e3
        b_bound_o = b_flop / FP32_FLOP_PER_S * 1e3
        shape = {"layout": layout, "row_bytes": row_bytes, "rows_dtype": str(out.dtype),
                 "early_stop_eps": grid.early_stop_eps, "mcap": grid.mcap,
                 "live_slots": live_slots, "walked_slots": needed_slots,
                 "tiles_stopped_early": int((walked < nblk).sum()),
                 "tiles": grid.num_tiles, "tiles_owned": tiles_out, "tile_pixels": p,
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
                    R.prepare_splats(sc, v, train_cfg, sort=False), train_cfg,
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

    def adaptive_phase(cfg):
        """densify.fit_scene_adaptive at full width: from every other splat of
        the training start (750,000) towards renders of the true scene at the
        two training views, ADAPTIVE_STEPS steps with a densify event every
        ADAPTIVE_EVERY, DensifyConfig() defaults, counters zeroed just
        before; then B1, B2 and B3 against their plain versions at the grown
        shape (the final scene, the first view, its last calibration) ->
        (the phase's JSON, the launch counts)."""
        from splatapult_tpu_torch import densify

        train_start = make_train_start()
        start = dataclasses.replace(train_start, **{
            f.name: getattr(train_start, f.name)[::2].contiguous()
            for f in dataclasses.fields(train_start)})
        del train_start
        exact_train = dataclasses.replace(cfg, forward_only=False)
        true_cfg = R.calibrate_config(scene, views, exact_train)
        targets = torch.stack([R.render(scene, v, true_cfg) for v in view_list])
        start_cfg = R.calibrate_config(start, views, exact_train)
        # (scene, config) at the start of every chunk and at the end: their
        # instance drops are counted after the run, outside the launch counts
        chunk_starts = [(start, start_cfg)]
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        grads_after_event = {}
        event_steps = set(range(ADAPTIVE_EVERY, ADAPTIVE_STEPS - ADAPTIVE_EVERY + 1,
                                ADAPTIVE_EVERY))

        def on_step(step, params, loss):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((f"step {step}", ev))
            if step in event_steps:  # the first step after an event
                grads_after_event[step] = {
                    f.name: bool(torch.isfinite(getattr(params, f.name).grad).all())
                    for f in dataclasses.fields(params)}

        def on_event(event, params, config):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((f"event {event['step']}", ev))
            chunk_starts.append((dataclasses.replace(params, **{
                f.name: getattr(params, f.name).detach().clone()
                for f in dataclasses.fields(params)}), config))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        marks[0][1].record()
        fitted, losses, events = densify.fit_scene_adaptive(
            start, views, targets, start_cfg, steps=ADAPTIVE_STEPS, densify_every=ADAPTIVE_EVERY,
            callback=on_step, on_event=on_event)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        del targets
        n_launch = TRAIN_VIEWS * ADAPTIVE_STEPS
        if any(c != n_launch for c in launches.values()):
            raise AssertionError(f"train_adaptive: kernel launches {launches}, expected "
                                 f"{n_launch} each (views x steps)")
        # times: each step, each chunk (from its start to its last step) and
        # each event (densify + state carry + recalibration)
        times = [(a[0], b[0], a[1].elapsed_time(b[1])) for a, b in zip(marks[:-1], marks[1:])]
        step_ms = [ms for _, to, ms in times if to.startswith("step")]
        event_ms = [ms for _, to, ms in times if to.startswith("event")]
        chunk_ms = [sum(step_ms[i:i + ADAPTIVE_EVERY])
                    for i in range(0, ADAPTIVE_STEPS, ADAPTIVE_EVERY)]
        chunk_starts.append((fitted, chunk_starts[-1][1]))
        culled = []
        with torch.no_grad():
            for sc, c in chunk_starts:
                culled.append(sum(int(tiled.composite_tiled(
                    R.prepare_splats(sc, v, c, sort=False), c,
                    return_aux=True)[1]["num_culled_instances"])
                    for v in view_list))
        sizes = [start.num_gaussians] + [e["num_splats"] for e in events]
        per_event = [{**e, "splats_before": before,
                      "max_instance_mult": c.max_instance_mult,
                      "emax": tiled._grid_from_config(c, e["num_splats"]).emax,
                      "event_ms": ms}
                     for e, before, (_, c), ms in zip(events, sizes, chunk_starts[1:], event_ms)]
        if [e["step"] for e in events] != sorted(event_steps):
            raise AssertionError(f"train_adaptive: events at {[e['step'] for e in events]}")
        for e in per_event:
            if e["cloned"] + e["split"] < 1 or not e["num_splats"] > e["splats_before"]:
                raise AssertionError(f"train_adaptive: an event did not grow the scene: {e}")
        if any(culled):
            raise AssertionError(f"train_adaptive: culled instances by chunk {culled}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"train_adaptive: losses not finite or not falling: {losses}")
        if sorted(grads_after_event) != sorted(event_steps) or not all(
                all(ok.values()) for ok in grads_after_event.values()):
            raise AssertionError(f"train_adaptive: gradients after the events {grads_after_event}")
        # the kernels at the grown shape, against their plain versions
        t_check = time.perf_counter()
        final_cfg = dataclasses.replace(chunk_starts[-1][1], forward_only=True)
        view0 = view_list[0]
        rows, extra = composite_rows(final_cfg, None, exact_tables=True, at=(fitted, view0))
        check_s = time.perf_counter() - t_check
        del chunk_starts, fitted
        return {"phase": "train_adaptive", "splats_start": start.num_gaussians,
                "splats_end": sizes[-1], "views": TRAIN_VIEWS, "width": FULL_W,
                "height": FULL_H, "profile": R.profile_name(start_cfg),
                "steps": ADAPTIVE_STEPS, "densify_every": ADAPTIVE_EVERY,
                "densify_config": dataclasses.asdict(densify.DensifyConfig()),
                "max_instance_mult_start": start_cfg.max_instance_mult,
                "emax_start": tiled._grid_from_config(start_cfg, start.num_gaussians).emax,
                "events": per_event, "losses": losses,
                "ms_per_step_median": statistics.median(step_ms), "ms_per_step_all": step_ms,
                "ms_per_chunk": chunk_ms, "event_ms": event_ms,
                "num_culled_instances_by_chunk_start_and_end": culled,
                "first_step_after_event_grads_finite": grads_after_event,
                "launches": launches, "peak_memory_bytes": peak,
                "kernels_at_grown_shape": {r["name"]: r for r in rows},
                "kernels_at_grown_shape_extra": extra, "kernel_check_seconds": check_s,
                "device": kind, "nvidia_smi_name_power_limit": smi}, launches

    def resume_phase():
        """train.train_step at the fit demo's shape (garden RESUME_SPLATS,
        the two training views at 1920x1080, the production profile,
        train.default_optimizer at RESUME_LR) from the perturbed garden
        towards renders of the true one, counters zeroed just before:
        RESUME_STEPS steps, io/checkpoint.save_train_state, RESUME_STEPS
        steps live; load_train_state into fresh leaves with a fresh optimizer
        (load_state_dict) and the same RESUME_STEPS steps again. The resumed
        losses and final parameters must equal the live ones bit for bit ->
        (the phase's JSON, the launch counts)."""
        from splatapult_tpu_torch.io import checkpoint as CK

        true_s = make_garden_scene(RESUME_SPLATS, seed=0, device=dev)
        r_cfg = R.calibrate_config(true_s, views, R.apply_profile(
            dataclasses.replace(base, forward_only=False), "production"))
        with torch.no_grad():
            targets = torch.stack([R.render(true_s, v, r_cfg) for v in view_list])
        params = train.leaf_copy(perturbed(true_s))
        del true_s
        opt = train.default_optimizer(params, RESUME_LR)
        marks = []

        def steps(sc, o):
            """RESUME_STEPS steps, a CUDA event after each -> their losses
            (device scalars, read after the phase)."""
            out = []
            for _ in range(RESUME_STEPS):
                out.append(train.train_step(sc, o, views, targets, r_cfg))
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        first = steps(params, opt)
        saved = train.detached(train.leaf_copy(params))
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CK.save_train_state(tmp, params, opt, RESUME_STEPS)
            write_s = time.perf_counter() - t0
            ckpt_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
            live = steps(params, opt)
            t0 = time.perf_counter()
            loaded, state, step = CK.load_train_state(tmp, RESUME_STEPS, device=dev)
            read_s = time.perf_counter() - t0
        resumed = train.leaf_copy(loaded)
        opt2 = train.default_optimizer(resumed, RESUME_LR)
        opt2.load_state_dict(state)
        again = steps(resumed, opt2)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        step_ms = [a.elapsed_time(b) for i, (a, b) in enumerate(zip(marks[:-1], marks[1:]))
                   if i not in (RESUME_STEPS, 2 * RESUME_STEPS)]  # span the write, the read
        n_launch = TRAIN_VIEWS * 3 * RESUME_STEPS
        if any(c != n_launch for c in launches.values()):
            raise AssertionError(f"fit_resume: kernel launches {launches}, expected "
                                 f"{n_launch} each (views x steps)")
        if step != RESUME_STEPS or not all(
                torch.equal(getattr(loaded, f.name), getattr(saved, f.name))
                for f in dataclasses.fields(saved)):
            raise AssertionError("fit_resume: the loaded scene is not the saved one")
        losses = {k: torch.stack(v).tolist() for k, v in
                  (("first", first), ("live", live), ("resumed", again))}
        if not all(math.isfinite(x) for v in losses.values() for x in v) or not (
                losses["live"][-1] < losses["first"][0]):
            raise AssertionError(f"fit_resume: losses not finite or not falling: {losses}")
        diff = {f.name: float((getattr(resumed, f.name) - getattr(params, f.name)).abs().max())
                for f in dataclasses.fields(params)}
        if losses["resumed"] != losses["live"] or any(diff.values()):
            raise AssertionError(f"fit_resume: the resumed run differs from the live one: "
                                 f"losses {losses}, parameters' max abs difference {diff}")
        del params, opt, opt2, loaded, state, saved
        # the kernels at this phase's shape (the resumed scene, the first
        # view, its calibration), against their plain versions
        t_check = time.perf_counter()
        rows, extra = composite_rows(dataclasses.replace(r_cfg, forward_only=True), None,
                                     exact_tables=True, at=(resumed, view_list[0]))
        check_s = time.perf_counter() - t_check
        del resumed, targets
        return {"phase": "fit_resume", "splats": RESUME_SPLATS, "views": TRAIN_VIEWS,
                "width": FULL_W, "height": FULL_H, "profile": R.profile_name(r_cfg),
                "layout": layout_of(tiled._grid_from_config(r_cfg, RESUME_SPLATS)),
                "max_instance_mult": r_cfg.max_instance_mult, "steps_each": RESUME_STEPS,
                "losses": losses, "resumed_equals_live": "bit for bit",
                "checkpoint_mb": ckpt_bytes / 1e6, "checkpoint_write_s": write_s,
                "checkpoint_read_s": read_s, "ms_per_step_median": statistics.median(step_ms),
                "ms_per_step_all": step_ms, "launches": launches, "peak_memory_bytes": peak,
                "kernels_at_shape": {r["name"]: r for r in rows},
                "kernels_at_shape_extra": extra, "kernel_check_seconds": check_s,
                "device": kind, "nvidia_smi_name_power_limit": smi}, launches

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

    # ---- phase 5b: adaptive density at full width (train_adaptive)
    adaptive_json, adaptive_launches = adaptive_phase(cfg)
    emit(adaptive_json)
    for row in kernel_rows:
        row["launches_by_path"]["train_adaptive"] = sum(
            adaptive_launches[c] for c in KERNEL_COUNTERS[row["name"]])
        grown = adaptive_json["kernels_at_grown_shape"][row["name"]]
        row["at_train_adaptive_grown_shape"] = {
            k: grown[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "shape")}

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
                                                render_json["phase"], cfg_l),
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

    # ---- phase 5c: a train state checkpointed on the card and resumed
    resume_json, resume_launches = resume_phase()
    emit(resume_json)
    for row in kernel_rows:  # B1 and the production rows (i32x8) of B2 and B3
        at_resume = resume_json["kernels_at_shape"].get(row["name"])
        if at_resume is not None:
            counter = row["name"].split("[")[0]
            row["launches_by_path"]["fit_resume"] = sum(
                resume_launches[c] for c in KERNEL_COUNTERS[counter])
            row["at_fit_resume_shape"] = {
                k: at_resume[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "shape")}

    # ---- phase 6: the rest of the viewer on the same scene
    fwd_once = {"expand_fill": 1, "composite_fwd_segments": 1, "composite_fwd_combine": 1,
                "composite_bwd": 0}

    def forward_kernels_close(cfg_x, what):
        """B1 and the composite forward (whole, and each of its two launches)
        at cfg_x's shapes against their plain versions: the kernels a
        forward-only render at that size launches -> (their max abs errors,
        the shapes)."""
        grid, table, bins, inst, tstart, nblk = kernel_inputs(scene, cam, cfg_x)
        e_args = (table["ends"], table["tile0"], table["nx"], table["dbits"],
                  grid.emax, grid.tiles_x)
        got, want = B.expand_fill(*e_args), B.expand_fill_plain(*e_args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"expand_fill != plain version ({what})")
        errs = {"expand_fill_max_abs_err": float((got - want).abs().max())}
        del got, want
        out = C.composite_fwd(inst, tstart, nblk, grid)
        ref = C.composite_fwd_plain(inst, tstart, nblk, grid)
        torch.cuda.synchronize()
        errs["composite_fwd_max_abs_err"] = composite_close(out, ref, f"composite_fwd ({what})",
                                                            is_bf16(grid))
        del out, ref
        errs.update(check_fwd_passes(inst, tstart, nblk, grid, what))
        return errs, {"emax": grid.emax, "mcap": grid.mcap, "tiles": grid.num_tiles,
                      "deepest_tile_blocks": int(nblk.max()),
                      "culled": int(bins["num_culled_instances"])}

    def counted(fn):
        """fn() with the launch counters zeroed just before -> (its result,
        the launch counts of that call)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        return result, dict(kernels.LAUNCH_COUNTS)

    def want_launches(what, got, views, backward=False, binnings=None):
        """Each view's composite launched once (its two forward kernels, and
        B3 with ``backward``), B1 once per binning (one per view unless the
        views share binnings)."""
        want = {k: v * views for k, v in fwd_once.items()}
        if binnings is not None:
            want["expand_fill"] = binnings
        if backward:
            want["composite_bwd"] = views
        if got != want:
            raise AssertionError(f"{what}: kernel launches {got}, expected {want}")

    def frame_ms(fn, reps=N_RENDERS):
        """fn() timed alone by CUDA events after two warm-ups -> (median ms,
        all)."""
        for _ in range(2):
            fn()
        times = [event_ms_once(fn)[0] for _ in range(reps)]
        return statistics.median(times), times

    # supersample 2: 3840x2160 inside, calibrated at that size
    ss_cfg = R.calibrate_config(scene, cam, dataclasses.replace(cfg, supersample=2))
    hi_cfg = dataclasses.replace(ss_cfg, supersample=1, width=2 * FULL_W, height=2 * FULL_H)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss_img, ss_launches = counted(lambda: R.render(scene, cam, ss_cfg))
    ss_peak = torch.cuda.max_memory_allocated()
    want_launches("render_supersample", ss_launches, 1)
    ss_ms, ss_all = frame_ms(lambda: R.render(scene, cam, ss_cfg))
    with torch.no_grad():
        d_hi = R.prepare_splats(scene, cam, hi_cfg, sort=False)
        hi_img, aux = tiled.composite_tiled(d_hi, hi_cfg, return_aux=True)
        ss_culled = int(aux["num_culled_instances"])
        # the capacity a calibration at the output size (the JAX package's
        # calibrate_config) gives, used at the rendered size
        at_output = R.calibrate_config(scene, cam, dataclasses.replace(cfg, supersample=1))
        dropped_at_output = int(tiled.composite_tiled(d_hi, dataclasses.replace(
            hi_cfg, max_instance_mult=at_output.max_instance_mult),
            return_aux=True)[1]["num_culled_instances"])
        del d_hi
    box = hi_img.reshape(FULL_H, 2, FULL_W, 2, 4).mean(dim=(1, 3))
    ss_err = float((ss_img - box).abs().max())
    del hi_img, box
    # the kernels at the shapes this path gives them, against their plain
    # versions (no other phase reaches a 3840x2160 grid)
    t_check = time.perf_counter()
    ss_kernel_errs, ss_kernel_shape = forward_kernels_close(hi_cfg, "supersample 3840x2160")
    ss_check_s = time.perf_counter() - t_check
    if ss_culled != 0 or not ss_err <= 1e-6:
        raise AssertionError(f"render_supersample: {ss_culled} culled instances, max abs "
                             f"{ss_err} from the 3840x2160 frame box-filtered")
    if ss_img.shape != (FULL_H, FULL_W, 4) or not bool(torch.isfinite(ss_img).all()):
        raise AssertionError("render_supersample: wrong shape or non-finite values")
    emit({"phase": "render_supersample", "splats": n, "width": FULL_W, "height": FULL_H,
          "supersample": 2, "max_instance_mult": ss_cfg.max_instance_mult,
          "emax": tiled._grid_from_config(hi_cfg, n).emax,
          "num_culled_instances": ss_culled,
          "max_abs_err_vs_box_filtered_3840x2160": ss_err,
          "kernels_vs_plain_at_3840x2160": {**ss_kernel_errs, "shape": ss_kernel_shape,
                                            "seconds": ss_check_s},
          "ms_per_frame_median": ss_ms, "ms_per_frame_all": ss_all,
          "peak_memory_bytes": ss_peak, "launches": ss_launches,
          "capacity_calibrated_at_1920x1080": {
              "max_instance_mult": at_output.max_instance_mult,
              "emax": tiled._grid_from_config(at_output, n).emax,
              "instances_dropped_at_3840x2160": dropped_at_output},
          "device": kind, "nvidia_smi_name_power_limit": smi})
    del ss_img

    def batch_equals_singles(what, cams, cfg_b, imgs):
        for v in range(cams.cam_to_world.shape[0]):
            one = R.render(scene, R.Camera(cam_to_world=cams.cam_to_world[v],
                                           proj=cams.proj[v]), cfg_b)
            if not torch.equal(imgs[v], one):
                raise AssertionError(f"{what}: view {v} differs from render() of its camera")

    # the orbit path through render_batch
    path_cams = garden_cameras(PATH_VIEWS, width=FULL_W, height_px=FULL_H, device=dev)
    path_cfg = R.calibrate_config(scene, path_cams, cfg)
    path_imgs, path_launches = counted(lambda: R.render_batch(scene, path_cams, path_cfg))
    want_launches("render_path", path_launches, PATH_VIEWS)
    batch_equals_singles("render_path", path_cams, path_cfg, path_imgs)
    if not bool(torch.isfinite(path_imgs).all()) or float(path_imgs[..., 3].amax(
            dim=(1, 2)).min()) <= 0.1:
        raise AssertionError("render_path: non-finite values or an empty view")
    del path_imgs
    path_ms, path_all = frame_ms(lambda: R.render_batch(scene, path_cams, path_cfg), reps=3)
    single_ms, _ = frame_ms(lambda: [R.render(scene, R.Camera(m, q), path_cfg)
                                     for m, q in zip(path_cams.cam_to_world, path_cams.proj)],
                            reps=3)
    emit({"phase": "render_path", "splats": n, "views": PATH_VIEWS, "width": FULL_W,
          "height": FULL_H, "max_instance_mult": path_cfg.max_instance_mult,
          "ms_per_view_render_batch": path_ms / PATH_VIEWS,
          "ms_per_batch_all": path_all, "ms_per_view_render_one_by_one": single_ms / PATH_VIEWS,
          "launches": path_launches, "views_equal_render_of_their_camera": True,
          "device": kind, "nvidia_smi_name_power_limit": smi})

    # the stereo pair with per-eye asymmetric frusta (an HMD's shape: wider
    # outward), forward and once differentiated
    t = math.tan(math.pi / 8) * FULL_W / FULL_H
    tan = np.asarray([[-1.3 * t, 0.8 * t, math.tan(math.pi / 8), -math.tan(math.pi / 8)],
                      [-0.8 * t, 1.3 * t, math.tan(math.pi / 8), -math.tan(math.pi / 8)]],
                     np.float32)
    pair = cam.stereo_pair(0.064, tan_angles=tan, near=0.1, far=1000.0)
    pair_cfg = R.calibrate_config(scene, pair, cfg)
    pair_imgs, pair_launches = counted(lambda: R.render_batch(scene, pair, pair_cfg))
    want_launches("render_stereo", pair_launches, 2)
    batch_equals_singles("render_stereo", pair, pair_cfg, pair_imgs)
    if float((pair_imgs[0] - pair_imgs[1]).abs().max()) <= 1e-3:
        raise AssertionError("render_stereo: the two eyes are the same image")
    del pair_imgs
    pair_ms, pair_all = frame_ms(lambda: R.render_batch(scene, pair, pair_cfg))
    train_pair_cfg = dataclasses.replace(pair_cfg, forward_only=False)
    params = dataclasses.replace(scene, **{f.name: getattr(scene, f.name).detach().clone()
                                           .requires_grad_(True)
                                           for f in dataclasses.fields(scene)})

    def pair_backward():
        (R.render_batch(params, pair, train_pair_cfg) ** 2).mean().backward()

    _, pair_bwd_launches = counted(pair_backward)
    want_launches("render_stereo backward", pair_bwd_launches, 2, backward=True)
    pair_grads = {f.name: float(getattr(params, f.name).grad.abs().max())
                  for f in dataclasses.fields(params)}
    if not all(math.isfinite(g) and g > 0.0 for g in pair_grads.values()):
        raise AssertionError(f"render_stereo backward: gradients {pair_grads}")
    del params
    emit({"phase": "render_stereo", "splats": n, "width": FULL_W, "height": FULL_H,
          "ipd": 0.064, "tan_angles": tan.tolist(), "max_instance_mult": pair_cfg.max_instance_mult,
          "ms_per_pair_median": pair_ms, "ms_per_pair_all": pair_all,
          "launches": pair_launches, "launches_backward": pair_bwd_launches,
          "grad_abs_max": pair_grads, "eyes_equal_render_of_their_camera": True,
          "device": kind, "nvidia_smi_name_power_limit": smi})
    for row in kernel_rows[:2]:  # B1 and B2 (f32x16): forward launches by path
        counter = "expand_fill" if row["name"] == "expand_fill" else "composite_fwd"
        for path, counts in (("render_supersample", ss_launches), ("render_path", path_launches),
                             ("render_stereo", pair_launches)):
            row["launches_by_path"][path] = sum(counts[c] for c in KERNEL_COUNTERS[counter])
        row["max_abs_err_at_render_supersample_shapes"] = ss_kernel_errs[
            f"{counter}_max_abs_err"]
    kernel_rows[2]["launches_by_path"]["render_stereo_backward"] = (
        pair_bwd_launches["composite_bwd"])

    # ---- phase 6b: shared binning (stereo.py, cluster.py) against per-view
    # rendering of the same views
    from splatapult_tpu_torch import cluster as CL, stereo as ST

    def peak_bytes(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    leaf = dataclasses.replace(scene, **{f.name: getattr(scene, f.name).detach().clone()
                                         .requires_grad_(True)
                                         for f in dataclasses.fields(scene)})

    def loss_step(render_fn):
        """-> fn(): forward and backward of mean(render_fn(leaf) ** 2)."""
        def step():
            for f in dataclasses.fields(leaf):
                getattr(leaf, f.name).grad = None
            (render_fn(leaf) ** 2).mean().backward()
        return step

    def timed(fn, per=1):
        """fn() by CUDA events (median of N_RENDERS after two warm-ups: the
        device timeline from the first launch to the last, host gaps
        included) and by the profiler (device busy time and kernel launches
        of one more call), each divided by ``per`` -> dict."""
        med, all_ms = frame_ms(fn)
        prof = profile_device(fn, 1, med)
        return {"ms_median": med / per, "ms_all": [t / per for t in all_ms],
                "device_busy_ms": prof["device_busy_ms"] / per, "idle_share": prof["idle_share"],
                "device_kernel_launches": prof["device_kernel_launches"] / per,
                "own_kernels_device_ms": {k: v / per
                                          for k, v in prof["own_kernels_device_ms"].items()}}

    def leaf_grads_ok(what):
        g = {f.name: float(getattr(leaf, f.name).grad.abs().max()) for f in dataclasses.fields(leaf)}
        if not all(math.isfinite(v) and v > 0.0 for v in g.values()):
            raise AssertionError(f"{what}: gradients {g}")
        return g

    def shared_view_rows(d, bins, grid):
        """The instance rows one view composites from shared bins -> (rows,
        tile_start, tile_nblk, the slots of splats the view culls)."""
        splat = bins["inst_splat"].long()
        inst = C.gather_rows(C.pack_src(CL.shared_features(d), grid), splat)
        start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
        n_ = d["mask"].shape[0]
        culled = (splat < n_) & ~d["mask"][splat.clamp_max(n_ - 1)]
        return inst, start, nblk, culled

    def shared_kernels_close(ds, union, grid, views, what, backward=True):
        """B1 on the union table bit for bit against its plain version; B2's
        two launches against theirs for each view of ``views``, and (with
        ``backward``) B3 against composite_bwd_plain for the last of them,
        whose rows of culled splats must get exactly zero in all nine
        columns; each timed at this shape -> the errors, times and shapes."""
        um, ue = union
        depth = ds[0]["depth"]
        table = B.expand_table(um, ue, grid, depth)
        bins = B.bin_splats(um, ue, grid, depth)
        e_args = (table["ends"], table["tile0"], table["nx"], table["dbits"], grid.emax,
                  grid.tiles_x)
        got, want = B.expand_fill(*e_args), B.expand_fill_plain(*e_args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"expand_fill != plain version ({what})")
        out = {"expand_fill_max_abs_err": float((got - want).abs().max()),
               "expand_fill_ms": event_ms(lambda: B.expand_fill(*e_args), 10),
               "emax": grid.emax, "mcap": grid.mcap,
               "filled_slots": int(table["ends"][-1]),
               "num_culled_instances": int(bins["num_culled_instances"]), "views": {}}
        del got, want
        for v in views:
            inst, start, nblk, culled = shared_view_rows(ds[v], bins, grid)
            res = {"rows_of_splats_culled_in_this_view": int(culled.sum()),
                   "deepest_tile_blocks": int(nblk.max()),
                   **check_fwd_passes(inst, start, nblk, grid, f"{what} view {v}"),
                   "composite_fwd_ms": event_ms(lambda: C.composite_fwd(inst, start, nblk, grid),
                                                10)}
            if backward and v == views[-1]:
                fwd, seg = C.composite_fwd(inst, start, nblk, grid, checkpoints=True)
                dout = seeded_cotangent(fwd)
                d_inst = C.composite_bwd(inst, start, nblk, fwd, dout, grid, seg)
                d_ref = C.composite_bwd_plain(inst, start, nblk, fwd, dout, grid)
                torch.cuda.synchronize()
                res["composite_bwd_max_scaled_err"] = grad_cols_close(
                    d_inst, d_ref, f"composite_bwd ({what} view {v})")
                res["composite_bwd_culled_rows_abs_max"] = float(d_inst[:, culled].abs().max()) \
                    if bool(culled.any()) else 0.0
                if res["composite_bwd_culled_rows_abs_max"] != 0.0:
                    raise AssertionError(f"composite_bwd ({what} view {v}): rows of culled "
                                         f"splats got {res['composite_bwd_culled_rows_abs_max']}")
                res["composite_bwd_ms"] = event_ms(
                    lambda: C.composite_bwd(inst, start, nblk, fwd, dout, grid, seg), 10)
                del fwd, seg, dout, d_inst, d_ref
            out["views"][v] = res
            del inst, start, nblk, culled
        return out

    # the stereo pair, symmetric frusta (the shared path needs them), at the
    # garden view: one shared binning against render_batch of the two eyes
    t_phase = time.perf_counter()
    eyes = ST._eye_cameras(cam, STEREO_IPD)
    sym_pair = cam.stereo_pair(STEREO_IPD)
    st_cfg = ST.calibrate_config_stereo(scene, cam, cfg, STEREO_IPD)
    pe_cfg = R.calibrate_config(scene, sym_pair, cfg)
    st_train = dataclasses.replace(st_cfg, forward_only=False)
    pe_train = dataclasses.replace(pe_cfg, forward_only=False)
    with torch.no_grad():
        d_l, d_r, st_um, st_ue = ST.stereo_prepare(scene, cam, cfg, STEREO_IPD)
        st_demand = int(B.instance_demand(st_um, st_ue, tiled._grid_from_config(cfg, n)))
        eye_demand = [int(B.instance_demand(d["mean2d"], d["extent"],
                                            tiled._grid_from_config(cfg, n))) for d in (d_l, d_r)]
        # what the per-view capacity drops on the union
        dropped_per_view_cap = int(B.bin_splats(st_um, st_ue, tiled._grid_from_config(pe_cfg, n),
                                                d_l["depth"])["num_culled_instances"])
    st_imgs, st_launches = counted(lambda: ST.render_stereo(scene, cam, st_cfg, STEREO_IPD))
    want_launches("render_stereo_shared", st_launches, 2, binnings=1)
    if st_imgs.shape != (2, FULL_H, FULL_W, 4) or not bool(torch.isfinite(st_imgs).all()):
        raise AssertionError("render_stereo_shared: wrong shape or non-finite values")
    st_eye_err = [composite_close(st_imgs[e], R.render(scene, eyes[e], pe_cfg),
                                  f"render_stereo_shared: eye {e} against render() of it")
                  for e in range(2)]
    pe_imgs, pe_launches = counted(lambda: R.render_batch(scene, sym_pair, pe_cfg))
    want_launches("render_stereo per eye", pe_launches, 2)
    del st_imgs, pe_imgs
    _, st_bwd_launches = counted(loss_step(lambda p: ST.render_stereo(p, cam, st_train,
                                                                      STEREO_IPD)))
    want_launches("render_stereo_shared backward", st_bwd_launches, 2, backward=True,
                  binnings=1)
    st_grads = leaf_grads_ok("render_stereo_shared backward")
    st_ms = {
        "shared_forward": timed(lambda: ST.render_stereo(scene, cam, st_cfg, STEREO_IPD)),
        "per_eye_forward": timed(lambda: R.render_batch(scene, sym_pair, pe_cfg)),
        "shared_forward_backward": timed(loss_step(
            lambda p: ST.render_stereo(p, cam, st_train, STEREO_IPD))),
        "per_eye_forward_backward": timed(loss_step(
            lambda p: R.render_batch(p, sym_pair, pe_train)))}
    st_peak = {
        "shared_forward": peak_bytes(lambda: ST.render_stereo(scene, cam, st_cfg, STEREO_IPD)),
        "per_eye_forward": peak_bytes(lambda: R.render_batch(scene, sym_pair, pe_cfg)),
        "shared_forward_backward": peak_bytes(loss_step(
            lambda p: ST.render_stereo(p, cam, st_train, STEREO_IPD))),
        "per_eye_forward_backward": peak_bytes(loss_step(
            lambda p: R.render_batch(p, sym_pair, pe_train)))}
    # the production profile, forward only: packed_colors' i32x8 rows carry
    # the culled rows too
    prod_base = R.apply_profile(base, "production")
    st_prod = ST.calibrate_config_stereo(scene, cam, prod_base, STEREO_IPD)
    pe_prod = R.calibrate_config(scene, sym_pair, prod_base)
    st_prod_imgs, st_prod_launches = counted(
        lambda: ST.render_stereo(scene, cam, st_prod, STEREO_IPD))
    want_launches("render_stereo_shared production", st_prod_launches, 2, binnings=1)
    st_prod_grid = tiled._grid_from_config(st_prod, n)
    st_prod_vs_eye = {"max_abs": [], "mean_abs": []}
    for e in range(2):
        eye_img = R.render(scene, eyes[e], pe_prod)
        st_prod_vs_eye["max_abs"].append(composite_close(
            st_prod_imgs[e], eye_img, f"render_stereo_shared production: eye {e} against "
            f"render() of it", is_bf16(st_prod_grid)))
        st_prod_vs_eye["mean_abs"].append(float((st_prod_imgs[e] - eye_img).abs().mean()))
        del eye_img
    del st_prod_imgs
    st_prod_ms = {
        "shared_forward": timed(lambda: ST.render_stereo(scene, cam, st_prod, STEREO_IPD)),
        "per_eye_forward": timed(lambda: R.render_batch(scene, sym_pair, pe_prod))}
    t_check = time.perf_counter()
    with torch.no_grad():
        st_kernels = shared_kernels_close((d_l, d_r), (st_um, st_ue),
                                          tiled._grid_from_config(st_cfg, n), [0, 1],
                                          "render_stereo_shared union")
        # the production path's shapes: i32x8 rows, the 20-bit key and the
        # early stop on the union lists (forward only, as that path runs)
        st_prod_kernels = shared_kernels_close((d_l, d_r), (st_um, st_ue), st_prod_grid,
                                               [0, 1], "render_stereo_shared production union",
                                               backward=False)
    st_check_s = time.perf_counter() - t_check
    for res in (st_kernels, st_prod_kernels):
        if res["num_culled_instances"] != 0:
            raise AssertionError(f"render_stereo_shared: {res['num_culled_instances']} "
                                 f"instances dropped under the union calibration")
    del d_l, d_r, st_um, st_ue

    def capacity(c, demand):
        return {"max_instance_mult": c.max_instance_mult,
                "emax": tiled._grid_from_config(c, n).emax, "filled_slots": demand,
                "instances_per_splat": demand / n}

    emit({"phase": "render_stereo_shared", "splats": n, "width": FULL_W, "height": FULL_H,
          "ipd": STEREO_IPD, "frusta": "symmetric",
          "per_pair": st_ms, "production_per_pair": st_prod_ms,
          "capacity_shared": capacity(st_cfg, st_demand),
          "capacity_per_eye": capacity(pe_cfg, max(eye_demand)),
          "eye_demands": eye_demand,
          "instances_dropped_on_the_union_by_the_per_eye_capacity": dropped_per_view_cap,
          "eyes_max_abs_err_vs_render_of_the_eye": st_eye_err,
          "production_eyes_vs_render_of_the_eye": st_prod_vs_eye,
          "launches": {"shared": st_launches, "per_eye": pe_launches,
                       "shared_backward": st_bwd_launches,
                       "shared_production": st_prod_launches},
          "peak_memory_bytes": st_peak, "grad_abs_max": st_grads,
          "kernels_at_union": st_kernels, "kernels_at_production_union": st_prod_kernels,
          "kernel_check_seconds": st_check_s,
          "phase_seconds": time.perf_counter() - t_phase,
          "device": kind, "nvidia_smi_name_power_limit": smi})

    # a cluster of CLUSTER_VIEWS path views CLUSTER_STEP rad apart on the
    # garden orbit: per-view rendering, clusters of 2 and one cluster of 4
    t_phase = time.perf_counter()
    cl_list = [R.Camera.from_fov(
        T.look_at(eye=[4.2 * math.cos(a), 1.6, 4.2 * math.sin(a)], target=[0.0, 0.8, 0.0],
                  up=[0.0, 1.0, 0.0]), fovy=np.pi / 4, width=FULL_W, height=FULL_H, device=dev)
        for a in CLUSTER_STEP * np.arange(CLUSTER_VIEWS)]
    cl_cams = R.Camera(cam_to_world=torch.stack([c.cam_to_world for c in cl_list]),
                       proj=torch.stack([c.proj for c in cl_list]))
    pv_cfg = R.calibrate_config(scene, cl_cams, cfg)
    pv_imgs, pv_launches = counted(lambda: R.render_batch(scene, cl_cams, pv_cfg))
    want_launches("render_cluster per view", pv_launches, CLUSTER_VIEWS)
    with torch.no_grad():
        pv_demand = max(int(B.instance_demand(d["mean2d"], d["extent"],
                                              tiled._grid_from_config(cfg, n)))
                        for d in (R.prepare_splats(scene, c, cfg, sort=False) for c in cl_list))
    cl_ms = {"per_view_forward": timed(lambda: R.render_batch(scene, cl_cams, pv_cfg),
                                       CLUSTER_VIEWS),
             "per_view_forward_backward": timed(loss_step(lambda p: R.render_batch(
                 p, cl_cams, dataclasses.replace(pv_cfg, forward_only=False))), CLUSTER_VIEWS)}
    cl_out = {"capacity_per_view": capacity(pv_cfg, pv_demand)}
    cl_launches = {"per_view": pv_launches}
    k_kernels = {}
    for k in (2, 4):
        k_cfg = CL.calibrate_config_cluster(scene, cl_cams, cfg, cluster_size=k)
        k_train = dataclasses.replace(k_cfg, forward_only=False)

        def shared(p, c, k=k):
            return CL.render_path_clustered(p, cl_cams, c, cluster_size=k, max_depth_shift=None)

        imgs, launches = counted(lambda: shared(scene, k_cfg))
        want_launches(f"render_cluster k={k}", launches, CLUSTER_VIEWS,
                      binnings=CLUSTER_VIEWS // k)
        if imgs.shape != pv_imgs.shape or not bool(torch.isfinite(imgs).all()):
            raise AssertionError(f"render_cluster k={k}: wrong shape or non-finite values")
        # each cluster's reference view is order-exact; the others are an
        # approximation, printed and not held
        ref_err = [composite_close(imgs[v], pv_imgs[v], f"render_cluster k={k}: view {v}")
                   for v in range(0, CLUSTER_VIEWS, k)]
        diff = (imgs - pv_imgs).abs()
        del imgs
        _, bwd_launches = counted(loss_step(lambda p: shared(p, k_train)))
        want_launches(f"render_cluster k={k} backward", bwd_launches, CLUSTER_VIEWS,
                      backward=True, binnings=CLUSTER_VIEWS // k)
        grads = leaf_grads_ok(f"render_cluster k={k} backward")
        with torch.no_grad():
            demands, dropped = [], 0
            for c0 in range(0, CLUSTER_VIEWS, k):
                sub = R.Camera(cl_cams.cam_to_world[c0:c0 + k], cl_cams.proj[c0:c0 + k])
                ds, um, ue = CL.prepare_cluster(scene, sub, cfg)
                demands.append(int(B.instance_demand(um, ue, tiled._grid_from_config(cfg, n))))
                dropped += int(B.bin_splats(um, ue, tiled._grid_from_config(k_cfg, n),
                                            ds[0]["depth"])["num_culled_instances"])
                if c0 == 0:  # the first cluster's union: its last view's rows
                    behind_live = int(((ds[0]["depth"] <= 0.0)
                                       & torch.stack([d["mask"] for d in ds[1:]]).any(0)).sum())
                    t_check = time.perf_counter()
                    k_kernels[k] = shared_kernels_close(
                        ds, (um, ue), tiled._grid_from_config(k_cfg, n), [k - 1],
                        f"render_cluster k={k} union")
                    k_kernels[k]["splats_behind_view_0_live_in_another"] = behind_live
                    k_kernels[k]["seconds"] = time.perf_counter() - t_check
                del ds, um, ue
        if dropped != 0:
            raise AssertionError(f"render_cluster k={k}: {dropped} instances dropped under the "
                                 f"union calibration")
        cl_ms[f"k{k}_forward"] = timed(lambda: shared(scene, k_cfg), CLUSTER_VIEWS)
        cl_ms[f"k{k}_forward_backward"] = timed(loss_step(lambda p: shared(p, k_train)),
                                                CLUSTER_VIEWS)
        cl_launches[f"k{k}"], cl_launches[f"k{k}_backward"] = launches, bwd_launches
        cl_out[f"k{k}"] = {"capacity": capacity(k_cfg, max(demands)), "cluster_demands": demands,
                           "num_culled_instances": dropped,
                           "reference_views_max_abs_err": ref_err,
                           "views_max_abs_vs_per_view": diff.amax(dim=(1, 2, 3)).tolist(),
                           "views_mean_abs_vs_per_view": diff.mean(dim=(1, 2, 3)).tolist(),
                           "grad_abs_max": grads}
        del diff
    # rows of splats culled in the view: the garden view's pair and the
    # cluster above carry none (a splat culled in one view has its rect
    # outside the image there, beyond the guard band), so two opposite
    # orbit views are binned together (view 0 culls what lies behind it, and
    # carries its negative depth into the shared key), at the mid size (at
    # full size their union rects would span the image), in each row layout
    t_check = time.perf_counter()
    culled_kernels = {}
    mid_scene = make_garden_scene(40_000, seed=0, device=dev)
    opposite = garden_cameras(2, width=320, height_px=192, device=dev)
    opp_cfg = CL.calibrate_config_cluster(mid_scene, opposite, mid_cfg, cluster_size=2)
    with torch.no_grad():
        ds, um, ue = CL.prepare_cluster(mid_scene, opposite, opp_cfg)
        behind_live = int(((ds[0]["depth"] <= 0.0) & ds[1]["mask"]).sum())
        for layout, knobs in LAYOUT_KNOBS.items():
            res = shared_kernels_close(
                ds, (um, ue), tiled._grid_from_config(dataclasses.replace(opp_cfg, **knobs),
                                                      mid_scene.num_gaussians),
                [0], f"opposite views 320x192 {layout}")
            if res["views"][0]["rows_of_splats_culled_in_this_view"] == 0 or not behind_live:
                raise AssertionError("opposite views: no rows of splats culled in view 0")
            culled_kernels[layout] = res
    culled_kernels["splats_behind_view_0_live_in_view_1"] = behind_live
    culled_kernels["seconds"] = time.perf_counter() - t_check
    del ds, um, ue, mid_scene
    # the default gate ("auto": 0.5 % of the content radius) on these steps
    r_scale = CL.scene_depth_scale(scene)
    gate = [CL.cluster_shareable(R.Camera(cl_cams.cam_to_world[c0:c0 + k],
                                          cl_cams.proj[c0:c0 + k]), 0.005 * r_scale, r_scale)
            for k in (2, 4) for c0 in range(0, CLUSTER_VIEWS, k)]
    auto_imgs = CL.render_path_clustered(scene, cl_cams, pv_cfg, cluster_size=4)
    auto_equal = bool(torch.equal(auto_imgs, pv_imgs))
    if not any(gate) and not auto_equal:
        raise AssertionError("render_path_clustered: the gate refused every cluster, and the "
                             "path differs from render_batch")
    del auto_imgs, pv_imgs, leaf
    emit({"phase": "render_cluster", "splats": n, "width": FULL_W, "height": FULL_H,
          "views": CLUSTER_VIEWS, "step_rad": CLUSTER_STEP,
          "per_view": cl_ms, **cl_out,
          "launches": cl_launches, "kernels_at_k2_union": k_kernels[2],
          "kernels_at_k4_union": k_kernels[4],
          "kernels_with_culled_rows": culled_kernels,
          "auto_gate": {"scene_depth_scale": r_scale, "max_depth_shift": 0.005 * r_scale,
                        "shares_k2_clusters": gate[:2], "shares_k4_cluster": gate[2],
                        "render_path_clustered_equals_render_batch": auto_equal},
          "phase_seconds": time.perf_counter() - t_phase,
          "device": kind, "nvidia_smi_name_power_limit": smi})
    for row in kernel_rows[:3]:  # B1, B2 and B3 (f32x16) on the shared paths
        counter = row["name"]
        for path, counts in (("render_stereo_shared", st_launches),
                             ("render_stereo_shared_backward", st_bwd_launches),
                             ("render_cluster_k2", cl_launches["k2"]),
                             ("render_cluster_k2_backward", cl_launches["k2_backward"]),
                             ("render_cluster_k4", cl_launches["k4"]),
                             ("render_cluster_k4_backward", cl_launches["k4_backward"])):
            row["launches_by_path"][path] = sum(counts[c] for c in KERNEL_COUNTERS[counter])
    # B1 and B2[i32x8] on the production shared-stereo path, and their errors
    # at its shapes
    for row in kernel_rows:
        counter = {"expand_fill": "expand_fill", "composite_fwd[i32x8]": "composite_fwd"}.get(
            row["name"])
        if counter is not None:
            row["launches_by_path"]["render_stereo_shared_production"] = sum(
                st_prod_launches[c] for c in KERNEL_COUNTERS[counter])
            row["max_abs_err_at_render_stereo_shared_production_shapes"] = (
                st_prod_kernels["expand_fill_max_abs_err"] if counter == "expand_fill" else
                max(res[e] for res in st_prod_kernels["views"].values()
                    for e in ("segments_max_abs_err", "combine_max_abs_err") if e in res))

    # ---- phase 6c: multi-device tile bands, every rank's band run in turn in
    # this process (parallel/mesh.py's band functions, which the ranks run)
    t_phase = time.perf_counter()
    exact_fwd = R.apply_profile(base, "exact")
    view_cfg = R.calibrate_config(scene, views, exact_fwd)
    band_cfgs = {(d, lay): PM.calibrate_config_sharded(scene, views, exact_fwd, {"tiles": d},
                                                       band_layout=lay)
                 for d in MESH_SHARDS for lay in BAND_LAYOUTS}
    with torch.no_grad():
        prepared = [R.prepare_splats(scene, v, exact_fwd, sort=False) for v in view_list]
        # [view][rank] demands; the interleaved bands' sum is the demand of
        # the full grid at the padded height
        band_demands = {(d, lay): [PM.band_instance_demands(scene, v, exact_fwd, d, lay).tolist()
                                   for v in view_list]
                        for d in (2, 4, 8) for lay in BAND_LAYOUTS}
        view_demands = [int(B.instance_demand(sp["mean2d"], sp["extent"],
                                              tiled._grid_from_config(exact_fwd, n)))
                        for sp in prepared]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        band_imgs = {}
        for (d, lay), c in band_cfgs.items():
            for vi, sp in enumerate(prepared):
                bands = torch.cat([PM._band_fn(lay)(sp, r, d, c) for r in range(d)])
                if lay == "interleaved":
                    bands = PM._deinterleave_rows(bands, c, d)
                band_imgs[(d, lay, vi)] = bands[:FULL_H]
        torch.cuda.synchronize()
        bands_launches = dict(kernels.LAUNCH_COUNTS)
        n_bands = len(view_list) * len(BAND_LAYOUTS) * sum(MESH_SHARDS)
        want_launches("mesh_bands", bands_launches, n_bands)
        band_err, band_capacity = {}, {}
        for vi, v in enumerate(view_list):
            whole = R.render(scene, v, view_cfg)
            for (d, lay), c in band_cfgs.items():
                key = f"{lay} D={d} view {vi}"
                img = band_imgs.pop((d, lay, vi))
                band_err[key] = composite_close(img, whole, f"mesh_bands: {key} against render")
                # the interleaved bands keep the image's tiles and pixel
                # coordinates: render's own rows
                if lay == "interleaved" and not torch.equal(img, whole):
                    raise AssertionError(f"mesh_bands: {key} is not render's image bit for bit")
            del whole
        for (d, lay), c in band_cfgs.items():
            # bin_splats drops instances exactly when a band's demand exceeds
            # emax (the farthest splats first): none may
            peak = max(max(per_view) for per_view in band_demands[(d, lay)])
            emax = tiled._grid_from_config(c, n).emax
            band_capacity[f"{lay} D={d}"] = {"max_instance_mult": c.max_instance_mult,
                                             "emax": emax, "peak_band_demand": peak}
            if peak > emax:
                raise AssertionError(f"mesh_bands: {lay} D={d} drops instances: {peak} > {emax}")
    # B1, B2 and B3 at rank 0's band of D=4, interleaved, view 0: against their
    # plain versions, timed, with their bounds
    c4 = band_cfgs[(4, "interleaved")]
    t_check = time.perf_counter()
    mesh_rows, mesh_extra = composite_rows(c4, None, exact_tables=True,
                                           at=(scene, view_list[0]), band=(4, 0))
    # what the tiles of the other ranks cost: the same grid with no block in
    # any tile (every CTA of the full grid launched, none with work)
    grid4, _, _, inst4, st4, nb4 = kernel_inputs(scene, view_list[0], c4, 4, 0,
                                                 PM._band_grid(c4, n, 4))
    none = torch.zeros_like(nb4)
    locs4 = C.composite_fwd_segments(inst4, st4, none, grid4)
    empty_tiles = {"tiles": grid4.num_tiles, "tiles_owned": grid4.num_tiles // 4,
                   "segment_ctas_launched": C.num_segments_cap(grid4),
                   "segments_kernel_ms_no_block_anywhere": event_ms(
                       lambda: C.composite_fwd_segments(inst4, st4, none, grid4), 10),
                   "combine_kernel_ms_no_block_anywhere": event_ms(
                       lambda: C.combine_segments(locs4, inst4, st4, none, grid4), 10),
                   "band_ms_by_launch": mesh_rows[1]["ms_by_launch"]}
    del grid4, inst4, st4, nb4, none, locs4
    mesh_check_s = time.perf_counter() - t_check
    # gradients: one band a rank, forward and backward, summed over the ranks
    # (D=2), against the unsharded step of view 0
    start_m = make_train_start()
    exact_train = dataclasses.replace(exact_fwd, forward_only=False)
    view0 = view_list[0]
    tgt0 = R.render(scene, view0, R.calibrate_config(scene, view0, exact_train))
    ref_leaf = train.leaf_copy(start_m)
    ref_loss = float(train._batch_value_and_grad(ref_leaf, view0, tgt0[None], R.calibrate_config(
        start_m, view0, exact_train)))
    ref_grads = {f.name: getattr(ref_leaf, f.name).grad for f in dataclasses.fields(ref_leaf)}
    del ref_leaf
    band_grads = {}
    for lay in BAND_LAYOUTS:
        c2 = PM.calibrate_config_sharded(start_m, view0, exact_train, {"tiles": 2},
                                         band_layout=lay)
        tb = PM.shard_targets(tgt0[None], c2, {"tiles": 2}, lay)[0]
        band_h = tb.shape[0] // 2
        leaf_m = train.leaf_copy(start_m)
        loss_m = 0.0
        for r in range(2):
            lr_ = PM.band_loss(R.prepare_splats(leaf_m, view0, c2, sort=False),
                               tb[r * band_h:(r + 1) * band_h], r, 2, c2, lay,
                               FULL_H * FULL_W * 4)
            lr_.backward()
            loss_m += float(lr_.detach())
        if not abs(loss_m - ref_loss) <= 1e-5 * ref_loss:
            raise AssertionError(f"mesh_bands: {lay} D=2 loss {loss_m} against {ref_loss}")
        band_grads[lay] = {"loss": loss_m, "reference_loss": ref_loss,
                           "grad_max_scaled_err": scaled_grad_errs(
                               leaf_m, ref_grads, f"mesh_bands: {lay} D=2 gradients",
                               allow=2e-2 if lay == "contiguous" else 2e-4)}
        del leaf_m
    del start_m, ref_grads, tgt0
    # balance: peak over mean band demand; each rank's device busy time
    balance = {f"{lay} D={d}": [max(pv) / statistics.mean(pv) for pv in band_demands[(d, lay)]]
               for (d, lay) in band_demands}
    with torch.no_grad():
        busy = {"unsharded_frame": timed(lambda: R.render(scene, view0, view_cfg)),
                "prepare_splats": timed(
                    lambda: R.prepare_splats(scene, view0, exact_fwd, sort=False))}
        for d in MESH_SHARDS:
            chunk = -(-n // d)
            part = PM._LocalRows(scene, 0, chunk)
            busy[f"prepare_splats of N/{d}"] = timed(
                lambda: R.prepare_splats(part, view0, exact_fwd, sort=False))
            for lay in BAND_LAYOUTS:
                c = band_cfgs[(d, lay)]
                for r in range(d):
                    busy[f"{lay} D={d} band {r}"] = timed(
                        lambda: PM._band_fn(lay)(prepared[0], r, d, c))
            del part
        per_rank = {}
        for d in MESH_SHARDS:
            for lay in BAND_LAYOUTS:
                bands_ms = [busy[f"{lay} D={d} band {r}"]["device_busy_ms"] for r in range(d)]
                per_rank[f"{lay} D={d}"] = {
                    "shard_prepare_off": [busy["prepare_splats"]["device_busy_ms"] + b
                                          for b in bands_ms],
                    "shard_prepare_on_without_the_gather": [
                        busy[f"prepare_splats of N/{d}"]["device_busy_ms"] + b for b in bands_ms]}
    del prepared
    emit({"phase": "mesh_bands", "splats": n, "views": len(view_list), "width": FULL_W,
          "height": FULL_H, "profile": "exact", "shards": list(MESH_SHARDS),
          "padded_heights": {d: PM._padded_height(exact_fwd, d) for d in (2, 4, 8)},
          "launches": bands_launches, "max_abs_err_vs_render": band_err,
          "capacity": band_capacity, "view_capacity": {
              "max_instance_mult": view_cfg.max_instance_mult,
              "emax": tiled._grid_from_config(view_cfg, n).emax, "view_demands": view_demands},
          "band_demands": {f"{lay} D={d}": v for (d, lay), v in band_demands.items()},
          "band_demand_peak_over_mean_by_view": balance,
          "kernels_at_d4_rank0_band": {r["name"]: r for r in mesh_rows},
          "kernels_at_d4_rank0_band_extra": mesh_extra, "empty_tiles_d4": empty_tiles,
          "kernel_check_seconds": mesh_check_s, "d2_band_gradients": band_grads,
          "device_busy_ms": {k: v["device_busy_ms"] for k, v in busy.items()},
          "busy_ms_per_rank": per_rank,
          "phase_seconds": time.perf_counter() - t_phase,
          "device": kind, "nvidia_smi_name_power_limit": smi})
    for row, mrow in zip(kernel_rows[:3], mesh_rows):
        row["launches_by_path"]["mesh_bands"] = sum(bands_launches[c]
                                                    for c in KERNEL_COUNTERS[row["name"]])
        row["at_mesh_band_d4_rank0"] = {
            k: mrow[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape")}

    # ---- phase 6d: the torch.distributed path in spawned ranks (mesh_dist):
    # two ranks sharing this card over gloo, one rank over NCCL (torchrun's
    # --nproc-per-node 1), and NCCL over several cards where there are
    t_phase = time.perf_counter()
    mesh_worlds = [("gloo", 2, [(1, 2), (2, 1)]), ("nccl", 1, [(1, 1)])]
    if torch.cuda.device_count() >= 2:
        k = min(torch.cuda.device_count(), 4)
        mesh_worlds.append(("nccl", k, [(1, k)] + ([(2, k // 2)] if k == 4 else [])))
    dist_out = {}
    for backend, world, meshes in mesh_worlds:
        results, secs = run_world(world, backend, meshes)
        for r, res in enumerate(results):
            for m in meshes:
                key = f"{m[0]}x{m[1]}"
                if (res[key]["zero_fit_losses"] != results[0][key]["zero_fit_losses"]
                        or res[key]["step_loss"] != results[0][key]["step_loss"]):
                    raise AssertionError(f"mesh_dist {backend}: rank {r} disagrees with rank 0")
        dist_out[f"{backend}, {world} rank(s)"] = {"seconds": secs, "ranks": results}
    # the in-backward SH all-reduce, per world, mesh and rank: the
    # collectives issued a step, the compute left after the issue; A / B / C
    # on two ranks sharing this card (a mechanism check: one card cannot show
    # overlap across cards)
    sh_allreduce, overlap = {}, {}
    for label, out in dist_out.items():
        for r, res in enumerate(out["ranks"]):
            for key, m in res.items():
                if not (isinstance(m, dict) and "launches" in m):
                    continue
                sh_allreduce[f"{label}, mesh {key}, rank {r}"] = {
                    k: m[k] for k in ("sh_allreduces_issued_collectives_per_step",
                                      "sh_allreduce_issue_to_backward_end_ms")}
                if m["overlap"] is not None:
                    overlap[f"{label}, mesh {key}, rank {r}"] = m["overlap"]
    if not overlap:
        raise AssertionError("mesh_dist: no overlap measurement was made")
    emit({"phase": "mesh_dist", "splats": n, "views": TRAIN_VIEWS, "width": FULL_W,
          "height": FULL_H, "profile": "exact", "steps": MESH_STEPS,
          "worlds_run": [f"{b}: {w} rank(s), meshes {m}" for b, w, m in mesh_worlds],
          "sh_allreduce": sh_allreduce,
          "overlap_mechanism_check": {
              "what": "tools/profile_overlap.measure_overlap: A full step, B no collective, "
                      "C collectives alone, overlap (B + C - A) / C, the prepare "
                      "replicated, on two gloo ranks sharing one card (a one-rank NCCL "
                      "world runs no collective)",
              "by_rank": overlap},
          "worlds": dist_out, "phase_seconds": time.perf_counter() - t_phase,
          "device": kind, "nvidia_smi_name_power_limit": smi})
    for row in kernel_rows[:3]:
        for label, out in dist_out.items():
            row["launches_by_path"][f"mesh_dist ({label}), all ranks"] = sum(
                res[key]["launches"][c] for res in out["ranks"] for key in res
                if isinstance(res[key], dict) and "launches" in res[key]
                for c in KERNEL_COUNTERS[row["name"]])

    # ---- phase 7: output checks on small inputs
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
    del mid

    # ---- phase 8: the global pipeline, picked by pipeline="auto" below 4096
    # splats, at the default 1024x768 window
    from splatapult_tpu_torch.reference.raster import reference_render

    small = make_garden_scene(GLOBAL_SPLATS, seed=0, device=dev)
    g_cfg = R.RenderConfig()  # 1024x768, pipeline="auto"
    g_cam = garden_cameras(1, width=g_cfg.width, height_px=g_cfg.height, device=dev)
    g_img, g_launches = counted(lambda: R.render(small, g_cam, g_cfg))
    if any(g_launches.values()):
        raise AssertionError(f"render_global: pipeline='auto' launched tiled kernels {g_launches}")
    if g_img.shape != (768, 1024, 4) or float(g_img[..., 3].max()) <= 0.5:
        raise AssertionError("render_global: wrong shape or an empty frame")
    g_ms, g_all = frame_ms(lambda: R.render(small, g_cam, g_cfg))
    tiled_cfg = R.calibrate_config(small, g_cam, dataclasses.replace(g_cfg, pipeline="tiled"))
    g_tiled = R.render(small, g_cam, tiled_cfg)
    g_vs_tiled = composite_close(g_img, g_tiled, "render_global against the tiled pipeline")
    g_vs_tiled_mean = float((g_img - g_tiled).abs().mean())
    del g_img, g_tiled

    def at_size(size):
        c = R.RenderConfig(width=size, height=size)
        return c, garden_cameras(1, width=size, height_px=size, device=dev)

    c256, cam256 = at_size(256)
    img256 = R.render(small, cam256, c256).cpu()
    small_cpu, cam256_cpu = small.to("cpu"), cam256.to("cpu")
    g_vs_cpu = composite_close(img256, R.render(small_cpu, cam256_cpu, c256),
                               "render_global: GPU against CPU at 256x256")
    want64 = reference_render(*(getattr(small_cpu, f.name).numpy()
                                for f in dataclasses.fields(small_cpu)),
                              cam256_cpu.cam_to_world.numpy(), cam256_cpu.proj.numpy(), 256, 256)
    diff64 = np.abs(img256.numpy().astype(np.float64) - want64)
    g_vs_ref = {"mean": float(diff64.mean()), "q99.5": float(np.quantile(diff64, 0.995)),
                "max": float(diff64.max())}
    if not (g_vs_ref["mean"] < 5e-5 and g_vs_ref["q99.5"] < 1e-4 and g_vs_ref["max"] < 0.05):
        raise AssertionError(f"render_global against the float64 oracle: {g_vs_ref}")

    def global_grads(scene_g, cam_g, cfg_g):
        p = dataclasses.replace(scene_g, **{f.name: getattr(scene_g, f.name).detach().clone()
                                            .requires_grad_(True)
                                            for f in dataclasses.fields(scene_g)})
        target = torch.full((cfg_g.height, cfg_g.width, 4), 0.25, device=p.means.device)
        ((R.render(p, cam_g, cfg_g) - target) ** 2).mean().backward()
        return {f.name: getattr(p, f.name).grad for f in dataclasses.fields(p)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (g_grads, g_bwd_launches) = counted(lambda: global_grads(small, g_cam, g_cfg))
    g_bwd_peak = torch.cuda.max_memory_allocated()
    g_grad_max = {k: float(v.abs().max()) for k, v in g_grads.items()}
    if not all(math.isfinite(v) and v > 0.0 for v in g_grad_max.values()):
        raise AssertionError(f"render_global backward: gradients {g_grad_max}")
    if any(g_bwd_launches.values()) or not g_bwd_peak <= GLOBAL_BWD_PEAK_BYTES:
        raise AssertionError(f"render_global backward: launches {g_bwd_launches}, peak memory "
                             f"{g_bwd_peak} B (bound {GLOBAL_BWD_PEAK_BYTES})")
    g_bwd_ms, _ = event_ms_once(lambda: global_grads(small, g_cam, g_cfg))
    del g_grads
    c128, cam128 = at_size(128)
    got128 = global_grads(small, cam128, c128)
    want128 = global_grads(small_cpu, cam128.to("cpu"), c128)
    g_grad_err = {}
    for k, w in want128.items():
        scale = float(w.abs().max())
        g_grad_err[k] = float((got128[k].cpu() - w).abs().max()) / max(scale, 1e-30)
        if not (scale > 0.0 and g_grad_err[k] <= 2e-4):
            raise AssertionError(f"render_global gradients at 128x128, GPU against CPU: "
                                 f"{k} {g_grad_err[k]} of {scale}")
    emit({"phase": "render_global", "splats": GLOBAL_SPLATS, "width": g_cfg.width,
          "height": g_cfg.height, "pipeline": "auto -> global", "block_size": g_cfg.block_size,
          "ms_per_frame_median": g_ms, "ms_per_frame_all": g_all, "launches": g_launches,
          "max_abs_err_vs_tiled": g_vs_tiled, "mean_abs_err_vs_tiled": g_vs_tiled_mean,
          "max_abs_err_vs_cpu_256": g_vs_cpu, "vs_float64_oracle_256": g_vs_ref,
          "backward_ms": g_bwd_ms, "backward_peak_memory_bytes": g_bwd_peak,
          "backward_peak_bound_bytes": GLOBAL_BWD_PEAK_BYTES, "grad_abs_max": g_grad_max,
          "grad_max_scaled_err_vs_cpu_128": g_grad_err,
          "device": kind, "nvidia_smi_name_power_limit": smi})
    del small, small_cpu

    # ---- phase 9: the CLI
    from splatapult_tpu_torch.cli import _orbit_rig
    from splatapult_tpu_torch.io.gaussians import load_gaussian_ply, save_gaussian_ply
    from splatapult_tpu_torch.utils.image import load_png

    with tempfile.TemporaryDirectory() as tmp:
        ply, png = os.path.join(tmp, "garden.ply"), os.path.join(tmp, "garden.png")
        size = ["--width", "640", "--height", "384"]

        cli_in_process(["synth", "garden", "--splats", "20000", "-o", ply])
        # the module's entry point in a process of its own, once; the other
        # commands run in this process (a process takes seconds to reach
        # the card)
        subprocess.run([sys.executable, "-m", "splatapult_tpu_torch.cli", "render", ply, "-o", png,
                        *size, "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0"],
                       cwd=ROOT, check=True, timeout=600, stdout=subprocess.DEVNULL)
        png_bytes = os.path.getsize(png)
        if png_bytes <= 0:
            raise AssertionError("cli render wrote an empty PNG")
        if load_png(png).shape != (384, 640, 3):
            raise AssertionError("cli render wrote a PNG of the wrong size")
        packed_png = os.path.join(tmp, "packed.png")
        cli_in_process(["render", ply, "-o", packed_png, *size, "--packed-colors", "--fp16",
                        "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0"])
        packed_diff = float(np.abs(load_png(packed_png) - load_png(png)).max())
        if not packed_diff <= 0.05:
            raise AssertionError(f"cli render --packed-colors --fp16: {packed_diff} from the "
                                 f"exact PNG")
        bench_line = json.loads(cli_in_process(
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
            cli_in_process(["render", ply, "-o", os.path.join(tmp, f"target{i}.png"), *size,
                            "--eye", *eye, "--target", *center])
        dim_ply, fitted_ply = os.path.join(tmp, "dim.ply"), os.path.join(tmp, "fitted.ply")
        save_gaussian_ply(dim_ply, dataclasses.replace(small, sh=small.sh * 0.8))
        fit_line = json.loads(cli_in_process(
            ["fit", dim_ply, "--targets", os.path.join(tmp, "target*.png"), "-o", fitted_ply,
             "--steps", "5"]).strip().splitlines()[-1])
        if (fit_line["steps"], fit_line["views"], fit_line["splats"]) != (5, 2, 20000):
            raise AssertionError(f"cli fit: {fit_line}")
        if not (math.isfinite(fit_line["loss_last"])
                and fit_line["loss_last"] < fit_line["loss_first"]):
            raise AssertionError(f"cli fit: loss did not fall: {fit_line}")
        if load_gaussian_ply(fitted_ply, device="cpu").num_gaussians != 20000:
            raise AssertionError("cli fit wrote a .ply of the wrong size")
        scene_json = cli_with_cameras_json(tmp, small)
    emit({"phase": "cli", "png_bytes": png_bytes, "packed_fp16_png_max_abs_diff": packed_diff,
          "bench_production_ms_per_frame": bench_line["ms_per_frame"],
          "fit": {k: fit_line[k] for k in ("steps", "views", "loss_first", "loss_last",
                                           "seconds")},
          "with_cameras_json": scene_json})

    emit({"kernels": kernel_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
