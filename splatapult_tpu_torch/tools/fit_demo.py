"""Training at length: fit a perturbed garden scene to rendered targets and
write the evidence — the port's counterpart of the JAX repo's
``tools/fit_demo.py``, with the same flags and defaults.

What it does:
 1. builds the garden stand-in (io/synth.py) at --splats and renders --views
    targets at --width x --height from the TRUE scene (production profile,
    the capacity calibrated once for the whole orbit);
 2. perturbs the means (0.35 % of the 99th-percentile radius), SH, opacities
    and log-scales with one numpy Generator, drawn in the JAX tool's order,
    so both tools start from the same scene;
 3. fits --steps // 2 steps (train.fit_scene, Adam at the per-field rates of
    train.LR_SCALE: means x0.1, sh x1, opacities x1, log_scales x0.5, quats
    x0.1), saves the scene, reloads it and checks every field equal, deletes
    the file, and fits the rest with a FRESH optimizer, as the JAX tool does;
    or, with --adaptive, runs densify.fit_scene_adaptive for --steps steps
    with a densify event every 100 steps (DensifyConfig() defaults)
    and records each event: its step, the splats after it, ``emax`` and its
    ms, the instances dropped at every chunk's start and at the end, and the
    share of the wall time spent in events;
 4. writes before.png / target.png / after.png (box-downsampled 4x) and
    loss_curve.json: the losses, (adaptive) the events, and a summary with
    the JAX tool's keys plus the device, the card's name and power limit
    (nvidia-smi) and the peak device memory.

Losses are read back once per chunk of steps, never per step. Step and event
times are marks on the device's timeline: CUDA events on a GPU (recorded by
an optimizer step hook and the ``on_event`` callback; no synchronisation),
the host clock on the CPU.

Usage (the committed runs are the first two; each runs on the GPU and raises
without one unless --device cpu is given):
  python -m splatapult_tpu_torch.tools.fit_demo   # 200k splats, 8 views, 1080p, 240 steps
  python -m splatapult_tpu_torch.tools.fit_demo --adaptive --steps 1000 \\
      --out artifacts/fit_demo_torch/adaptive
  python -m splatapult_tpu_torch.tools.fit_demo --tiny --device cpu --out /tmp/fd
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from splatapult_tpu_torch import densify as densify_mod
from splatapult_tpu_torch import train
from splatapult_tpu_torch._device import resolve_device
from splatapult_tpu_torch.cli import gpu_name_and_power_limit
from splatapult_tpu_torch.io.checkpoint import load_scene_npz, save_scene_npz
from splatapult_tpu_torch.io.gaussians import GaussianScene
from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
from splatapult_tpu_torch.ops.binning import bin_splats
from splatapult_tpu_torch.ops.tiled import _grid_from_config
from splatapult_tpu_torch.render import (
    Camera,
    RenderConfig,
    apply_profile,
    calibrate_config,
    prepare_splats,
    render,
    render_batch,
)
from splatapult_tpu_torch.utils.image import save_png

_FIELDS = ("means", "sh", "opacities", "log_scales", "quats")
DENSIFY_EVERY = 100  # --adaptive: steps between two densify events


class _Clock:
    """Marks on the device's timeline: CUDA events on a GPU (read only after
    the run, with one synchronisation), the host clock on the CPU, where
    every operation has finished when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.name = "cuda_events" if self.cuda else "host_clock"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def _perturbed(true_scene, rng: np.random.Generator):
    """The JAX tool's start: seeded noise on means (0.35 % of the scene's
    99th-percentile radius), sh, opacities and log_scales, drawn in that
    order from ``rng`` and each cast to float32."""
    means = true_scene.means.cpu().numpy()
    radius = float(np.percentile(np.linalg.norm(means - means.mean(0), axis=1), 99.0))
    sigmas = (("means", 0.0035 * radius), ("sh", 0.05), ("opacities", 0.25),
              ("log_scales", 0.05))
    dev = true_scene.means.device
    return dataclasses.replace(true_scene, **{
        f: getattr(true_scene, f) + torch.from_numpy(
            rng.normal(0.0, s, tuple(getattr(true_scene, f).shape)).astype(np.float32)).to(dev)
        for f, s in sigmas})


def _culled_instances(scene, cams: Camera, cfg: RenderConfig) -> int:
    """Instances the tiled pipeline drops at this capacity (bin_splats'
    ``num_culled_instances``), summed over the views (one readback)."""
    grid = _grid_from_config(cfg, scene.num_gaussians)
    total = 0
    with torch.no_grad():
        for m, p in zip(cams.cam_to_world, cams.proj):
            d = prepare_splats(scene, Camera(cam_to_world=m, proj=p), cfg, sort=False)
            total = total + bin_splats(d["mean2d"], d["extent"], grid,
                                       d["depth"])["num_culled_instances"]
    return int(total)


def _step_ms(clock: _Clock, marks, breaks) -> list:
    """ms between consecutive optimizer steps, except across ``breaks`` (the
    step indices that start a phase or follow an event)."""
    return [clock.ms(marks[i - 1], marks[i]) for i in range(1, len(marks)) if i not in breaks]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splats", type=int, default=200_000)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--chunk", type=int, default=0,
                    help="steps between two readbacks of the losses "
                         "(0 = train._FIT_CHUNK)")
    ap.add_argument("--out", default="artifacts/fit_demo_torch")
    ap.add_argument("--tiny", action="store_true",
                    help="small sizes (tests): 2k splats, 2 views, 256x144, 8 steps, "
                         "(--adaptive) an event after step 4; the device is still "
                         "--device's")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--adaptive", action="store_true",
                    help="densify.fit_scene_adaptive for --steps steps in place of the "
                         "two phases and the checkpoint")
    args = ap.parse_args(argv)
    args.densify_every = DENSIFY_EVERY
    if args.tiny:
        args.splats, args.views = 2_000, 2
        args.width, args.height, args.steps = 256, 144, 8
        args.densify_every = args.steps // 2
    dev = resolve_device(args.device)
    if args.chunk:
        train._FIT_CHUNK = args.chunk

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    clock = _Clock(dev)

    # --- true scene + target views ------------------------------------
    true_scene = make_garden_scene(args.splats, seed=args.seed, device=dev)
    cams = garden_cameras(args.views, width=args.width, height_px=args.height, device=dev)
    cfg = RenderConfig(width=args.width, height=args.height, pipeline="tiled")
    cfg = apply_profile(cfg, "production")
    # capacity for the WHOLE orbit (targets + training render the same views)
    cfg = calibrate_config(true_scene, cams, cfg)
    print(f"# capacity mult {cfg.max_instance_mult:.3f}", file=sys.stderr)

    t0 = time.time()
    with torch.no_grad():
        targets = render_batch(true_scene, cams, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"# targets rendered in {time.time() - t0:.1f}s", file=sys.stderr)

    # --- perturbed initial scene --------------------------------------
    init = _perturbed(true_scene, rng)
    cam0 = Camera(cam_to_world=cams.cam_to_world[0], proj=cams.proj[0])

    def snap(scene, name):
        with torch.no_grad():
            img = render(scene, cam0, cfg).cpu().numpy()
        # downsample 4x (box) so committed PNGs stay light
        h, w = img.shape[0] // 4 * 4, img.shape[1] // 4 * 4
        small = img[:h, :w].reshape(h // 4, 4, w // 4, 4, 4).mean((1, 3))
        save_png(os.path.join(args.out, name), small.astype(np.float32))

    snap(true_scene, "target.png")
    snap(init, "before.png")

    # --- fit ----------------------------------------------------------
    step_marks = []

    def optimizer(params):
        """The JAX tool's per-group Adam (train.LR_SCALE), with a mark on the
        device's timeline after every step."""
        opt = train.default_optimizer(params, args.lr)
        opt.register_step_post_hook(lambda *_: step_marks.append(clock.mark()))
        return opt

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    half = args.steps // 2
    if args.adaptive:
        final_scene, losses, events, extra = _fit_adaptive(
            args, init, cams, targets, cfg, optimizer, step_marks, clock)
    else:
        final_scene, losses, extra = _fit_two_phases(
            args, init, cams, targets, cfg, optimizer, step_marks, clock)
        events = None

    snap(final_scene, "after.png")

    # --- artifacts ----------------------------------------------------
    summary = {
        "splats": args.splats, "views": args.views,
        "resolution": f"{args.width}x{args.height}",
        "steps": args.steps, "lr": args.lr,
        "loss_first": losses[0], "loss_mid": losses[half - 1],
        "loss_final": losses[-1],
        "loss_drop_x": losses[0] / max(losses[-1], 1e-12),
        **extra,
        "profile": "production",
        "adaptive": args.adaptive,
        "max_instance_mult": cfg.max_instance_mult,
        "timer": clock.name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "nvidia_smi_name_power_limit": (gpu_name_and_power_limit() if dev.type == "cuda"
                                        else "cpu"),
    }
    record = {"losses": losses, "summary": summary}
    if events is not None:
        record["events"] = events
    with open(os.path.join(args.out, "loss_curve.json"), "w") as f:
        json.dump(record, f)
    print(json.dumps(summary))
    # a committed run (hundreds of steps) must halve the loss; the tiny
    # smoke (a handful of steps) only has to make clear progress
    bar = 0.5 if args.steps >= 100 else 0.9
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] * bar):
        raise AssertionError(f"fit did not converge: {losses[0]} -> {losses[-1]}")
    if any(summary["num_culled_instances"]):
        raise AssertionError(f"instances dropped: {summary['num_culled_instances']}")
    return summary


def _peak_memory(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _fit_two_phases(args, init, cams, targets, cfg, optimizer, step_marks, clock):
    """--steps // 2 steps, the scene saved, reloaded, checked equal and
    deleted, then the rest with a fresh optimizer -> (scene, losses, summary
    entries)."""
    dev = init.means.device
    half = args.steps // 2
    t0 = time.time()
    mid_scene, losses1 = train.fit_scene(init, cams, targets, cfg, steps=half,
                                         optimizer=optimizer)
    t_half = time.time() - t0

    ckpt = os.path.join(args.out, "ckpt_mid.npz")
    save_scene_npz(ckpt, mid_scene, step=half)
    reloaded, step_loaded = load_scene_npz(ckpt, device=dev)
    if step_loaded != half:
        raise AssertionError(f"checkpoint step {step_loaded}, saved {half}")
    for f in _FIELDS:
        if not torch.equal(getattr(mid_scene, f), getattr(reloaded, f)):
            raise AssertionError(f"the checkpoint round trip changed {f}")
    os.remove(ckpt)  # verified; the blob is not a useful committed artifact

    t1 = time.time()
    final_scene, losses2 = train.fit_scene(reloaded, cams, targets, cfg,
                                           steps=args.steps - half, optimizer=optimizer)
    t_rest = time.time() - t1
    peak = _peak_memory(dev)
    step_ms = _step_ms(clock, step_marks, {half})
    return final_scene, losses1 + losses2, {
        "step_ms_incl_compile_phase2": t_rest / (args.steps - half) * 1e3,
        "wall_s": t_half + t_rest,
        "checkpoint_roundtrip": "exact",
        "step_ms_median": statistics.median(step_ms) if step_ms else None,
        "peak_memory_bytes": peak,
        # at the start of each phase and at the end
        "num_culled_instances": [_culled_instances(sc, cams, cfg)
                                 for sc in (init, reloaded, final_scene)],
    }


def _fit_adaptive(args, init, cams, targets, cfg, optimizer, step_marks, clock):
    """densify.fit_scene_adaptive with an event every ``args.densify_every`` steps
    -> (scene, losses, events, summary entries)."""
    chunk_starts = [(init, cfg)]  # (scene, config) at every chunk's start
    event_marks = []

    def on_event(event, params, config):
        event_marks.append(clock.mark())
        chunk_starts.append((GaussianScene(**{
            f: getattr(params, f).detach().clone() for f in _FIELDS}), config))

    t0 = time.time()
    fitted, losses, events = densify_mod.fit_scene_adaptive(
        init, cams, targets, cfg, steps=args.steps, densify_every=args.densify_every,
        optimizer=optimizer, on_event=on_event)
    wall_s = time.time() - t0
    peak = _peak_memory(init.means.device)
    # an event: from the last step of its chunk to the end of the
    # recalibration (densify, optimizer-state carry, calibrate_config)
    event_ms = [clock.ms(step_marks[e["step"] - 1], m) for e, m in zip(events, event_marks)]
    culled = [_culled_instances(sc, cams, c) for sc, c in chunk_starts]
    culled.append(_culled_instances(fitted, cams, chunk_starts[-1][1]))
    per_event = [{**e, "max_instance_mult": c.max_instance_mult,
                  "emax": _grid_from_config(c, e["num_splats"]).emax, "event_ms": ms}
                 for e, (_, c), ms in zip(events, chunk_starts[1:], event_ms)]
    step_ms = _step_ms(clock, step_marks, {e["step"] for e in events})
    return fitted, losses, per_event, {
        # no second phase here; the host clock over the whole run, per
        # step (events included), has its own key
        "step_ms_incl_compile_phase2": None,
        "wall_ms_per_step": wall_s * 1e3 / args.steps,
        "wall_s": wall_s,
        "checkpoint_roundtrip": None,
        "step_ms_median": statistics.median(step_ms) if step_ms else None,
        "peak_memory_bytes": peak,
        # at the start of every chunk and at the end
        "num_culled_instances": culled,
        "densify_every": args.densify_every,
        "densify_config": dataclasses.asdict(densify_mod.DensifyConfig()),
        "splats_final": fitted.num_gaussians,
        "num_events": len(events),
        "event_ms_total": sum(event_ms),
        "event_share_of_wall": sum(event_ms) / (wall_s * 1e3),
    }


if __name__ == "__main__":
    main()
