"""Command-line entry point of the port: render / bench / synth.

  render   one view of a .ply -> PNG            (the per-frame loop)
  bench    forward-only frame time of one view  (FPS counter, vsync-off mode)
  synth    write a procedural scene .ply        (debug cloud or garden stand-in)

The other sub-commands of the JAX package's CLI (path, points, export, info,
fit, save-pose, render --stereo) are not ported yet; see ROADMAP.md.

Reference flag parity: --nosh (app.cpp:335), sRGB handling (FRAMEBUFFER_SRGB).
Runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import time

import numpy as np

log = logging.getLogger("splatapult_tpu_torch")


def _add_common(p):
    p.add_argument("ply", help="path to a 3DGS .ply scene")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--width", type=int, default=1024)  # ref default window (sdl_main.cpp:72)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--fovy", type=float, default=45.0, help="degrees (ref app.cpp:73)")
    p.add_argument("--near", type=float, default=0.1)
    p.add_argument("--far", type=float, default=1000.0)
    p.add_argument("--nosh", action="store_true", help="degree-0 SH only (ref --nosh)")
    p.add_argument("--srgb", action="store_true",
                   help="treat SH radiance as sRGB, composite in linear (ref FRAMEBUFFER_SRGB)")
    p.add_argument("--pipeline", choices=["auto", "tiled"], default="tiled",
                   help="auto picks tiled from 4096 splats up; below that it "
                        "names the global pipeline, which is not ported yet")
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--eye", type=float, nargs=3, default=[0.0, 0.5, 2.5])
    p.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--up", type=float, nargs=3, default=[0.0, 1.0, 0.0])
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs the plain PyTorch path")
    p.add_argument("-d", "--debug", action="store_true", help="verbose logging (ref -d)")


def _config(args):
    from splatapult_tpu_torch.render import RenderConfig

    return RenderConfig(
        width=args.width,
        height=args.height,
        sh_degree=0 if args.nosh else None,
        srgb_radiance_to_linear=args.srgb,
        pipeline=args.pipeline,
        tile_size=args.tile_size,
        forward_only=True,
    )


def _load_scene(args):
    from splatapult_tpu_torch.io.gaussians import load_gaussian_ply

    scene = load_gaussian_ply(args.ply, use_full_sh=not args.nosh, device=args.device)
    log.info("scene: %d splats, SH degree %d", scene.num_gaussians, scene.sh_degree)
    return scene


def _make_camera(args):
    from splatapult_tpu_torch.core import transforms as T
    from splatapult_tpu_torch.render import Camera

    cam_to_world = T.look_at(eye=args.eye, target=args.target, up=args.up)
    return Camera.from_fov(cam_to_world, fovy=np.deg2rad(args.fovy),
                           width=args.width, height=args.height,
                           near=args.near, far=args.far, device=args.device)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them ("" when
    nvidia-smi is not there)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def cmd_render(args):
    from splatapult_tpu_torch.render import calibrate_config, render
    from splatapult_tpu_torch.utils.image import save_png

    scene = _load_scene(args)
    cam = _make_camera(args)
    cfg = calibrate_config(scene, cam, _config(args))
    t0 = time.time()
    img = render(scene, cam, cfg).cpu().numpy()
    log.info("rendered %dx%d in %.2fs", img.shape[1], img.shape[0], time.time() - t0)
    save_png(args.output, img, srgb_encode=args.srgb)
    print(f"wrote {args.output}")


def cmd_bench(args):
    """Forward-only frame time on the LOADED scene (the reference's vsync-off
    FPS counter, ref: src/sdl_main.cpp:126-127,157-164), timed with CUDA
    events around ``--iters`` renders after a warm-up. GPU only: a host
    timing would not be a device number."""
    import torch

    from splatapult_tpu_torch.render import (
        apply_profile,
        calibrate_config,
        profile_name,
        render,
    )

    if torch.device(args.device).type != "cuda":
        raise SystemExit("bench measures the GPU; it has no CPU mode")
    scene = _load_scene(args)
    cam = _make_camera(args)
    cfg = _config(args)
    if args.profile != "custom":
        cfg = apply_profile(cfg, args.profile)
    cfg = calibrate_config(scene, cam, cfg)
    log.info("auto capacity: %.2f instance slots per splat", cfg.max_instance_mult)

    for _ in range(3):
        render(scene, cam, cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(args.iters):
        render(scene, cam, cfg)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.iters
    print(json.dumps({
        "splats": int(scene.num_gaussians), "width": args.width, "height": args.height,
        "ms_per_frame": ms, "fps": 1e3 / ms,
        "pixels_per_s": args.width * args.height / (ms * 1e-3),
        "profile": profile_name(cfg),
        "device": torch.cuda.get_device_name(0),
        "gpu_name_power_limit": gpu_name_and_power_limit(),
    }))


def cmd_synth(args):
    """Generate a procedural scene .ply — the debug cloud (ref:
    GaussianCloud::InitDebugCloud, src/gaussiancloud.cpp:505-578) or the
    garden-scale capture stand-in (io/synth.py). Host-side numpy only."""
    from splatapult_tpu_torch.io.gaussians import make_debug_scene, save_gaussian_ply

    if args.kind == "debug":
        scene = make_debug_scene(device="cpu")
    else:
        from splatapult_tpu_torch.io.synth import make_garden_scene

        scene = make_garden_scene(args.splats, seed=args.seed, device="cpu")
    save_gaussian_ply(args.output, scene)
    print(f"wrote {args.output} ({scene.num_gaussians} splats, "
          f"SH degree {scene.sh_degree})")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="splatapult_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one view to PNG")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="forward-only frame time on a .ply scene")
    p.add_argument("--profile", default="exact",
                   choices=("exact", "production", "custom"),
                   help="precision profile: exact = library defaults; "
                        "production needs packed_colors, which is not ported "
                        "yet; custom = take the individual flags as given. "
                        "The JSON output tags which profile actually ran")
    _add_common(p)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("synth", help="generate a procedural scene .ply "
                                     "(debug cloud or garden-scale stand-in)")
    p.add_argument("kind", choices=["debug", "garden"])
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--splats", type=int, default=1_500_000, help="garden splat count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_synth)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.WARNING,
        format="%(levelname).1s %(name)s: %(message)s",
    )
    log.setLevel(logging.DEBUG if args.debug else logging.INFO)
    args.fn(args)


if __name__ == "__main__":
    main()
