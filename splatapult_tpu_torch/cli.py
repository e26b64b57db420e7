"""Command-line entry point of the port: render / path / points / export /
info / save-pose / bench / fit / synth.

The functional replacement for the reference's App + SDL main (ref:
src/app.cpp:286-368 flag parsing, src/sdl_main.cpp). Interactive windows and
VR map to subcommands:

  render     one view of a .ply -> PNG          (the per-frame loop; --stereo
                                                 for the VR eye pair)
  path       all cameras.json views -> PNGs     ('n'/'p' camera cycling,
                                                 src/app.cpp:650-674)
  points     SfM input.ply -> PNG               (PointRenderer)
  export     import/export round trip, prune    (GaussianCloud::ExportPly)
  info       scene + discovered configs         (asset discovery, app.cpp:418-533)
  save-pose  viewpoint -> <ply>_vr.json         (Return-key pose save)
  bench      forward-only frame time of one view (FPS counter, vsync-off mode)
  fit        optimize a .ply against target PNGs (the trainer loop)
  synth      write a procedural scene .ply      (debug cloud or garden stand-in)

Reference flag parity: --nosh (app.cpp:335), --fp16 accumulation
(app.cpp:1000-1035), sRGB handling (FRAMEBUFFER_SRGB), <ply>_vr.json floorMat
and cameras.json auto-discovery (app.cpp:418-533, 578). Commands that render
run on the GPU unless --device cpu is given; export, info and save-pose are
host-side file work.

One deliberate difference from the JAX package's CLI: ``fit`` does not apply
a discovered <ply>_vr.json. Its cameras are cameras.json's (or the orbit
rig's), already in the scene's frame, and the floor transform composes only
onto a default viewpoint (_make_camera), as in ``render``. (The JAX ``fit``
tries to transform the scene by it and fails on the import.)
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os
import subprocess
import sys
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
    p.add_argument("--fp16", action="store_true", help="bf16 accumulation (ref --fp16)")
    p.add_argument("--srgb", action="store_true",
                   help="treat SH radiance as sRGB, composite in linear (ref FRAMEBUFFER_SRGB)")
    p.add_argument("--pipeline", choices=["auto", "global", "tiled"], default="auto",
                   help="auto picks tiled from 4096 splats up, global below")
    p.add_argument("--supersample", type=int, default=1,
                   help="ordered-grid supersampling factor (ref USE_SUPERSAMPLING)")
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--packed-colors", action="store_true",
                   help="16-bit fixed-point splat RGB (step 2^-12) in 32 B instance rows "
                        "instead of 64 B")
    p.add_argument("--no-floor", action="store_true",
                   help="ignore a discovered <ply>_vr.json floor transform")
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   help="camera position (default: the first cameras.json camera's, "
                        "else 0 0.5 2.5)")
    p.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--up", type=float, nargs=3, default=[0.0, 1.0, 0.0])
    p.add_argument("--camera-index", type=int, default=None,
                   help="use this camera from a discovered cameras.json")
    p.add_argument("--show-cameras", action="store_true",
                   help="overlay camera frustums + path (ref 'y'/'h' keys)")
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
        accum_dtype="bfloat16" if args.fp16 else "float32",
        pipeline=args.pipeline,
        tile_size=args.tile_size,
        supersample=args.supersample,
        packed_colors=args.packed_colors,
        forward_only=True,
    )


def _calibrated(scene, cameras, cfg):
    """cfg with its capacity calibrated for the view(s) when the render goes
    through the tiled pipeline (the global pipeline has no capacity)."""
    from splatapult_tpu_torch.render import calibrate_config, resolve_pipeline

    if resolve_pipeline(cfg, scene.num_gaussians) == "tiled":
        return calibrate_config(scene, cameras, cfg)
    return cfg


def _load_scene_and_assets(args):
    """-> (scene on args.device, cameras.json CameraInfos, floor matrix or
    None, the discovery dict)."""
    from splatapult_tpu_torch.io.configs import (
        discover_scene,
        load_cameras_json,
        load_vr_config,
    )
    from splatapult_tpu_torch.io.gaussians import load_gaussian_ply

    found = discover_scene(args.ply)
    scene = load_gaussian_ply(args.ply, use_full_sh=not args.nosh, device=args.device)
    cameras = load_cameras_json(found["cameras_json"]) if found["cameras_json"] else []
    floor = None
    if found["vr_json"] and not args.no_floor:
        floor = load_vr_config(found["vr_json"])
        log.info("floor transform from %s", found["vr_json"])
    log.info("scene: %d splats, SH degree %d; cameras.json: %s",
             scene.num_gaussians, scene.sh_degree, found["cameras_json"])
    return scene, cameras, floor, found


def _camera_from_info(info, args, width, height, device=None):
    """A cameras.json camera (io.configs.CameraInfo) at this render size."""
    from splatapult_tpu_torch.render import Camera

    return Camera.from_fov(info.cam_to_world, fovy=float(info.fov[1]), width=width,
                           height=height, near=args.near, far=args.far,
                           device=args.device if device is None else device)


def _make_camera(args, cameras, floor, device=None):
    """The view to render: --camera-index's cameras.json camera, else a
    look-at from --eye (default: the first cameras.json camera's position,
    else 0 0.5 2.5) to --target. A discovered floor transform composes onto
    the default viewpoint only (no --camera-index, no --eye), the way the
    reference applies its saved VR pose (ref: src/app.cpp:578)."""
    from splatapult_tpu_torch.core import transforms as T
    from splatapult_tpu_torch.render import Camera

    device = args.device if device is None else device
    if args.camera_index is not None:
        if not cameras:
            sys.exit("no cameras.json discovered for --camera-index")
        cam = _camera_from_info(cameras[args.camera_index], args, args.width, args.height,
                                device)
    else:
        eye = args.eye
        if eye is None:
            # default viewpoint: first trainer camera position
            eye = cameras[0].position.tolist() if cameras else [0.0, 0.5, 2.5]
        cam = Camera.from_fov(T.look_at(eye=eye, target=args.target, up=args.up),
                              fovy=np.deg2rad(args.fovy), width=args.width,
                              height=args.height, near=args.near, far=args.far,
                              device=device)
    if floor is not None and args.camera_index is None and args.eye is None:
        cam = cam.with_floor_transform(np.asarray(floor, np.float32))
    return cam


def _maybe_overlay(img, args, cameras, cam):
    """--show-cameras: the cameras.json frustums and path drawn over the
    image (host-side numpy, after the readback)."""
    if not args.show_cameras or not cameras:
        return img
    from splatapult_tpu_torch.utils.overlay import camera_overlay_lines, draw_lines

    return draw_lines(img, camera_overlay_lines(cameras),
                      cam.cam_to_world.detach().cpu().numpy(),
                      cam.proj.detach().cpu().numpy(), args.width, args.height)


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
    from splatapult_tpu_torch.render import render, render_batch, resolve_pipeline
    from splatapult_tpu_torch.utils.image import save_png

    scene, cameras, floor, _ = _load_scene_and_assets(args)
    cam = _make_camera(args, cameras, floor)
    t0 = time.time()
    if args.stereo:
        # the VR stereo pair (ref: src/xrbuddy.cpp:1689-1800), written side by
        # side. Default: each eye rendered on its own through render_batch.
        # --shared-bins bins once over both eyes (stereo.render_stereo), which
        # needs symmetric frusta, supersample 1 and the tiled pipeline: the
        # JAX CLI's rule
        if args.show_cameras:
            log.warning("--show-cameras is not drawn on --stereo renders")
        tan = args.eye_tan_angles
        cfg = _config(args)
        shared = args.shared_bins and tan is None and args.supersample == 1 and (
            resolve_pipeline(cfg, scene.num_gaussians) == "tiled")
        if shared:
            from splatapult_tpu_torch.stereo import calibrate_config_stereo, render_stereo

            # the shared binning needs the UNION demand of both eyes
            imgs = render_stereo(scene, cam, calibrate_config_stereo(scene, cam, cfg, args.ipd),
                                 args.ipd).cpu().numpy()
        else:
            if args.shared_bins:
                log.info("stereo: per-eye render path (shared binning needs the tiled "
                         "pipeline, supersample 1 and symmetric frusta)")
            pair = cam.stereo_pair(
                args.ipd,
                tan_angles=None if tan is None else np.asarray(tan, np.float32).reshape(2, 4),
                near=args.near, far=args.far)
            imgs = render_batch(scene, pair, _calibrated(scene, pair, cfg)).cpu().numpy()
        img = np.concatenate([imgs[0], imgs[1]], axis=1)
    else:
        img = render(scene, cam, _calibrated(scene, cam, _config(args))).cpu().numpy()
        img = _maybe_overlay(img, args, cameras, cam)
    log.info("rendered %dx%d in %.2fs", img.shape[1], img.shape[0], time.time() - t0)
    save_png(args.output, img, srgb_encode=args.srgb)
    print(f"wrote {args.output}")


def cmd_path(args):
    """Every --every-th cameras.json view -> <output stem>_NNNN.png, one view
    after another; --batch renders them in one render_batch call (the same
    frames)."""
    import torch

    from splatapult_tpu_torch.render import Camera, render, render_batch
    from splatapult_tpu_torch.utils.image import save_png

    scene, cameras, _, _ = _load_scene_and_assets(args)
    if not cameras:
        sys.exit("path rendering needs a discoverable cameras.json")
    views = [_camera_from_info(info, args, args.width, args.height)
             for info in cameras[:: args.every]]
    batch = Camera(cam_to_world=torch.stack([c.cam_to_world for c in views]),
                   proj=torch.stack([c.proj for c in views]))
    cfg = _calibrated(scene, batch, _config(args))
    t0 = time.time()
    if args.batch:
        imgs = render_batch(scene, batch, cfg).cpu().numpy()
    else:
        imgs = [render(scene, c, cfg).cpu().numpy() for c in views]
    log.info("rendered %d views in %.2fs", len(views), time.time() - t0)
    stem = args.output[:-4] if args.output.endswith(".png") else args.output
    for i, img in enumerate(imgs):
        save_png(f"{stem}_{i:04d}.png", img, srgb_encode=args.srgb)
    print(f"wrote {len(imgs)} frames to {stem}_*.png")


def cmd_points(args):
    from splatapult_tpu_torch.io.points import load_point_ply, points_as_gaussians
    from splatapult_tpu_torch.render import render
    from splatapult_tpu_torch.utils.image import save_png

    pts = load_point_ply(args.ply, use_linear_colors=args.srgb)
    scene = points_as_gaussians(pts, world_radius=args.point_size, device=args.device)
    cam = _make_camera(args, [], None)
    img = render(scene, cam, _calibrated(scene, cam, _config(args))).cpu().numpy()
    save_png(args.output, img, srgb_encode=args.srgb)
    print(f"wrote {args.output} ({pts.num_points} points)")


def cmd_export(args):
    """Host-side: read, optionally keep the --prune nearest splats to
    --prune-origin, write."""
    from splatapult_tpu_torch.io.gaussians import (
        load_gaussian_ply,
        prune_splats,
        save_gaussian_ply,
    )

    scene = load_gaussian_ply(args.ply, use_full_sh=not args.nosh, device="cpu")
    if args.prune:
        scene = prune_splats(scene, origin=args.prune_origin, num_splats=args.prune)
        print(f"pruned to nearest {scene.num_gaussians} splats")
    save_gaussian_ply(args.output, scene, export_full_sh=not args.nosh)
    print(f"wrote {args.output}")


def cmd_bench(args):
    """Forward-only frame time on the LOADED scene (the reference's vsync-off
    FPS counter, ref: src/sdl_main.cpp:126-127,157-164), timed with CUDA
    events around ``--iters`` renders after a warm-up. GPU only: a host
    timing would not be a device number."""
    import torch

    from splatapult_tpu_torch.render import apply_profile, profile_name, render

    if torch.device(args.device).type != "cuda":
        raise SystemExit("bench measures the GPU; it has no CPU mode")
    scene, cameras, floor, _ = _load_scene_and_assets(args)
    cam = _make_camera(args, cameras, floor)
    cfg = _config(args)
    if args.profile != "custom":
        cfg = apply_profile(cfg, args.profile)
    cfg = _calibrated(scene, cam, cfg)
    log.info("capacity: %.2f instance slots per splat", cfg.max_instance_mult)

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


def _orbit_rig(scene, n_views, width, height, fovy, near=0.1, far=1000.0,
               device="cuda"):
    """Deterministic orbit camera batch around the scene centroid (the rig
    `fit` uses; render targets with the same rig for the poses to align)."""
    import torch

    from splatapult_tpu_torch.core import transforms as T
    from splatapult_tpu_torch.render import Camera

    means = scene.means.detach().to("cpu", torch.float32).numpy()
    center = means.mean(0)
    radius = max(float(np.percentile(
        np.linalg.norm(means - center, axis=1), 90)) * 2.2, 1e-3)
    cams = []
    for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        eye = center + radius * np.asarray(
            [np.cos(a), 0.35, np.sin(a)], np.float32)
        cams.append(Camera.from_fov(
            T.look_at(eye=eye.tolist(), target=center.tolist(),
                      up=[0.0, 1.0, 0.0]),
            fovy=fovy, width=width, height=height, near=near, far=far,
            device=device))
    return Camera(cam_to_world=torch.stack([c.cam_to_world for c in cams]),
                  proj=torch.stack([c.proj for c in cams]))


def cmd_fit(args):
    """Optimize the scene against target images: the trainer-side loop the
    reference only consumes the output of (ref README.md:70-83 — "generate
    the .ply with the INRIA trainer"; here the framework IS a trainer).
    Targets are PNGs in sorted-glob order; cameras come from a discovered
    cameras.json (the same convention as `path`) or, with --orbit or without
    a cameras.json, a generated orbit rig (_orbit_rig). A discovered
    <ply>_vr.json is not applied: see the module docstring. With --adaptive
    the fit clones, splits and prunes every --densify-every steps
    (densify.fit_scene_adaptive)."""
    import torch

    from splatapult_tpu_torch.io.gaussians import save_gaussian_ply
    from splatapult_tpu_torch.render import Camera
    from splatapult_tpu_torch.train import fit_scene
    from splatapult_tpu_torch.utils.image import load_png

    scene, cameras, floor, found = _load_scene_and_assets(args)
    if floor is not None:
        log.info("fit: the floor transform of %s is not applied (the cameras are "
                 "already in the scene's frame)", found["vr_json"])
    paths = sorted(glob.glob(args.targets))
    if not paths:
        sys.exit(f"no target images match --targets {args.targets!r}")
    raw = [load_png(p) for p in paths]
    h, w = raw[0].shape[:2]
    t4 = []
    for p, t in zip(paths, raw):
        if t.shape[:2] != (h, w):
            sys.exit(f"target {p} is {t.shape[1]}x{t.shape[0]}, "
                     f"expected {w}x{h} (all targets must match)")
        if t.ndim == 2:
            t = np.repeat(t[..., None], 3, axis=-1)
        if t.shape[-1] == 3:
            # RGB PNGs fit against alpha = 1 (opaque full-frame capture);
            # RGBA PNGs (save_png keep_alpha) carry their own coverage
            t = np.concatenate([t, np.ones_like(t[..., :1])], axis=-1)
        t4.append(t.astype(np.float32))
    targets = np.stack(t4)

    args.width, args.height = w, h
    cfg = dataclasses.replace(_config(args), forward_only=False)
    if cfg.pipeline == "auto":
        cfg = dataclasses.replace(cfg, pipeline="tiled")
    if cameras and not args.orbit:
        if len(cameras) < len(paths):
            sys.exit(f"{len(paths)} targets but only {len(cameras)} cameras "
                     f"in cameras.json")
        views = [_camera_from_info(info, args, w, h) for info in cameras[: len(paths)]]
        batch = Camera(cam_to_world=torch.stack([c.cam_to_world for c in views]),
                       proj=torch.stack([c.proj for c in views]))
    else:
        batch = _orbit_rig(scene, len(paths), w, h, fovy=np.deg2rad(args.fovy),
                           near=args.near, far=args.far, device=args.device)
        if not cameras and not args.orbit:
            log.warning("no cameras.json discovered: fitting against a "
                        "generated orbit rig (pass --orbit to silence)")
    cfg = _calibrated(scene, batch, cfg)
    t0 = time.time()
    if args.adaptive:
        from splatapult_tpu_torch.densify import DensifyConfig, fit_scene_adaptive

        scene, losses, events = fit_scene_adaptive(
            scene, batch, targets, cfg, steps=args.steps,
            densify_every=args.densify_every, learning_rate=args.lr,
            densify=DensifyConfig(max_splats=args.max_splats))
    else:
        scene, losses = fit_scene(scene, batch, targets, cfg, steps=args.steps,
                                  learning_rate=args.lr)
        events = []
    dt = time.time() - t0
    save_gaussian_ply(args.output, scene)
    print(json.dumps({
        "steps": args.steps, "views": len(paths),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "splats": scene.num_gaussians, "densify_events": events,
        "seconds": round(dt, 2), "output": args.output,
    }))


def cmd_save_pose(args):
    """Persist a viewpoint as <ply>_vr.json — the reference's Return-key pose
    save (ref: src/app.cpp:700-732): on desktop it stores the camera matrix
    lowered by --eye-height along its own up axis as the scene's floor
    transform, applied to the default viewpoint on the next launch (ref:
    src/app.cpp:443-461). Host-side: reads only the configs."""
    from splatapult_tpu_torch.io.configs import (
        discover_scene,
        load_cameras_json,
        save_vr_config,
    )

    found = discover_scene(args.ply)
    cameras = load_cameras_json(found["cameras_json"]) if found["cameras_json"] else []
    # the reference saves the LIVE world-space camera; composing an already-
    # saved floor transform in would compound on every save, so none is applied
    cam = _make_camera(args, cameras, floor=None, device="cpu")
    floor_mat = cam.cam_to_world.numpy().copy()
    # desktop save: floorMat = cameraMat translated down its own up axis
    # (ref: src/app.cpp:713-721)
    floor_mat[:3, 3] -= args.eye_height * floor_mat[:3, 1]
    out = args.output or (os.path.splitext(args.ply)[0] + "_vr.json")
    save_vr_config(out, floor_mat)
    print(f"wrote {out}")


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


def cmd_info(args):
    """Host-side: the scene's size and bounds, and the configs discovered
    around it."""
    from splatapult_tpu_torch.io.configs import (
        discover_scene,
        estimate_floor_plane,
        load_cameras_json,
    )
    from splatapult_tpu_torch.io.gaussians import load_gaussian_ply

    found = discover_scene(args.ply)
    scene = load_gaussian_ply(args.ply, device="cpu")
    print(f"splats:      {scene.num_gaussians}")
    print(f"sh degree:   {scene.sh_degree}")
    means = scene.means.numpy()
    print(f"bounds min:  {means.min(axis=0)}")
    print(f"bounds max:  {means.max(axis=0)}")
    for key in ("cameras_json", "vr_json", "input_ply"):
        print(f"{key + ':':13s}{found[key]}")
    if found["cameras_json"]:
        cams = load_cameras_json(found["cameras_json"])
        print(f"cameras:     {len(cams)}")
        # mean-camera-up floor estimate, the pose fallback the reference uses
        # when no <ply>_vr.json exists (ref: src/camerasconfig.cpp:69-95,
        # src/app.cpp:463-504)
        normal, point = estimate_floor_plane(cams)
        print(f"floor est.:  normal {np.round(normal, 3)} point {np.round(point, 3)}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="splatapult_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one view to PNG")
    _add_common(p)
    p.add_argument("--stereo", action="store_true",
                   help="render an L/R eye pair side by side (the VR stereo "
                        "analog, ref src/xrbuddy.cpp:1689-1800), one eye after "
                        "the other through render_batch")
    p.add_argument("--ipd", type=float, default=0.064,
                   help="interpupillary distance in meters for --stereo")
    p.add_argument("--shared-bins", action="store_true",
                   help="bin once for both eyes over the union of their tile rects "
                        "(stereo.render_stereo; needs symmetric frusta, supersample 1 "
                        "and the tiled pipeline, else each eye is rendered on its own)")
    p.add_argument("--eye-tan-angles", type=float, nargs=8, default=None,
                   metavar=("L_LEFT", "L_RIGHT", "L_UP", "L_DOWN",
                            "R_LEFT", "R_RIGHT", "R_UP", "R_DOWN"),
                   help="per-eye asymmetric frustum tangents for --stereo, "
                        "as an HMD runtime reports them (tan of the "
                        "left/right/up/down half-angles per eye; left/down "
                        "negative) — the reference's per-eye "
                        "XrViewConfiguration projections (src/xrbuddy.cpp:"
                        "1802-1832 -> util.cpp:412-480)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("path", help="render every cameras.json view")
    _add_common(p)
    p.add_argument("--every", type=int, default=1, help="use every k-th camera")
    p.add_argument("--batch", action="store_true",
                   help="render the views in one render_batch call")
    p.set_defaults(fn=cmd_path)

    p = sub.add_parser("points", help="render an SfM point cloud")
    _add_common(p)
    p.add_argument("--point-size", type=float, default=0.01)
    p.set_defaults(fn=cmd_points)

    p = sub.add_parser("export", help="round-trip a scene back to .ply (host-side)")
    p.add_argument("ply")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--nosh", action="store_true")
    p.add_argument("--prune", type=int, default=0, help="keep nearest N splats")
    p.add_argument("--prune-origin", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="forward-only frame time on a .ply scene")
    p.add_argument("--profile", default="exact",
                   choices=("exact", "production", "custom"),
                   help="precision profile: exact = library defaults; "
                        "production = the JAX package's training profile "
                        "(20-bit depth key, packed colours, early stop at "
                        "1e-4, bf16 gradient tail); custom = take the "
                        "individual flags as given. The JSON output tags "
                        "which profile actually ran")
    _add_common(p)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="optimize the scene against target PNGs "
                                   "(trainer loop)")
    _add_common(p)
    p.add_argument("--targets", required=True,
                   help="glob of target PNGs, sorted order = camera order")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--adaptive", action="store_true",
                   help="INRIA-style adaptive density control "
                        "(densify.py clone/split/prune)")
    p.add_argument("--densify-every", type=int, default=100)
    p.add_argument("--max-splats", type=int, default=8_000_000)
    p.add_argument("--orbit", action="store_true",
                   help="ignore cameras.json and fit against a generated "
                        "orbit rig (one view per target, same order targets "
                        "were rendered in). The rig derives from the INPUT "
                        "scene's centroid/extent, so targets must have been "
                        "rendered with the same rig geometry (_orbit_rig) "
                        "for poses to align")
    p.set_defaults(fn=cmd_fit, output="fitted.ply")

    p = sub.add_parser(
        "save-pose",
        help="save a viewpoint as <ply>_vr.json (the reference's Return-key "
             "pose save, ref src/app.cpp:700-732; host-side)")
    _add_common(p)
    p.add_argument("--eye-height", type=float, default=1.5,
                   help="meters the floor sits below the camera (ref 1.5)")
    # -o default becomes <ply>_vr.json (the common default is a .png)
    p.set_defaults(fn=cmd_save_pose, output=None)

    p = sub.add_parser("synth", help="generate a procedural scene .ply "
                                     "(debug cloud or garden-scale stand-in)")
    p.add_argument("kind", choices=["debug", "garden"])
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--splats", type=int, default=1_500_000, help="garden splat count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("info", help="print scene info + discovered configs (host-side)")
    p.add_argument("ply")
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.WARNING,
        format="%(levelname).1s %(name)s: %(message)s",
    )
    log.setLevel(logging.DEBUG if args.debug else logging.INFO)
    args.fn(args)


if __name__ == "__main__":
    main()
