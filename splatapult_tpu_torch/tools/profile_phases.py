"""Where one forward render spends its time on the GPU.

    python -m splatapult_tpu_torch.tools.profile_phases [--splats N] [--width W]
        [--height H] [--iters K] [--out FILE.json]

Renders the garden stand-in (default: 1.5M splats at 1920x1080, exact
profile, calibrated capacity) and prints one JSON object with

- ``frame_ms``: median milliseconds per ``render`` call by CUDA events;
- ``phases_ms``: the same frame cut at the pipeline's public stage boundaries
  (prepare_splats, bin_splats, pack_features + row gather, composite_fwd,
  assemble_image), each timed with CUDA events over ``--iters`` repeats;
- ``device_busy_ms`` and ``idle_share`` per frame from ``torch.profiler``
  (sum of device kernel time against the frame time), and ``top_kernels``: the
  device kernels by total time, with launches per frame;
- the card's name and power limit as nvidia-smi reports them.

GPU only: a host timing would not be a device number.
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=1_500_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_phases: no CUDA device", file=sys.stderr)
        return 1

    from splatapult_tpu_torch.cli import gpu_name_and_power_limit
    from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
    from splatapult_tpu_torch.ops import binning as B, composite as C, tiled

    R = importlib.import_module("splatapult_tpu_torch.render")
    scene = make_garden_scene(args.splats, seed=0)
    cam = garden_cameras(1, width=args.width, height_px=args.height)
    cfg = R.apply_profile(R.RenderConfig(width=args.width, height=args.height,
                                         pipeline="tiled", forward_only=True), "exact")
    cfg = R.calibrate_config(scene, cam, cfg)
    grid = tiled._grid_from_config(cfg, scene.num_gaussians)

    frame_ms = _event_ms(lambda: R.render(scene, cam, cfg), args.iters)

    # the stages of ops/tiled.composite_tiled, one at a time on kept inputs
    d = R.prepare_splats(scene, cam, cfg)
    bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"])
    feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    inst = feats[bins["inst_splat"].long()]
    start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
    out = C.composite_fwd(inst, start, nblk, grid)
    table = B.expand_table(d["mean2d"], d["extent"], grid, d["depth"])
    phases = {
        "prepare_splats": lambda: R.prepare_splats(scene, cam, cfg),
        "bin_splats": lambda: B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"]),
        "bin_splats/expand_table": lambda: B.expand_table(
            d["mean2d"], d["extent"], grid, d["depth"]),
        "bin_splats/expand_fill": lambda: B.expand_fill(
            table["ends"], table["tile0"], table["nx"], table["dbits"], grid.emax,
            grid.tiles_x),
        "pack_features+gather": lambda: tiled.pack_features(
            d["mean2d"], d["conic"], d["rgb"], d["alpha"])[bins["inst_splat"].long()],
        "composite_fwd": lambda: C.composite_fwd(inst, start, nblk, grid),
        "assemble_image": lambda: tiled.assemble_image(out, bins["tile_ok"], grid, cfg),
    }
    phases_ms = {k: _event_ms(fn, args.iters) for k, fn in phases.items()}

    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            R.render(scene, cam, cfg)
        torch.cuda.synchronize()
    rows = []
    from torch.autograd import DeviceType

    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops repeat their kernels' device time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / n_prof, ev.count / n_prof))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    result = {
        "splats": scene.num_gaussians, "width": args.width, "height": args.height,
        "profile": R.profile_name(cfg), "emax": grid.emax, "mcap": grid.mcap,
        "instances": int(table["ends"][-1]),
        "frame_ms": frame_ms, "phases_ms": phases_ms,
        "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / frame_ms),
        "device_kernel_launches_per_frame": sum(r[2] for r in rows),
        "top_kernels": [{"name": k[:120], "ms_per_frame": ms, "launches_per_frame": c}
                        for k, ms, c in rows[:20]],
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
