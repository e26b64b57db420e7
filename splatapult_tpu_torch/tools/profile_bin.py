"""Where ops/binning.bin_splats spends its time on the GPU, stage by stage.

    python -m splatapult_tpu_torch.tools.profile_bin [--splats 1000000]
        [--width 1920] [--height 1080] [--instance-mult 2] [--scene ball|garden]
        [--out FILE.json]

The counterpart of the JAX repo's tools/profile_bin.py, with its flags and
defaults. ``--scene`` picks the scene and its view as bench.py does
(tools/scenes.py: the ball of bench.make_scene by default, or the garden
stand-in); ``--instance-mult 0`` calibrates the capacity to the view
(render.calibrate_config), as bench.py's ``--instance-mult 0`` does. The
profile is exact (f32 depth key). The splats are prepared once
(prepare_splats, unsorted, as the tiled path runs it); then the whole
bin_splats, and each of its stages alone on the inputs the stage before it
gave, are timed by CUDA events (median of ITERS after one warm-up; the
calls take turns round by round, and the stream is held while the host
issues each, so that what is timed is the card's work: rounds_ms):
the rects and counts, the overflow drop (and its [N] depth sort alone), the
table's cumsums, the expand fill (kernel B1), the slot columns, the tile
histogram, the alignment pads, the sort key, the main sort, the block
metadata. The stages are recorded as bin_splats' own body runs them
(binning._bin_stages through binning.run_stage), so what is timed is the
code that ships, each stage on the very inputs it got there.

The JAX tool sums every output of each timed body into a chained scalar so
that XLA cannot dead-code-eliminate part of it. Eager PyTorch eliminates
nothing: every launched kernel runs, so each stage is called as it is.

It prints one JSON line: the stage times, their sum and its gap to the whole
(``decompositions``), the whole timed as a caller sees it too (no hold:
``bin_splats_wall_ms``, where the host's pace of issuing shows), B1 beside its plain version, the library call nearest
to it (torch.searchsorted) and its bound by bytes, emax, mcap, the filled
slots and the culled instances, and the card's name and power limit as
nvidia-smi reports them. The JAX tool's "legacy, no depth key" row is not
timed: bin_splats' pre-sorted mode without a depth key is not ported
(ROADMAP item 16), and the JSON names it under ``absent``.

GPU only: with no CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time

import torch

ITERS = 10  # CUDA-event repeats of each timed call (their median), as profile_phases
LEGACY_ROW = "bin_splats TOTAL (legacy, no depth key)"


def decomposition(whole: str, whole_ms: float, parts_ms: dict) -> dict:
    """A whole beside the sum of its parts, each timed alone."""
    total = sum(parts_ms.values())
    return {"whole": whole, "whole_ms": whole_ms, "parts": list(parts_ms),
            "sum_ms": total, "gap_ms": whole_ms - total,
            "gap_share": (whole_ms - total) / whole_ms if whole_ms > 0 else 0.0}


def rounds_ms(calls: dict, iters: int, rotate: bool = False) -> dict:
    """Each call timed alone by CUDA events, the median of ``iters`` after one
    warm-up, the calls taking turns round by round -> name -> ms. With
    ``rotate`` the order starts one call later each round, so no call always
    follows the same one (whose arrays it may find in L2 or not); without,
    each round keeps the order of ``calls``, as a pipeline's stages run.

    Before each timed call a spin kernel (torch.cuda._sleep) holds the stream
    for twice the host's time to issue the call, plus 1 ms: the events then
    time the card's work back to back, not the host's pace of issuing it.
    Those times add up, a whole to its parts; host-paced ones do not (inside
    the whole a stage's last kernels run while the host issues the next
    stage, never when the stage is timed alone), and they follow the host's
    speed, which drifts within a run."""
    issue_ms = {}
    for k, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        issue_ms[k] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    a, b = events()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / a.elapsed_time(b)
    times = {k: [] for k in calls}
    names = list(calls)
    for i in range(iters):
        shift = i % len(names) if rotate else 0
        for k in names[shift:] + names[:shift]:
            fn = calls[k]
            a, b = events()
            torch.cuda._sleep(int(cycles_per_ms * (2 * issue_ms[k] + 1.0)))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def stage_calls(record) -> dict:
    """The stages binning.run_stage recorded -> name -> a call of that stage
    alone on the inputs it got (a functools.partial: ``.args`` holds them)."""
    return {name: functools.partial(fn, *args) for name, fn, args, _ in record}


def measure(scene, cam, cfg, iters: int) -> dict:
    """bin_splats whole and stage by stage at ``cfg``'s grid on the card ->
    the result's measured part (a dict; see the module docstring)."""
    import importlib

    from splatapult_tpu_torch.ops import binning as B, tiled
    from splatapult_tpu_torch.tools.profile_phases import HBM_BYTES_PER_S, _event_ms

    R = importlib.import_module("splatapult_tpu_torch.render")
    n = scene.num_gaussians
    grid = tiled._grid_from_config(cfg, n)
    with torch.no_grad():
        d = R.prepare_splats(scene, cam, cfg, sort=False)
    mean2d, extent, depth = d["mean2d"], d["extent"], d["depth"]
    record = []
    bins = B._bin_stages(mean2d, extent, grid, depth, record=record)
    stages = stage_calls(record)
    fill = stages["expand fill (B1)"]
    ends = fill.args[0]
    slots = torch.arange(grid.emax, dtype=torch.int32, device=depth.device)
    plain = functools.partial(B.expand_fill_plain, *fill.args)
    # the rows the stage gave (no launch of its own: a launch to compare
    # would count as one of the path's)
    rows = {name: got for name, _, _, got in record}["expand fill (B1)"]
    if not torch.equal(rows, plain()):
        raise AssertionError("profile_bin: expand_fill differs from its plain version")
    depth_f = stages["overflow drop"].args[0]
    sub = "overflow drop/torch.sort of the [N] depths alone"
    def whole():
        return B.bin_splats(mean2d, extent, grid, depth)

    ms = rounds_ms({"bin_splats": whole, **stages,
                    "B1 plain": plain,
                    "B1 library": lambda: torch.searchsorted(ends, slots, right=True),
                    sub: lambda: torch.sort(depth_f, stable=True)}, iters)
    whole_ms, stages_ms, sub_ms = ms["bin_splats"], {k: ms[k] for k in stages}, {sub: ms[sub]}
    expand = {
        "ms": ms["expand fill (B1)"], "plain_ms": ms["B1 plain"],
        # each input column read once, the [3, emax] rows written once
        "bound_ms": (16 * n + 12 * grid.emax) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": ms["B1 library"], "library_call": "torch.searchsorted"}
    return {
        "emax": grid.emax, "mcap": grid.mcap, "tiles": grid.num_tiles,
        "sort_key": B.sort_key_mode(grid),
        "filled_slots": int(ends[-1]),
        "culled_instances": int(bins["num_culled_instances"]),
        "live_blocks": int(bins["block_live"].sum()),
        "bin_splats_ms": whole_ms, "bin_splats_wall_ms": _event_ms(whole, iters),
        "stages_ms": stages_ms, "sub_ms": sub_ms,
        "decompositions": [decomposition("bin_splats", whole_ms, stages_ms)],
        "stages_by_time": sorted(stages_ms, key=lambda k: -stages_ms[k]),
        "expand_fill": expand,
        "absent": {LEGACY_ROW: "not timed: bin_splats without a depth key (the pre-sorted "
                               "legacy mode) is not ported, ROADMAP item 16"},
    }


def parse_args(argv, doc: str, instance_mult: float, extra=None):
    """The JAX tool's flags (its defaults, ``instance_mult`` by tool), plus
    --scene and --out; ``extra(ap)`` adds a tool's own."""
    from splatapult_tpu_torch.tools.scenes import SCENES

    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--instance-mult", type=float, default=instance_mult,
                    help="capacity per splat; 0 calibrates it to the view")
    ap.add_argument("--scene", choices=SCENES, default="ball")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    if extra:
        extra(ap)
    return ap.parse_args(argv)


def setup(args, **cfg_knobs):
    """The scene, its view and the config the arguments ask for, on the card
    -> (scene, camera, config, calibrated)."""
    import importlib

    from splatapult_tpu_torch.tools.scenes import bench_camera, make_bench_scene

    R = importlib.import_module("splatapult_tpu_torch.render")
    scene = make_bench_scene(args.scene, args.splats, seed=0)
    cam = bench_camera(args.scene, args.width, args.height)
    cfg = R.RenderConfig(width=args.width, height=args.height, pipeline="tiled",
                         max_instance_mult=args.instance_mult, **cfg_knobs)
    calibrated = args.instance_mult <= 0.0
    if calibrated:
        cfg = R.calibrate_config(scene, cam, cfg)
    return scene, cam, cfg, calibrated


def report(tool: str, args, scene, cfg, calibrated: bool, measured: dict) -> int:
    """Print (and with --out write) the tool's JSON line -> exit code 0."""
    import importlib

    from splatapult_tpu_torch.cli import gpu_name_and_power_limit

    R = importlib.import_module("splatapult_tpu_torch.render")
    result = {
        "tool": tool, "scene": args.scene, "splats": scene.num_gaussians,
        "width": args.width, "height": args.height,
        "max_instance_mult": cfg.max_instance_mult, "calibrated": calibrated,
        "profile": R.profile_name(cfg), "early_stop_eps": cfg.early_stop_eps,
        "iters": ITERS, **measured,
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


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, instance_mult=2.0)
    if not torch.cuda.is_available():
        print("profile_bin: no CUDA device (GPU only: a host timing would not be a device "
              "number)", file=sys.stderr)
        return 1
    scene, cam, cfg, calibrated = setup(args)
    return report("profile_bin", args, scene, cfg, calibrated,
                  measure(scene, cam, cfg, ITERS))


if __name__ == "__main__":
    sys.exit(main())
