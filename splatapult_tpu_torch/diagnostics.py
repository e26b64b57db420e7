"""Observability: render statistics and profiling helpers.

The equivalents of the reference's aux subsystems: Tracy frame zones ->
torch.profiler traces with named phases; the FPS HUD -> structured JSON stats
on stdout; GL_ERROR_CHECK -> finite/overflow assertions.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


def render_stats(scene, camera, config) -> dict:
    """Per-frame statistics the reference surfaces via its HUD/logs: splat
    counts, cull survivors, tile-bin occupancy, capacity overflow (never let
    truncation pass silently). The same keys and values as the JAX package's.
    Reads its scalars back to the host: a diagnostic, not a render path."""
    from splatapult_tpu_torch.ops.binning import bin_splats, sort_key_mode
    from splatapult_tpu_torch.ops.tiled import _grid_from_config
    from splatapult_tpu_torch.render import prepare_splats

    # mirror the production tiled path: unsorted prepare, depth riding the
    # binning sort
    with torch.no_grad():
        d = prepare_splats(scene, camera, config, sort=False)
        grid = _grid_from_config(config, scene.means.shape[0])
        bins = bin_splats(d["mean2d"], d["extent"], grid, depth=d["depth"])
        tile_count = bins["tile_count"].to(torch.int64).cpu()
        num_visible = int(d["mask"].sum())
        num_culled = int(bins["num_culled_instances"])
    num_instances = int(tile_count.sum())
    return {
        "num_splats": int(scene.means.shape[0]),
        "num_visible": num_visible,
        "num_instances": num_instances,
        "num_culled_instances": num_culled,
        "instance_capacity": grid.mcap,
        # enumeration-capacity utilization; near 1.0 risks overflow culling,
        # far below 1.0 wastes sort/gather/kernel time (size the capacity
        # with render.calibrate_config)
        "capacity_utilization": round(num_instances / max(grid.emax, 1), 4),
        "tiles": grid.num_tiles,
        "max_tile_instances": int(tile_count.max()),
        "mean_tile_instances": float(tile_count.double().mean()),
        "empty_tiles": int((tile_count == 0).sum()),
        # the ACTIVE instance-sort key mode (a packed depth key falls back to
        # "exact32" past its tile-count budget; the reference prints its
        # sort-path choice at init, src/splatrenderer.cpp:86-103)
        "sort_key_mode": sort_key_mode(grid),
    }


@contextlib.contextmanager
def phase_timer(sink: dict, name: str):
    """Named wall-clock phase (the Tracy ZoneScoped analog), added into
    ``sink[name]`` in seconds. On the GPU the work is asynchronous: put a
    ``torch.cuda.synchronize()`` at the end of the phase, or time device work
    with CUDA events instead."""
    t0 = time.perf_counter()
    yield
    sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler trace of the CPU and (when present) the GPU around a
    region, written to ``logdir`` as a Chrome/TensorBoard trace; yields the
    profiler (its ``key_averages()`` tables the kernels)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def print_stats(stats: dict) -> None:
    print(json.dumps(stats))
