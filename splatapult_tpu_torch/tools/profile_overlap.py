"""How much of the replicated sharded step's gradient all-reduce hides under its backward.

    python -m splatapult_tpu_torch.tools.profile_overlap [--world N] [--splats 20000]
        [--width 512] [--height 256] [--iters 4] [--allreduce psum]
        [--device cpu|cuda] [--backend gloo|nccl] [--timeout S] [--out FILE.json]

Spawns ``--world`` ranks (torch.multiprocessing, spawn) on a 1 x world tile
mesh over the garden stand-in (io/synth.make_garden_scene, one orbit view,
calibrated capacity, early stop 1e-4, black targets) and times, in each rank,
in ``--iters`` rounds of one call each (after two rounds to warm up):

  A. the full step (parallel/mesh._sharded_value_and_grad): the band loss,
     its backward with the SH all-reduce started inside it, the terminal
     all-reduce of the small gradients and the loss;
  B. the same band loss and backward with no collective;
  C. the collectives alone on gradient-sized buffers (the SH all-reduce
     started, then the terminal buffer's), timed from the ranks' common
     start to their end (a collective ends only once every rank joined it);

  overlap = (B + C - A) / C     (1 = the collectives fully hidden, 0 = serial)

A and B project every splat on every rank (the prepare replicated, not the
step's default sharded prepare, whose feature all-gather and reduce-scatter
are collectives too), so A - B is the gradient all-reduces' exposed time and
nothing else. In place of the JAX tool's count of async all-reduce pairs in
the compiled HLO, it reports the schedule itself: the SH all-reduces issued
inside the backward per step, and the milliseconds from the issue to the end
of the backward (the compute left to hide it under: CUDA events on the card,
the host clock on the CPU).

Per rank it prints one line, then one JSON line with every rank's numbers
(the last line). ``--device cpu`` (gloo, default 8 ranks of one thread each,
as the JAX tool's virtual CPU mesh) is a mechanism check only: the ranks
share the host's cores. ``--device cuda --backend gloo`` puts every rank on
card 0 (two ranks sharing one card: gloo's host-side all-reduce can run under the card's
backward; NCCL refuses two ranks on one card); ``--backend nccl`` puts rank r
on card r. In a one-rank world nothing is all-reduced and there is no overlap
to show. ``--allreduce ring`` (the JAX ring of ppermutes) raises
NotImplementedError (ROADMAP queue 1 item 16). The JAX tool's ``--sh-chunks``
has no counterpart: the port's step refuses ``sh_psum_chunks > 1`` (item 16).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist

MECHANISM_NOTE = "mechanism check only"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_rounds(fns, iters: int, warmup: int, dev: torch.device) -> list:
    """Mean host milliseconds of each of ``fns`` over ``iters`` rounds of one
    call each, in turn, the order rotated by one each round, so that a drift
    of the host's or the card's speed, and the place in the round, fall on
    all of them alike. A call starts with every rank together, the device
    drained, and stops when the slowest rank is done (a barrier: the step's
    all-reduce makes every rank wait for the slowest band too); the time of
    an empty call, the barrier's own, is taken off each.

    The last of ``fns`` ends in a collective, which completes on a rank only
    once every rank has joined it: it is timed from the common start to its
    own end, with no closing barrier and nothing taken off, so its time is
    positive. (A barrier's time under a loaded host, milliseconds, can
    exceed that of the collectives of a small scene: taken off them, it left
    a negative time.)"""
    fns = [lambda: None] + list(fns)
    last = len(fns) - 1
    for _ in range(warmup):
        for fn in fns:
            fn()
    totals = [0.0] * len(fns)
    for r in range(iters):
        for k in range(len(fns)):
            i = (r + k) % len(fns)
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            fns[i]()
            _sync(dev)
            if i != last:
                dist.barrier()
            totals[i] += time.perf_counter() - t0
    ms = [t * 1e3 / iters for t in totals]
    return [ms[0]] + [t - ms[0] for t in ms[1:last]] + [ms[last]]


def measure_overlap(scene, cameras, targets, config, mesh, iters: int = 4,
                    warmup: int = 2) -> dict:
    """A, B, C and the overlap of this rank (every rank calls it alike) ->
    a dict of milliseconds and the schedule's evidence.

    ``scene`` holds leaf tensors that require grad; ``targets`` is
    shard_targets' full tensor for ``mesh``. Nothing is stepped: every
    iteration differentiates the same parameters."""
    from splatapult_tpu_torch.parallel import mesh as PM
    from splatapult_tpu_torch.parallel.comm import all_reduce_, all_reduce_async_
    from splatapult_tpu_torch.render import prepare_splats

    dev = scene.means.device
    leaves = [getattr(scene, f) for f in PM._FIELDS]
    cams = PM._rank_views(cameras, mesh)
    tgt = PM._target_block(targets, config, mesh)

    def full():
        PM._sharded_value_and_grad(scene, cameras, targets, config, mesh,
                                   shard_prepare=False)

    def no_collective():
        for p in leaves:
            p.grad = None
        PM._band_losses(scene, cams, tgt, config, mesh, "interleaved",
                        lambda s, cam: prepare_splats(s, cam, config, sort=False))

    sh = scene.sh
    sh_buf = torch.zeros_like(sh)
    flat = torch.zeros(sum(p.numel() for p in leaves if p is not sh) + 1, device=dev)

    def collectives_alone():
        work = all_reduce_async_(sh_buf, None)
        all_reduce_(flat, None)
        if work is not None:
            work.wait()

    with PM.sh_allreduce_trace() as trace:
        barrier, a, b, c = _timed_rounds((full, no_collective, collectives_alone), iters,
                                         warmup, dev)
    markers = trace[-iters:]
    for p in leaves:
        p.grad = None
    return {
        "full_step_ms": a, "no_collective_ms": b, "collectives_ms": c, "barrier_ms": barrier,
        "exposed_ms": a - b, "overlap": (b + c - a) / c if c > 0 else None,
        "sh_allreduces_per_step": [m.issued for m in markers],
        "sh_collectives_per_step": [m.collectives for m in markers],
        "sh_allreduce_issue_to_backward_end_ms": statistics.mean(
            m.window_ms() for m in markers),
        "window_clock": "cuda events" if dev.type == "cuda" else "host clock",
        "sh_bytes": sh.numel() * sh.element_size(),
        "terminal_bytes": flat.numel() * flat.element_size(), "iters": iters,
    }


def _rank(rank: int, args, port: int, out_dir: str) -> None:
    """One rank: the process group, the scene, measure_overlap; pickles its
    result into ``out_dir``."""
    from splatapult_tpu_torch import train
    from splatapult_tpu_torch.io.synth import garden_cameras, make_garden_scene
    from splatapult_tpu_torch.parallel import mesh as PM
    from splatapult_tpu_torch.render import Camera, RenderConfig

    if args.device == "cpu":
        torch.set_num_threads(1)  # a rank a core, as the JAX tool's virtual CPU devices
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank if args.backend == "nccl" else 0)
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(args.backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=args.world)
    try:
        scene = make_garden_scene(args.splats, seed=0, device=dev)
        cam = garden_cameras(1, width=args.width, height_px=args.height, device=dev)
        cams = Camera(cam_to_world=cam.cam_to_world[None], proj=cam.proj[None])
        mesh = PM.make_render_mesh(args.world, 1, device_type=dev.type)
        config = RenderConfig(width=args.width, height=args.height, pipeline="tiled",
                              early_stop_eps=1e-4)
        config = PM.calibrate_config_sharded(scene, cams, config, mesh)
        targets = PM.shard_targets(
            torch.zeros((1, args.height, args.width, 4), device=dev), config, mesh)
        res = measure_overlap(train.leaf_copy(scene), cams, targets, config, mesh,
                              args.iters)
        res.update(rank=rank, device=str(dev), max_instance_mult=config.max_instance_mult)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(args) -> list:
    """_rank in ``args.world`` spawned processes -> every rank's result. A
    world that outlives ``args.timeout`` is killed and raises."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank, args=(args, _free_port(), out_dir), nprocs=args.world,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(0.5, t0 + args.timeout - time.perf_counter())):
                if time.perf_counter() > t0 + args.timeout:
                    raise TimeoutError(f"profile_overlap: the world of {args.world} did not "
                                       f"finish in {args.timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
        results = []
        for r in range(args.world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: 8 on the CPU, 2 with gloo on the card, every "
                         "card with nccl)")
    ap.add_argument("--splats", type=int, default=20000)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--allreduce", default="psum", choices=("psum", "ring"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the ranks are killed")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    from splatapult_tpu_torch._device import resolve_device
    from splatapult_tpu_torch.cli import gpu_name_and_power_limit
    from splatapult_tpu_torch.parallel.mesh import _check_step_options

    _check_step_options(1, args.allreduce)
    resolve_device(args.device)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    if args.device == "cpu" and args.backend == "nccl":
        ap.error("nccl needs --device cuda")
    if args.world is None:
        args.world = (8 if args.device == "cpu" else 2 if args.backend == "gloo"
                      else torch.cuda.device_count())
    if args.backend == "nccl" and args.world > torch.cuda.device_count():
        ap.error(f"nccl takes one card a rank: {args.world} ranks, "
                 f"{torch.cuda.device_count()} cards (gloo shares one)")

    ranks = run_world(args)
    for r in ranks:
        print(f"rank {r['rank']}: A full step {r['full_step_ms']:.3f} ms, B no collective "
              f"{r['no_collective_ms']:.3f} ms, C collectives {r['collectives_ms']:.3f} ms, "
              f"overlap {r['overlap']}, SH all-reduces issued in the backward per step "
              f"{r['sh_allreduces_per_step']}, issue to backward end "
              f"{r['sh_allreduce_issue_to_backward_end_ms']:.3f} ms "
              f"({r['window_clock']})", flush=True)
    summary = {
        "tool": "profile_overlap", "world": args.world, "device": args.device,
        "backend": args.backend, "splats": args.splats, "width": args.width,
        "height": args.height, "iters": args.iters, "allreduce": args.allreduce,
        **{k: statistics.mean(r[k] for r in ranks) for k in (
            "full_step_ms", "no_collective_ms", "collectives_ms", "exposed_ms",
            "sh_allreduce_issue_to_backward_end_ms")},
        "overlap": (statistics.mean(r["overlap"] for r in ranks)
                    if all(r["overlap"] is not None for r in ranks) else None),
        "ranks": ranks,
        "note": (MECHANISM_NOTE + ": the CPU ranks share the host's cores"
                 if args.device == "cpu" else
                 MECHANISM_NOTE + ": the ranks share one card" if args.backend == "gloo"
                 and args.world > 1 else
                 "one rank: nothing is all-reduced, no overlap to show" if args.world == 1
                 else "one card a rank"),
        "nvidia_smi_name_power_limit": (gpu_name_and_power_limit() if args.device == "cuda"
                                        else None),
    }
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
