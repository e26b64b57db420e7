"""Where the composite backward spends its time on the GPU, piece by piece.

    python -m splatapult_tpu_torch.tools.profile_bwd [--splats 1000000]
        [--width 1920] [--height 1080] [--instance-mult 4] [--early-stop 1e-4]
        [--scene ball|garden] [--out FILE.json]

The counterpart of the JAX repo's tools/profile_bwd.py, with its flags and
defaults; ``--scene`` and ``--instance-mult 0`` as in tools/profile_bin.py.
The splats are prepared (unsorted) and binned with the depth key, as the
tiled path runs them (the JAX tool bins pre-sorted splats without a depth
key, a mode the port does not have: ROADMAP item 16); the feature rows are
gathered, the forward run storing its checkpoints, and the backward run on
a cotangent of 1e-3 everywhere (the JAX tool's). Then each piece is timed
alone by CUDA events on those kept inputs (median of ITERS after one
warm-up; the pieces take turns round by round, the stream held while the
host issues each: the card's time, profile_bin.rounds_ms):

- B2, composite_fwd as served, and its two launches apart (the segment
  pass, the combine), and composite_fwd storing the checkpoints training
  keeps;
- B3, composite_bwd;
- the whole composite forward + backward: composite_from_feats on a leaf
  and autograd back to it;
- the tail, per_splat_sums, whole and each of its stages (the id sort, the
  column gather at the permutation, the two-level float64 prefix sum, the
  read at the segment ends and the difference); beside the shipped prefix
  sum, a single-level torch.cumsum over the same [9, emax] columns (the
  JAX tool's old "transpose tail" beside "NEW (as shipped)");
- the instance-row gather, gather_rows, beside torch's row indexing;
- prepare_splats forward + VJP (of the sum of its four outputs the
  composite reads, as the JAX tool's loss).

Eager PyTorch dead-code-eliminates nothing, so the JAX tool's chained sums
are not carried over: each piece is called as it is. The tail's stages are
recorded as per_splat_sums' own body runs them (composite._tail_stages
through binning.run_stage), each timed on the very inputs it got there.
gather_rows must equal torch's row indexing, or the tool raises.

It prints one JSON line: the times, the wholes beside the sums of their
parts (``decompositions``: composite_fwd, per_splat_sums, the composite
forward + backward), the wholes also as a caller sees them (no hold:
``wall_ms``), B2 and B3 beside their plain versions (one run each)
with their bounds from this run's inputs (``kernels``: bytes moved and the
operations of the (slot, pixel) pairs above the alpha discard, as
chip_smoke.py's kernels line counts them), the instance counts, and the
card's name and power limit as nvidia-smi reports them.

GPU only: with no CUDA device it exits 1.
"""

from __future__ import annotations

import sys

import torch

from splatapult_tpu_torch.tools.profile_bin import (ITERS, decomposition, parse_args, report,
                                                    rounds_ms, setup, stage_calls)

COTANGENT = 1e-3  # the JAX tool's dout: ones * 1e-3


def _once_ms(fn):
    """One call, no warm-up (the plain versions take seconds) -> (milliseconds
    by CUDA events, its result)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    result = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), result


def kernel_rows(inst, start, nblk, out, seg, dout, d_inst, grid, ms) -> dict:
    """B2 and B3 beside their plain versions on the same inputs, with their
    bounds from this run's inputs (profile_phases.composite_bounds) -> name ->
    {ms, plain_ms, max_abs_err, bound_ms, bound_by}, plus the pair counts the
    bounds rest on. B2's error is the largest absolute one over its rows,
    B3's the largest over each gradient column's largest magnitude."""
    from splatapult_tpu_torch.ops import composite as C
    from splatapult_tpu_torch.tools.profile_phases import composite_bounds

    bounds = composite_bounds(inst, start, seg, grid, out.element_size())
    fwd_plain_ms, ref = _once_ms(lambda: C.composite_fwd_plain(inst, start, nblk, grid))
    fwd_err = float((out.float() - ref.float()).abs().max())
    del ref
    bf16 = grid.accum_dtype == "bfloat16"  # the plain backward then replays the segments
    bwd_plain_ms, d_ref = _once_ms(lambda: C.composite_bwd_plain(
        inst, start, nblk, out, dout, grid, segments=seg if bf16 else None))
    scale = d_ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    bwd_err = float(((d_inst - d_ref).abs() / scale).max())
    return {
        "composite_fwd (B2)": {"ms": ms["composite_fwd (B2, as served)"],
                               "plain_ms": fwd_plain_ms, "max_abs_err": fwd_err,
                               **bounds["composite_fwd"]},
        "composite_bwd (B3)": {"ms": ms["composite_bwd (B3)"], "plain_ms": bwd_plain_ms,
                               "max_abs_err": bwd_err, **bounds["composite_bwd"]},
        "pairs": bounds["pairs"], "live_segments": bounds["live_segments"]}


def measure(scene, cam, cfg, iters: int) -> dict:
    """The backward's pieces at ``cfg``'s grid on the card (``cfg`` must allow
    a backward: forward_only=False) -> the result's measured part."""
    import dataclasses
    import importlib

    from splatapult_tpu_torch.ops import binning as B, composite as C, tiled
    from splatapult_tpu_torch.tools.profile_phases import _event_ms

    R = importlib.import_module("splatapult_tpu_torch.render")
    if cfg.forward_only:
        raise ValueError("profile_bwd needs a config with forward_only=False")
    grid = tiled._grid_from_config(cfg, scene.num_gaussians)
    with torch.no_grad():
        d = R.prepare_splats(scene, cam, cfg, sort=False)
    bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"])
    feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
    src = C.pack_src(feats, grid)
    ids = bins["inst_splat"].long()
    inst = C.gather_rows(src, ids)
    if not torch.equal(inst, src[ids]):
        raise AssertionError("profile_bwd: gather_rows differs from torch's row indexing")
    start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
    out, seg = C.composite_fwd(inst, start, nblk, grid, checkpoints=True)
    locs = C.composite_fwd_segments(inst, start, nblk, grid)
    dout = torch.full_like(out, COTANGENT)
    d_inst = C.composite_bwd(inst, start, nblk, out, dout, grid, seg)
    tail_args = (d_inst, bins["inst_splat"], bins["seg_offs"], bins["seg_cnt"], grid)
    record = []
    C._tail_stages(*tail_args, record=record)
    tail_stages = stage_calls(record)
    cols = {name: got for name, _, _, got in record}["tail/column gather"]
    leaf = feats.detach().requires_grad_(True)

    def composite_vjp():
        torch.autograd.grad(C.composite_from_feats(leaf, bins, grid), leaf, dout)

    params = dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).detach().requires_grad_(True)
        for f in dataclasses.fields(scene)})
    leaves = [getattr(params, f.name) for f in dataclasses.fields(params)]

    def prepare_fwd_vjp():
        dp = R.prepare_splats(params, cam, cfg, sort=False)
        loss = dp["mean2d"].sum() + dp["conic"].sum() + dp["rgb"].sum() + dp["alpha"].sum()
        torch.autograd.grad(loss, leaves)

    calls = {
        "composite_fwd (B2, as served)": lambda: C.composite_fwd(inst, start, nblk, grid),
        "composite_fwd/segments": lambda: C.composite_fwd_segments(inst, start, nblk, grid),
        # as served: it leaves its input as it found it, so repeats time the
        # same work
        "composite_fwd/combine": lambda: C.combine_segments(locs, inst, start, nblk, grid),
        "composite_fwd storing checkpoints": lambda: C.composite_fwd(
            inst, start, nblk, grid, checkpoints=True),
        "composite_bwd (B3)": lambda: C.composite_bwd(inst, start, nblk, out, dout, grid, seg),
        "composite forward + backward (composite_from_feats, autograd)": composite_vjp,
        "pack_src+gather_rows": lambda: C.gather_rows(C.pack_src(feats, grid), ids),
        "tile_block_ranges": lambda: C.tile_block_ranges(bins["tile_count"], grid.block),
        "per_splat_sums": lambda: C.per_splat_sums(*tail_args),
        **tail_stages,
        "tail/single-level torch.cumsum of the [9, emax] columns": lambda: torch.cumsum(
            cols, dim=1),
        "gather_rows": lambda: C.gather_rows(src, ids),
        "gather/torch row indexing": lambda: src[ids],
        "prepare_splats forward + VJP": prepare_fwd_vjp,
    }
    ms = rounds_ms(calls, iters)
    wholes = ("composite_fwd (B2, as served)", "per_splat_sums",
              "composite forward + backward (composite_from_feats, autograd)")
    vjp_parts = ("pack_src+gather_rows", "tile_block_ranges", "composite_fwd storing checkpoints",
                 "composite_bwd (B3)", "per_splat_sums")
    return {
        "emax": grid.emax, "mcap": grid.mcap, "tiles": grid.num_tiles,
        "sort_key": B.sort_key_mode(grid), "grad_sort_dtype": grid.grad_sort_dtype,
        "instances": int(bins["tile_count"].sum()),
        "culled_instances": int(bins["num_culled_instances"]),
        "blocks": grid.num_blocks, "live_blocks": int(bins["block_live"].sum()),
        "walked_blocks": int(seg.walked.sum()),
        "ms": ms, "wall_ms": {k: _event_ms(calls[k], iters) for k in wholes},
        "decompositions": [
            decomposition("composite_fwd (B2, as served)", ms["composite_fwd (B2, as served)"],
                          {k: ms[k] for k in ("composite_fwd/segments",
                                              "composite_fwd/combine")}),
            decomposition("per_splat_sums", ms["per_splat_sums"],
                          {k: ms[k] for k in tail_stages}),
            decomposition("composite forward + backward (composite_from_feats, autograd)",
                          ms["composite forward + backward (composite_from_feats, autograd)"],
                          {k: ms[k] for k in vjp_parts}),
        ],
        "tail_stages_by_time": sorted(tail_stages, key=lambda k: -ms[k]),
        "kernels": kernel_rows(inst, start, nblk, out, seg, dout, d_inst, grid, ms),
    }


def main(argv=None) -> int:
    def early_stop(ap):
        ap.add_argument("--early-stop", type=float, default=1e-4)

    args = parse_args(argv, __doc__, instance_mult=4.0, extra=early_stop)
    if not torch.cuda.is_available():
        print("profile_bwd: no CUDA device (GPU only: a host timing would not be a device "
              "number)", file=sys.stderr)
        return 1
    scene, cam, cfg, calibrated = setup(args, early_stop_eps=args.early_stop)
    return report("profile_bwd", args, scene, cfg, calibrated,
                  measure(scene, cam, cfg, ITERS))


if __name__ == "__main__":
    sys.exit(main())
