"""Where the composite forward kernel's milliseconds go on the GPU: B2 with one
piece taken out at a time.

    python -m splatapult_tpu_torch.tools.microbench_kernel [--splats 1000000]
        [--width 1920] [--height 1080] [--iters 5] [--instance-mult 2]
        [--tile-size 32] [--tile-block 128] [--scene ball|garden]
        [--variants full,noscan,...] [--out FILE.json]

The counterpart of the JAX repo's tools/microbench_kernel.py, with its flags
and defaults; ``--scene`` and ``--instance-mult 0`` as in tools/profile_bin.py.
Each variant is a hand-written kernel pair (kernels/csrc/composite_fwd_ablate.cu:
the shipped segment pass and combine of composite_fwd.cuh, instantiated with
one piece taken out), on the f32x16 rows the JAX tool ablates:

  full       the shipped kernels, compiled a second time: held against them
             bit for bit and in time
  noscan     T does not fall within a block: every row's weight is taken
             against T at the block's start, and T falls by 1 - w of the
             block's last row at its end (the JAX tool's exclusive cumprod
             replaced by ones)
  noexp      w = min(0.01 qh, 0.99) above the alpha discard: no exp
  scan_bf16  T before a row is T at the block's start times the exp of the
             f32 sum of the earlier rows' bf16-rounded log(1 - w) (the JAX
             tool's bf16 triangular matmul; here a serial per-pixel sum, the
             same function)
  nowork     the rows are staged (bulk copies, mbarrier waits) and nothing is
             blended: every tile gets the background rows
  sub2, sub4 a CTA walks 16 and 32 blocks, where the shipped kernel walks 8
             (the JAX tool's SUB = 2, 4 blocks a grid step); unlike the JAX
             tool's, their values stay right

None uses the early stop, as in the JAX tool. The instance buffer is built
as the tiled path builds it: prepare_splats (unsorted), bin_splats with the
depth key, pack_features, the row gather (the JAX tool bins pre-sorted
splats without a depth key, a mode the port does not have: ROADMAP item 16).
Each variant's two launches, the segment pass and the combine, are timed
alone by CUDA events with the stream held while the host issues them
(profile_bin.rounds_ms, median of ``--iters`` after one warm-up, every call
taking its turn each round); a variant's time is their sum. The shipped
kernels take their turns beside them.

It prints the JAX tool's lines (``{variant:10s} {ms:8.2f} ms``) and, last,
one JSON line: per variant its ms and each launch's, ms_saved_vs_full, its
largest difference from the shipped rows (sub2 and sub4 held to the
composite tolerance of them), and the bound of its own function
(variant_bound); full against the shipped kernels (bit for bit, and the
ratio of their times); the shipped function's bound from this run's inputs
(profile_phases.composite_bounds' figure) and its (slot, pixel) pair shares; the
deepest tile's blocks; the card's name and power limit as nvidia-smi
reports them.

The plain PyTorch version of each variant (composite_fwd_variant_plain)
sits here beside its wrapper; the tests hold it against the JAX tool's
arithmetic on the CPU and chip_smoke.py holds each kernel against it on the
card.

GPU only: with no CUDA device it exits 1.
"""

from __future__ import annotations

import functools
import math
import sys

import torch

from splatapult_tpu_torch.ops import composite as C

VARIANTS = ("full", "noscan", "noexp", "scan_bf16", "nowork", "sub2", "sub4")
# kernel launches per launch and variant ("fwd_segments[noscan]",
# "fwd_combine[sub2]", ...), incremented where the kernel is launched and
# nowhere else; the shipped kernels count theirs in kernels.LAUNCH_COUNTS
LAUNCH_COUNTS = {f"fwd_{launch}[{v}]": 0 for launch in ("segments", "combine") for v in VARIANTS}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


# variant -> (the kernels' FwdVariant, composite_fwd.cuh; blocks a segment)
_KERNEL_OF = {"full": (0, C.SEGMENT_BLOCKS), "noscan": (1, C.SEGMENT_BLOCKS),
              "noexp": (2, C.SEGMENT_BLOCKS), "scan_bf16": (3, C.SEGMENT_BLOCKS),
              "nowork": (4, C.SEGMENT_BLOCKS), "sub2": (0, 2 * C.SEGMENT_BLOCKS),
              "sub4": (0, 4 * C.SEGMENT_BLOCKS)}
# the variants with the shipped arithmetic: their plain version is the shipped one
SHIPPED_ARITHMETIC = ("full", "sub2", "sub4")


def _check_variant_args(name, inst, tile_start, tile_nblk, grid, variant):
    """The wrappers' checks: the ablations take f32x16 rows and f32 output
    rows, blocks of a multiple of 32 rows, and a known variant."""
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant {variant!r}, not one of {VARIANTS}")
    if C.num_feats(grid) != C.NUM_FEATS or grid.accum_dtype != "float32":
        raise ValueError(f"{name}: the ablations take f32x16 rows and float32 accumulation")
    kind = C._check_kernel_args(name, inst, tile_start, tile_nblk, grid)
    if kind == "cuda" and grid.block % 32 != 0:
        raise ValueError(f"{name}: the ablation kernels take blocks of a multiple of 32 rows")
    return kind


def num_segments_cap(grid, variant: str) -> int:
    """The variant's segment numbers' bound (C.num_segments_cap for its
    segment length): the size of its locals and of its segment pass's grid."""
    return grid.num_blocks // _KERNEL_OF[variant][1] + grid.num_tiles


def _launch_segments(inst, tile_start, tile_nblk, grid, variant):
    """The variant's segment pass on CUDA tensors -> its locals
    [num_segments_cap(grid, variant), 4, P] (rows of numbers that belong to
    no segment unwritten)."""
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load(_build.TOOLS)
    code_v, seg_blocks = _KERNEL_OF[variant]
    nseg = num_segments_cap(grid, variant)
    locs = torch.empty((nseg, 4, grid.tile_pixels), dtype=torch.float32, device=inst.device)
    with torch.cuda.device(inst.device):
        code = lib.splat_ablate_fwd_segments(
            code_v, seg_blocks, inst.data_ptr(), tile_start.data_ptr(), tile_nblk.data_ptr(),
            locs.data_ptr(), nseg, grid.num_tiles, grid.tiles_x, grid.tile_size, grid.height,
            grid.block, *C._cutoff_args(grid), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"ablate_fwd_segments[{variant}]")
    LAUNCH_COUNTS[f"fwd_segments[{variant}]"] += 1
    return locs


def _launch_combine(locs, inst, tile_start, tile_nblk, grid, variant, checkpoints=False):
    """The variant's combine on CUDA tensors over its locals -> rows
    [T, 8, P] f32, or with ``checkpoints`` (rows, Segments(locs, walked)),
    the checkpoints written over ``locs`` in place."""
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load(_build.TOOLS)
    code_v, seg_blocks = _KERNEL_OF[variant]
    out = torch.empty((grid.num_tiles, C.OUT_ROWS, grid.tile_pixels), dtype=torch.float32,
                      device=inst.device)
    walked = torch.empty_like(tile_nblk) if checkpoints else None
    with torch.cuda.device(inst.device):
        code = lib.splat_ablate_fwd_combine(
            code_v, seg_blocks, inst.data_ptr(), tile_start.data_ptr(), tile_nblk.data_ptr(),
            locs.data_ptr(), out.data_ptr(), walked.data_ptr() if checkpoints else 0,
            int(checkpoints), grid.num_tiles, grid.tiles_x, grid.tile_size, grid.height,
            grid.block, *C._cutoff_args(grid), float(grid.early_stop_eps),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"ablate_fwd_combine[{variant}]")
    LAUNCH_COUNTS[f"fwd_combine[{variant}]"] += 1
    return (out, C.Segments(locs, walked)) if checkpoints else out


def composite_fwd_variant(inst, tile_start, tile_nblk, grid, variant: str, checkpoints=False):
    """B2 with one piece taken out (``variant``, see the module docstring) ->
    [T, 8, P] f32 rows, or with ``checkpoints`` ([T, 8, P], Segments) as
    C.composite_fwd gives them (segments of 8 blocks only). On a CUDA tensor
    this launches the variant's segment pass and combine
    (kernels/csrc/composite_fwd_ablate.cu) on the current stream, without
    synchronizing, or raises; the plain version runs only for CPU tensors.
    Rows in the f32x16 layout, float32 accumulation."""
    if _check_variant_args("composite_fwd_variant", inst, tile_start, tile_nblk, grid,
                           variant) == "cpu":
        return composite_fwd_variant_plain(inst, tile_start, tile_nblk, grid, variant,
                                           checkpoints)
    if checkpoints and _KERNEL_OF[variant][1] != C.SEGMENT_BLOCKS:
        raise ValueError(f"composite_fwd_variant[{variant}]: checkpoints come in segments "
                         f"of {C.SEGMENT_BLOCKS} blocks only")
    inst = C._contiguous_aligned(inst)
    tile_start, tile_nblk = tile_start.contiguous(), tile_nblk.contiguous()
    locs = _launch_segments(inst, tile_start, tile_nblk, grid, variant)
    return _launch_combine(locs, inst, tile_start, tile_nblk, grid, variant, checkpoints)


# ---- the plain PyTorch versions ------------------------------------------

def _exponents(f, px, py):
    """qh of every (row, pixel) pair of one block per tile, f [T, B, 9] decoded
    rows, px/py [T, P] -> [T, B, P] (the exponent C._block_weights takes)."""
    dx = px[:, None, :] - f[:, :, C.F_MX, None]
    dy = py[:, None, :] - f[:, :, C.F_MY, None]
    return (f[:, :, C.F_QA, None] * dx * dx + f[:, :, C.F_QB, None] * dx * dy
            + f[:, :, C.F_QC, None] * dy * dy + f[:, :, C.F_LNA, None])


def block_weights(f, px, py, active, grid, variant: str):
    """The variant's weights of one block per tile -> [T, B, P]: C._block_weights,
    or for noexp min(0.01 qh, 0.99) above the discard; 0 for tiles that are
    not ``active``."""
    if variant != "noexp":
        return C._block_weights(f, px, py, active, grid)
    qh = _exponents(f, px, py)
    w = torch.clamp_max(qh * 0.01, 0.99)
    if grid.alpha_cutoff > 0.0:
        w = torch.where(qh > math.log(grid.alpha_cutoff), w, 0.0)
    return torch.where(active[:, None, None], w, 0.0)


def block_transmittance(w, variant: str):
    """T within one block per tile, relative to T at its start, from its
    weights w [T, B, P] -> (T before each row [T, B, P], the block's factor
    [T, P]). The shipped walk: the exclusive cumprod of 1 - w. noscan: ones,
    and 1 - w of the last row. scan_bf16 (and the backward's tri_bf16): the
    exp of the exclusive f32 sum of bf16(log(max(1 - w, 1e-37))), and that
    at the last row times its 1 - w."""
    one_minus = 1.0 - w
    if variant == "noscan":
        return torch.ones_like(w), one_minus[:, -1]
    if variant in ("scan_bf16", "tri_bf16"):
        logs = torch.log(torch.clamp_min(one_minus, 1e-37)).to(torch.bfloat16).float()
        incl = torch.cumsum(logs, dim=1)
        excl = torch.exp(torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1))
        return excl, excl[:, -1] * one_minus[:, -1]
    incl = torch.cumprod(one_minus, dim=1)
    return torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1), incl[:, -1]


def blend_block_variant(f, px, py, active, color, trans, grid, variant: str):
    """C._blend_block with the variant's piece taken out: one block of
    decoded rows per tile blended into (colour [T, 3, P], T [T, P])."""
    if variant in SHIPPED_ARITHMETIC:
        return C._blend_block(f, px, py, active, color, trans, grid)
    if variant == "nowork":
        return color, trans
    w = block_weights(f, px, py, active, grid, variant)
    excl, factor = block_transmittance(w, variant)
    eff = trans[:, None, :] * excl * w
    color = color + torch.einsum("tbc,tbp->tcp", f[:, :, C.F_R:C.F_R + 3], eff)
    return color, trans * factor


def composite_fwd_variant_plain(inst, tile_start, tile_nblk, grid, variant: str,
                                checkpoints=False):
    """Plain PyTorch version of composite_fwd_variant: C._serial_walk (the
    plain serial walk, its early stop and checkpoints included) with the
    per-block blend swapped for the variant's (blend_block_variant). The
    variants with the shipped arithmetic are C.composite_fwd_plain itself."""
    if variant in SHIPPED_ARITHMETIC:
        return C.composite_fwd_plain(inst, tile_start, tile_nblk, grid, checkpoints)
    return C._serial_walk(C._decoded_rows(inst, grid), tile_start, tile_nblk, grid, checkpoints,
                          blend=functools.partial(blend_block_variant, variant=variant))


# ---- the tool ---------------------------------------------------------------

def build_inputs(scene, cam, cfg):
    """The instance buffer the tiled path gives B2 at ``cfg`` -> (grid, bins,
    inst, tile_start, tile_nblk)."""
    import importlib

    from splatapult_tpu_torch.ops import binning as B, tiled

    R = importlib.import_module("splatapult_tpu_torch.render")
    grid = tiled._grid_from_config(cfg, scene.num_gaussians)
    with torch.no_grad():
        d = R.prepare_splats(scene, cam, cfg, sort=False)
        bins = B.bin_splats(d["mean2d"], d["extent"], grid, d["depth"])
        feats = tiled.pack_features(d["mean2d"], d["conic"], d["rgb"], d["alpha"])
        inst = C._contiguous_aligned(
            C.gather_rows(C.pack_src(feats, grid), bins["inst_splat"].long()))
    start, nblk = C.tile_block_ranges(bins["tile_count"], grid.block)
    return grid, bins, inst, start, nblk


def buffer_facts(grid, bins) -> dict:
    return {"emax": grid.emax, "mcap": grid.mcap, "tiles": grid.num_tiles,
            "blocks": grid.num_blocks, "live_blocks": int(bins["block_live"].sum()),
            "instances": int(bins["tile_count"].sum()),
            "culled_instances": int(bins["num_culled_instances"])}


# the pieces of profile_phases.FWD_PAIR_MADDS (multiply-adds per pair above
# the discard) a variant's own function changes: noscan has no per-row T;
# noexp a multiply and a min for the exp; scan_bf16 a log, a rounding, an
# add and an exp for T's multiply. Those two also multiply T once per walked
# block and pixel at the block's end.
PAIR_MADDS_CHANGED = {"noscan": {"transmittance": 0}, "noexp": {"exp": 2},
                      "scan_bf16": {"transmittance": 10}}
BLOCK_END_VARIANTS = ("noscan", "scan_bf16", "tri_bf16")


def variant_flop(counts: dict, variant: str, pair_madds: dict, changed: dict) -> int:
    """The operations of a variant's own function on the inputs of
    profile_phases.composite_counts: ``pair_madds`` with the variant's
    pieces (``changed``) on every pair above the discard, the rectangle test
    on every walked slot, and the block-end multiply of BLOCK_END_VARIANTS."""
    from splatapult_tpu_torch.tools import profile_phases as P

    madds = sum({**pair_madds, **changed.get(variant, {})}.values())
    flop = 2 * madds * counts["pairs_above"] + 2 * P.SLOT_MADDS * counts["walked_slots"]
    if variant in BLOCK_END_VARIANTS:
        flop += counts["walked_blocks"] * counts["tile_pixels"]
    return flop


def variant_bound(counts: dict, variant: str) -> dict:
    """The least time the card could take for the variant's own function on
    these inputs (profile_phases.composite_counts of its walk) -> {"bound_ms",
    "bound_by"}: nowork by the bytes it must move (the rows read, the output
    rows written) with no operations, the others by the shipped function's
    bytes and their own operations (variant_flop). full, sub2 and sub4 are
    the shipped function: composite_bounds's figure."""
    from splatapult_tpu_torch.tools import profile_phases as P

    if variant == "nowork":
        return P.bound(counts["rows_bytes"] + counts["out_bytes"], 0)
    return P.bound(counts["fwd_bytes"],
                   variant_flop(counts, variant, P.FWD_PAIR_MADDS, PAIR_MADDS_CHANGED))


def rows_close_to(got, want, what: str) -> float:
    """The composite tolerance (max abs error 5e-3, at most a 1e-4 share of
    values off by more than 1e-4) -> max abs error; raises beyond it."""
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    max_err, frac = float(err.max()), float((err > 1e-4).float().mean())
    if max_err > 5e-3 or frac > 1e-4:
        raise AssertionError(f"{what}: max abs err {max_err:.3e}, fraction over 1e-4 = "
                             f"{frac:.3e}")
    return max_err


def measure(scene, cam, cfg, iters: int, variants=VARIANTS) -> dict:
    """Every variant's two launches and the shipped kernels' at ``cfg``'s grid
    on the card -> the result's measured part (see the module docstring)."""
    if cfg.early_stop_eps > 0.0:
        raise ValueError("microbench_kernel times the variants without the early stop")
    return measure_inputs(*build_inputs(scene, cam, cfg), iters, variants)


def measure_inputs(grid, bins, inst, start, nblk, iters: int, variants=VARIANTS) -> dict:
    """measure on the inputs build_inputs gave."""
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms
    from splatapult_tpu_torch.tools.profile_phases import composite_counts, pair_shares

    shipped = C.composite_fwd(inst, start, nblk, grid)
    locs = {v: _launch_segments(inst, start, nblk, grid, v) for v in variants}
    rows = {v: _launch_combine(locs[v].clone(), inst, start, nblk, grid, v) for v in variants}
    shipped_locs = C.composite_fwd_segments(inst, start, nblk, grid)
    calls = {"shipped/segments": lambda: C.composite_fwd_segments(inst, start, nblk, grid),
             # as served: the combine leaves its locals as it found them
             "shipped/combine": lambda: C.combine_segments(shipped_locs, inst, start, nblk,
                                                           grid)}
    for v in variants:
        calls[f"{v}/segments"] = lambda v=v: _launch_segments(inst, start, nblk, grid, v)
        calls[f"{v}/combine"] = lambda v=v: _launch_combine(locs[v], inst, start, nblk, grid, v)
    ms = rounds_ms(calls, iters)

    def by_launch(name):
        parts = {"segments": ms[f"{name}/segments"], "combine": ms[f"{name}/combine"]}
        return sum(parts.values()), parts

    counts = composite_counts(inst, start, C.Segments(None, nblk), grid, 4)
    shipped_ms, shipped_parts = by_launch("shipped")
    full_ms = by_launch("full")[0] if "full" in variants else None
    result = {}
    for v in variants:
        v_ms, parts = by_launch(v)
        result[v] = {"ms": v_ms, "ms_by_launch": parts,
                     "ms_saved_vs_full": None if full_ms is None else full_ms - v_ms,
                     "max_abs_diff_vs_shipped": float((rows[v] - shipped).abs().max()),
                     "segment_blocks": _KERNEL_OF[v][1], **variant_bound(counts, v)}
        if v in ("sub2", "sub4"):
            # the shipped arithmetic over longer segments: it must give the
            # shipped rows (the JAX tool's sub-blocked values are wrong by design)
            rows_close_to(rows[v], shipped, f"microbench_kernel[{v}] against the shipped rows")
            result[v]["values"] = "right: within the composite tolerance of the shipped rows"
    out = {**buffer_facts(grid, bins), "deepest_tile_blocks": int(nblk.max()),
           "variants": result, "shipped": {"ms": shipped_ms, "ms_by_launch": shipped_parts}}
    if "full" in variants:
        # a full that is not the shipped kernel bit for bit times something else
        if not torch.equal(rows["full"], shipped):
            raise AssertionError("microbench_kernel: full's rows differ from the shipped "
                                 "kernel's")
        out["full_vs_shipped"] = {"rows_bit_for_bit": True, "ms_ratio": full_ms / shipped_ms}
    out["bound"] = {"of": "the shipped function", **variant_bound(counts, "full")}
    out["pairs"] = pair_shares(counts)
    return out


def tool_args(argv, doc: str, variants, default_variants, extra=None):
    """The JAX tools' flags with their defaults (profile_bin.parse_args plus
    --iters, --tile-size, --tile-block and --variants); ``extra(ap)`` adds a
    tool's own."""
    from splatapult_tpu_torch.tools.profile_bin import parse_args as base_args

    def more(ap):
        ap.add_argument("--iters", type=int, default=5)
        ap.add_argument("--tile-size", type=int, default=32)
        ap.add_argument("--tile-block", type=int, default=128)
        ap.add_argument("--variants", default=",".join(default_variants),
                        help="comma-separated, of: " + ",".join(variants))
        if extra:
            extra(ap)

    args = base_args(argv, doc, instance_mult=2.0, extra=more)
    args.variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    bad = [v for v in args.variants if v not in variants]
    if bad:
        raise SystemExit(f"unknown variants {bad}: choose from {list(variants)}")
    return args


def parse_args(argv=None):
    return tool_args(argv, __doc__, VARIANTS, VARIANTS)


def print_lines(tool: str, args, measured: dict) -> None:
    """The JAX tool's lines, then the JSON line (profile_bin.report)."""
    print(f"# {tool}: inst [{measured['mcap']}, 16], {measured['blocks']} blocks "
          f"({measured['live_blocks']} live), {measured['instances']} instances", flush=True)
    for v, r in measured["variants"].items():
        note = "" if "kernel" not in r else f"   ({r['kernel']})"
        print(f"{v:10s} {r['ms']:8.2f} ms{note}", flush=True)


def main(argv=None) -> int:
    from splatapult_tpu_torch.tools.profile_bin import report, setup

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_kernel: no CUDA device (GPU only: a host timing would not be a "
              "device number)", file=sys.stderr)
        return 1
    scene, cam, cfg, calibrated = setup(args, tile_size=args.tile_size,
                                        tile_block=args.tile_block)
    measured = measure(scene, cam, cfg, args.iters, args.variants)
    print_lines("microbench_kernel", args, measured)
    return report("microbench_kernel", args, scene, cfg, calibrated,
                  {**measured, "iters": args.iters, "tile_size": args.tile_size,
                   "tile_block": args.tile_block})


if __name__ == "__main__":
    sys.exit(main())
