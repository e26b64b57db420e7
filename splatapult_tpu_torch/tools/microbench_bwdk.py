"""Where the composite backward kernel's milliseconds go on the GPU: B3 with
one piece taken out at a time.

    python -m splatapult_tpu_torch.tools.microbench_bwdk [--splats 1000000]
        [--width 1920] [--height 1080] [--iters 5] [--instance-mult 2]
        [--tile-size 32] [--tile-block 128] [--early-stop 1e-4]
        [--variants full,nowork,noscan,noscan2,nomom] [--scene ball|garden]
        [--out FILE.json]

The counterpart of the JAX repo's tools/microbench_bwdk.py, with its flags
and defaults (every variant name of the JAX tool is accepted); ``--scene``
and ``--instance-mult 0`` as in tools/profile_bin.py. Each variant is a
hand-written kernel (kernels/csrc/composite_bwd_ablate.cu: the shipped
backward of composite_bwd.cuh, instantiated with one piece taken out), on
the f32x16 rows the JAX tool ablates:

  full       the shipped kernel, compiled a second time: held against it bit
             for bit and in time
  nowork     the rows are staged and every walked block's nine gradient
             columns are written as zeros
  noscan     T does not fall within a block (the forward's noscan, replayed)
  noscan2    dw reads S (the running sum of eff * cdot) at the block's start
             plus the current row's term only, where the shipped kernel
             reads the running sum
  nomom      the six geometry columns all equal the pixel sum of dqh: one
             warp sum of four values replaces the nine and the moment algebra
  tri_bf16   T before a row as the forward's scan_bf16 (the JAX tool's bf16
             triangular matmul)
  vpu_cdot, vpu_carry, vpu_all
             full's function, which the TPU computes on its vector unit
             instead of its matrix unit; a GPU has one unit for both, so
             these launch full's kernel, and the output says so

The early stop is 1e-4 by default, as in the JAX tool. The forward rows
(``out_res``) are always the shipped forward's; a variant whose walk of T
differs (noscan, tri_bf16) starts every segment from the checkpoints and
the walked blocks of its own forward (microbench_kernel's noscan and
scan_bf16, storing checkpoints, with this early stop), the others from the
shipped forward's. The cotangent is 1e-3 everywhere (the JAX tool's). The
instance buffer and the timing are microbench_kernel's: each variant's
launch alone by held CUDA events, median of ``--iters``, the shipped kernel
taking its turns beside them.

It prints the JAX tool's lines and, last, one JSON line: per variant its ms,
ms_saved_vs_full, blocks walked and the bound of its own function
(variant_bound); full against the shipped kernel (bit for bit, and the
ratio of their times); the shipped function's bound and the (slot, pixel)
pair shares; the deepest tile's blocks; the card's name and power limit.

The plain PyTorch version of each variant (composite_bwd_variant_plain)
sits here beside its wrapper.

GPU only: with no CUDA device it exits 1.
"""

from __future__ import annotations

import functools
import sys

import torch

from splatapult_tpu_torch.ops import composite as C
from splatapult_tpu_torch.tools import microbench_kernel as MK

VARIANTS = ("full", "nowork", "noscan", "noscan2", "nomom", "tri_bf16", "vpu_cdot",
            "vpu_carry", "vpu_all")
DEFAULT_VARIANTS = ("full", "nowork", "noscan", "noscan2", "nomom")
# the kernels, in the order of BwdVariant (composite_bwd.cuh)
KERNELS = ("full", "nowork", "noscan", "noscan2", "nomom", "tri_bf16")
# kernel launches per kernel ("bwd[nomom]", ...), incremented where the
# kernel is launched and nowhere else
LAUNCH_COUNTS = {f"bwd[{k}]": 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


# variant -> the forward variant whose checkpoints it starts from
FORWARD_OF = {"noscan": "noscan", "tri_bf16": "scan_bf16"}
COTANGENT = 1e-3  # the JAX tool's dout: ones * 1e-3


def forward_of(variant: str) -> str:
    return FORWARD_OF.get(variant, "full")


def kernel_of(variant: str) -> str:
    """The kernel a variant launches: the vpu variants are full's."""
    return "full" if variant.startswith("vpu_") else variant


def composite_bwd_variant(inst, tile_start, tile_nblk, out_res, dout, grid, variant: str,
                          segments=None):
    """B3 with one piece taken out (``variant``, see the module docstring) ->
    [9, mcap] f32 gradient columns, zero for blocks no segment walks. On a
    CUDA tensor this launches the variant's kernel
    (kernels/csrc/composite_bwd_ablate.cu) on the current stream, without
    synchronizing, or raises; it needs ``segments``, the Segments of
    forward_of(variant)'s forward (microbench_kernel.composite_fwd_variant
    with checkpoints). The plain version runs only for CPU tensors. Rows in
    the f32x16 layout, float32 accumulation."""
    if variant not in VARIANTS:
        raise ValueError(f"composite_bwd_variant: variant {variant!r}, not one of {VARIANTS}")
    kind = MK._check_variant_args("composite_bwd_variant", inst, tile_start, tile_nblk, grid,
                                  "full")
    rows = (grid.num_tiles, C.OUT_ROWS, grid.tile_pixels)
    for what, a in (("out_res", out_res), ("dout", dout)):
        if a.dtype != torch.float32 or a.shape != rows or a.device != inst.device:
            raise ValueError(f"composite_bwd_variant takes {what} {list(rows)} float32 on "
                             f"{inst.device}, got {tuple(a.shape)} {a.dtype} {a.device}")
    if kind == "cpu":
        return composite_bwd_variant_plain(inst, tile_start, tile_nblk, out_res, dout, grid,
                                           variant, segments)
    if segments is None:
        raise ValueError("composite_bwd_variant on a CUDA tensor takes its forward's segments")
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load(_build.TOOLS)
    inst = C._contiguous_aligned(inst)
    tile_start = tile_start.contiguous()
    out_res, dout = out_res.contiguous(), dout.contiguous()
    nseg = C.num_segments_cap(grid)
    d_inst = torch.zeros((C.NUM_GRAD_COLS, grid.mcap), dtype=torch.float32, device=inst.device)
    kernel = kernel_of(variant)
    with torch.cuda.device(inst.device):
        code = lib.splat_ablate_bwd(
            KERNELS.index(kernel), inst.data_ptr(), tile_start.data_ptr(), segments.walked.data_ptr(),
            segments.ckpt.data_ptr(), out_res.data_ptr(), dout.data_ptr(), d_inst.data_ptr(),
            nseg, grid.num_tiles, grid.mcap, grid.tiles_x, grid.tile_size, grid.height,
            grid.block, *C._cutoff_args(grid), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, f"ablate_bwd[{kernel}]")
    LAUNCH_COUNTS[f"bwd[{kernel}]"] += 1
    return d_inst


def composite_bwd_variant_plain(inst, tile_start, tile_nblk, out_res, dout, grid,
                                variant: str, segments=None):
    """Plain PyTorch version of composite_bwd_variant: the walk of
    C.composite_bwd_plain (float32 accumulation) with the per-block step
    swapped for the variant's (bwd_block_variant); the variants with full's
    function are C.composite_bwd_plain itself. ``segments`` starts every
    segment from its checkpoint and walks the blocks it says, as the kernel
    does; without it the walk runs the whole chains with the grid's early
    stop."""
    if variant == "nowork":
        return torch.zeros((C.NUM_GRAD_COLS, grid.mcap), dtype=torch.float32,
                           device=inst.device)
    step = None if kernel_of(variant) == "full" else functools.partial(bwd_block_variant,
                                                                       variant=variant)
    return C.composite_bwd_plain(inst, tile_start, tile_nblk, out_res, dout, grid,
                                 segments=segments, block_step=step)


def bwd_block_variant(f, px, py, active, trans, ssum, kconst, d_rgb, geom, grid,
                      variant: str):
    """C._bwd_block with the variant's piece taken out: T within the block as
    the variant's forward walks it (microbench_kernel.block_transmittance);
    noscan2's dw reads S at the block's start plus the row's own term; nomom's
    six geometry columns are all the pixel sum of dqh."""
    w = C._block_weights(f, px, py, active, grid)
    excl, factor = MK.block_transmittance(w, variant)
    t_before = trans[:, None, :] * excl
    eff = t_before * w
    cdot = torch.einsum("tbc,tcp->tbp", f[:, :, C.F_R:C.F_R + 3], d_rgb)
    terms = eff * cdot
    s_run = ssum[:, None, :] + torch.cumsum(terms, dim=1)
    s_incl = ssum[:, None, :] + terms if variant == "noscan2" else s_run
    dqh = w * ((kconst[:, None, :] + s_incl) / torch.clamp_min(1.0 - w, 1e-9)
               + t_before * cdot)
    if variant == "nomom":
        colour_cols = torch.einsum("tbp,tcp->ctb", eff, d_rgb).unbind(dim=0)
        cols = torch.stack([dqh.sum(dim=2)] * 6 + list(colour_cols))
    else:
        cols = C._grad_cols(f, dqh, eff, d_rgb, geom)
    return cols, eff, trans * factor, s_run[:, -1]


# the pieces of profile_phases.BWD_PAIR_MADDS (multiply-adds per pair above
# the discard) a variant's own function changes: noscan's replay has no
# per-row T and tri_bf16's a log, a rounding, an add and an exp for it (both
# also multiply T at every block's end); noscan2 adds S at the block's start
# to the row's term; nomom has three products (the colour columns) and sums
# four values where full has nine of each.
PAIR_MADDS_CHANGED = {"noscan": {"replay": 14}, "tri_bf16": {"replay": 24},
                      "noscan2": {"eff_and_s": 3}, "nomom": {"products": 3, "pixel_sums": 1}}


def variant_bound(counts: dict, variant: str) -> dict:
    """The least time the card could take for the variant's own function on
    these inputs (profile_phases.composite_counts over the blocks its forward
    walked) -> {"bound_ms", "bound_by"}: nowork by the bytes it must move
    (the walked rows read, their nine columns written) with no operations,
    the others by the shipped function's bytes and their own operations
    (microbench_kernel.variant_flop). The vpu variants are full's function:
    composite_bounds's figure."""
    from splatapult_tpu_torch.tools import profile_phases as P

    if variant == "nowork":
        return P.bound(counts["rows_bytes"] + counts["cols_bytes"], 0)
    return P.bound(counts["bwd_bytes"], MK.variant_flop(counts, kernel_of(variant),
                                                        P.BWD_PAIR_MADDS, PAIR_MADDS_CHANGED))


def measure(scene, cam, cfg, iters: int, variants=DEFAULT_VARIANTS) -> dict:
    """Every variant's kernel and the shipped one at ``cfg``'s grid on the
    card (``cfg`` must allow a backward) -> the result's measured part."""
    if cfg.forward_only:
        raise ValueError("microbench_bwdk needs a config with forward_only=False")
    return measure_inputs(*MK.build_inputs(scene, cam, cfg), iters, variants)


def measure_inputs(grid, bins, inst, start, nblk, iters: int, variants=DEFAULT_VARIANTS,
                   segs=None) -> dict:
    """measure on the inputs microbench_kernel.build_inputs gave; ``segs``
    may hold the Segments of forward variants already run at this grid."""
    from splatapult_tpu_torch.tools.profile_bin import rounds_ms
    from splatapult_tpu_torch.tools.profile_phases import composite_counts, pair_shares

    out, seg = C.composite_fwd(inst, start, nblk, grid, checkpoints=True)
    dout = torch.full_like(out, COTANGENT)
    segs = {**(segs or {}), "full": seg}
    for v in variants:
        fwd = forward_of(v)
        if fwd not in segs:
            segs[fwd] = MK.composite_fwd_variant(inst, start, nblk, grid, fwd,
                                                 checkpoints=True)[1]
    shipped = C.composite_bwd(inst, start, nblk, out, dout, grid, seg)
    calls = {"shipped": lambda: C.composite_bwd(inst, start, nblk, out, dout, grid, seg)}
    launched = {}
    for v in variants:
        kernel = kernel_of(v)
        if kernel not in launched:  # the vpu variants are full's launch
            launched[kernel] = v
            calls[kernel] = lambda v=v: composite_bwd_variant(
                inst, start, nblk, out, dout, grid, v, segs[forward_of(v)])
    ms = rounds_ms(calls, iters)
    counts = {f: composite_counts(inst, start, segs[f], grid, 4)
              for f in {forward_of(v) for v in variants} | {"full"}}
    full_ms = ms.get("full")
    result = {}
    for v in variants:
        kernel = kernel_of(v)
        result[v] = {"ms": ms[kernel],
                     "ms_saved_vs_full": None if full_ms is None else full_ms - ms[kernel],
                     "walked_blocks": int(segs[forward_of(v)].walked.sum()),
                     "forward": forward_of(v), **variant_bound(counts[forward_of(v)], v)}
        if kernel != v:
            result[v]["kernel"] = (f"launches {kernel}: the TPU variant moves work to its "
                                   f"vector unit, and a GPU has one unit for both")
    measured = {**MK.buffer_facts(grid, bins), "deepest_tile_blocks": int(nblk.max()),
                "early_stop_eps": grid.early_stop_eps, "variants": result,
                "shipped": {"ms": ms["shipped"]}}
    if "full" in launched:
        got = composite_bwd_variant(inst, start, nblk, out, dout, grid, "full", seg)
        if not torch.equal(got, shipped):
            raise AssertionError("microbench_bwdk: full's columns differ from the shipped "
                                 "kernel's")
        measured["full_vs_shipped"] = {"columns_bit_for_bit": True,
                                       "ms_ratio": full_ms / ms["shipped"]}
    measured["bound"] = {"of": "the shipped function", **variant_bound(counts["full"], "full")}
    measured["pairs"] = pair_shares(counts["full"])
    return measured


def parse_args(argv=None):
    def early_stop(ap):
        ap.add_argument("--early-stop", type=float, default=1e-4)

    return MK.tool_args(argv, __doc__, VARIANTS, DEFAULT_VARIANTS, extra=early_stop)


def main(argv=None) -> int:
    from splatapult_tpu_torch.tools.profile_bin import report, setup

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_bwdk: no CUDA device (GPU only: a host timing would not be a "
              "device number)", file=sys.stderr)
        return 1
    scene, cam, cfg, calibrated = setup(args, tile_size=args.tile_size,
                                        tile_block=args.tile_block,
                                        early_stop_eps=args.early_stop)
    measured = measure(scene, cam, cfg, args.iters, args.variants)
    MK.print_lines("microbench_bwdk", args, measured)
    return report("microbench_bwdk", args, scene, cfg, calibrated,
                  {**measured, "iters": args.iters, "tile_size": args.tile_size,
                   "tile_block": args.tile_block})


if __name__ == "__main__":
    sys.exit(main())
