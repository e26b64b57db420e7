"""Tile-binned front-to-back alpha compositing (forward).

This stage replaces the reference's entire per-pixel GPU stage — the
geometry-shader quad expansion (shader/splat_geom.glsl:83-106), the fragment
shader's gaussian evaluation (shader/splat_frag.glsl:20-28) and the fixed-
function back-to-front "over" blending (src/app.cpp:153-156) — with an explicit
per-tile transmittance loop.

Dataflow (see ops/binning.py for how the work-list is built):
- The instance buffer is a FLAT list of B-instance blocks, sorted by tile.
  Each block belongs to exactly one tile (lists are B-aligned with null
  instances), so there is no masking anywhere: null instances carry weight 0
  and are no-ops.
- Each tile walks its own blocks front to back carrying (premultiplied RGB,
  transmittance T) per pixel.

Feature parameterization: the opacity rides inside the exponent —
  w = exp(qa*dx^2 + qb*dx*dy + qc*dy^2 + ln(alpha))
with qa = -a/2, qb = -b, qc = -c/2 from the conic (a, b, c). This fuses the
alpha multiply into the exp and makes the 1/256 discard (shader/splat_frag.glsl:
38-41) a comparison on the exponent.

Layouts (B = block, P = tile_size^2 pixels):
  instance features  [Mcap, 16] f32, cols: mean_x, mean_y, qa, qb, qc,
                     ln_alpha, r, g, b, 0...  (null row: ln_alpha = -100)
  per-tile output    [T, 8, P] f32, rows: premult r, g, b, alpha, T, 0, 0, 0

The backward (the transmittance-replay kernel of the JAX package and its
per-splat reduction tail) arrives with the training slice; until then a
backward through composite_from_feats raises.
"""

from __future__ import annotations

import math

import torch

from splatapult_tpu_torch import kernels
from splatapult_tpu_torch.ops.binning import TileGrid

NUM_FEATS = 16
OUT_ROWS = 8
NULL_LN_ALPHA = -100.0  # exp(-100) underflows to (sub)zero weight in float32
# feature column indices
F_MX, F_MY, F_QA, F_QB, F_QC, F_LNA, F_R, F_G, F_B = range(9)


def _check_supported(grid: TileGrid) -> None:
    """Row layouts and accumulation types that later slices port."""
    if grid.packed_colors:
        raise NotImplementedError(
            "packed_colors is not ported yet (ROADMAP: 'packed_colors / "
            "packed_feats16 / bf16 accumulation in B2')")
    if grid.packed_feats16:
        raise NotImplementedError(
            "packed_feats16 is not ported yet (ROADMAP: 'packed_colors / "
            "packed_feats16 / bf16 accumulation in B2')")
    if grid.accum_dtype != "float32":
        raise NotImplementedError(
            "accum_dtype='bfloat16' is not ported yet (ROADMAP: "
            "'packed_colors / packed_feats16 / bf16 accumulation in B2')")


def tile_block_ranges(tile_count: torch.Tensor, block: int):
    """Per-tile block range in the tile-sorted instance buffer ->
    (tile_start [T] int32, tile_nblk [T] int32): tile t owns blocks
    [tile_start[t], tile_start[t] + tile_nblk[t])."""
    nblk = torch.div(tile_count + (block - 1), block, rounding_mode="floor").to(torch.int32)
    start = torch.cumsum(nblk, 0, dtype=torch.int32) - nblk
    return start, nblk


def _pixel_coords(grid: TileGrid, device):
    """gl_FragCoord-style pixel centers of every tile -> ([T, P] x, [T, P] y)."""
    ts = grid.tile_size
    t = torch.arange(grid.num_tiles, device=device)
    tcx = (t % grid.tiles_x).to(torch.float32) * ts + 0.5 * ts
    tcy = grid.height - torch.div(t, grid.tiles_x, rounding_mode="floor").to(torch.float32) * ts - 0.5 * ts
    pidx = torch.arange(grid.tile_pixels, device=device)
    u = (pidx % ts).to(torch.float32) + 0.5 - 0.5 * ts
    v = 0.5 * ts - torch.div(pidx, ts, rounding_mode="floor").to(torch.float32) - 0.5
    return tcx[:, None] + u[None, :], tcy[:, None] + v[None, :]


def composite_fwd_plain(inst, tile_start, tile_nblk, grid: TileGrid):
    """Plain PyTorch version of the composite forward kernel -> [T, 8, P].

    The same per-block arithmetic as the kernel, looping over block rank
    within tile so that all tiles advance together; the within-block
    front-to-back products are an exclusive cumprod along the instance axis.
    """
    _check_supported(grid)
    dev = inst.device
    num_tiles, b, p = grid.num_tiles, grid.block, grid.tile_pixels
    px, py = _pixel_coords(grid, dev)  # [T, P]
    color = torch.zeros((num_tiles, 3, p), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    blocks = inst.reshape(-1, b, inst.shape[1])
    nb = blocks.shape[0]
    ln_cut = math.log(grid.alpha_cutoff) if grid.alpha_cutoff > 0.0 else None
    # the deepest tile sets the loop length (one readback: this version is the
    # host path and the kernel's yardstick, never the CUDA render path)
    max_rank = int(tile_nblk.max()) if num_tiles > 0 else 0
    for rank in range(max_rank):
        active = rank < tile_nblk  # [T]
        if grid.early_stop_eps > 0.0 and rank > 0:
            active = active & (trans.amax(dim=1) >= grid.early_stop_eps)
        f = blocks[torch.clamp(tile_start + rank, 0, nb - 1).long()]  # [T, B, F]
        dx = px[:, None, :] - f[:, :, F_MX, None]  # [T, B, P]
        dy = py[:, None, :] - f[:, :, F_MY, None]
        qh = (f[:, :, F_QA, None] * dx * dx + f[:, :, F_QB, None] * dx * dy
              + f[:, :, F_QC, None] * dy * dy + f[:, :, F_LNA, None])
        w = torch.exp(qh)
        if ln_cut is not None:
            w = torch.where(qh > ln_cut, w, 0.0)
        w = torch.where(active[:, None, None], w, 0.0)
        one_minus = 1.0 - w
        incl = torch.cumprod(one_minus, dim=1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        eff = trans[:, None, :] * excl * w  # [T, B, P]
        color = color + torch.einsum("tbc,tbp->tcp", f[:, :, F_R:F_R + 3], eff)
        trans = trans * incl[:, -1]
    zeros = torch.zeros((num_tiles, 3, p), dtype=torch.float32, device=dev)
    return torch.cat([color, (1.0 - trans)[:, None], trans[:, None], zeros], dim=1)


def composite_fwd(inst, tile_start, tile_nblk, grid: TileGrid):
    """Composite forward over the tile-sorted instance buffer -> [T, 8, P] f32.

    The port of splatapult_tpu/ops/composite.py::_fwd_kernel (via _fwd_call).
    On a CUDA tensor this launches the hand-written kernel
    (kernels/csrc/composite_fwd.cu) on the current stream, without
    synchronizing, or raises; the plain version runs only for CPU tensors.
    """
    _check_supported(grid)
    if inst.dtype != torch.float32 or inst.ndim != 2 or inst.shape != (grid.mcap, NUM_FEATS):
        raise ValueError(
            f"composite_fwd takes inst [mcap={grid.mcap}, {NUM_FEATS}] float32, "
            f"got {tuple(inst.shape)} {inst.dtype}")
    for name, a in (("tile_start", tile_start), ("tile_nblk", tile_nblk)):
        if a.dtype != torch.int32 or a.shape != (grid.num_tiles,) or a.device != inst.device:
            raise ValueError(
                f"composite_fwd takes {name} [T={grid.num_tiles}] int32 on "
                f"{inst.device}, got {tuple(a.shape)} {a.dtype} {a.device}")
    if inst.device.type == "cpu":
        return composite_fwd_plain(inst, tile_start, tile_nblk, grid)
    if inst.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {inst.device}")
    if grid.tile_pixels > 1024:
        raise ValueError("composite_fwd kernel supports tiles up to 32 x 32 pixels")
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load()
    inst = inst.contiguous()
    tile_start = tile_start.contiguous()
    tile_nblk = tile_nblk.contiguous()
    # deepest tiles first: a tile's instances are a serial chain, so the long
    # chains must start at once (see the kernel's source note)
    tile_order = torch.argsort(tile_nblk, descending=True, stable=True).to(torch.int32)
    out = torch.empty((grid.num_tiles, OUT_ROWS, grid.tile_pixels),
                      dtype=torch.float32, device=inst.device)
    use_cutoff = grid.alpha_cutoff > 0.0
    with torch.cuda.device(inst.device):
        code = lib.splat_composite_fwd(
            inst.data_ptr(), tile_start.data_ptr(), tile_nblk.data_ptr(),
            tile_order.data_ptr(), out.data_ptr(), grid.num_tiles, grid.tiles_x, grid.tile_size,
            grid.height, grid.block,
            math.log(grid.alpha_cutoff) if use_cutoff else 0.0, int(use_cutoff),
            float(grid.early_stop_eps), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "composite_fwd")
    kernels.LAUNCH_COUNTS["composite_fwd"] += 1
    return out


class _ForwardOnlyComposite(torch.autograd.Function):
    """Gather + composite forward whose backward raises: the hand-written
    backward kernel belongs to the training slice, and silent zero gradients
    would be worse than an error."""

    @staticmethod
    def forward(ctx, feats, inst_splat, tile_count, grid):
        inst = feats[inst_splat.long()]
        start, nblk = tile_block_ranges(tile_count, grid.block)
        return composite_fwd(inst, start, nblk, grid)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "composite_from_feats has no backward yet: the backward arrives "
            "with the training slice (ROADMAP: 'training: B3 + _cff_bwd tail "
            "+ train.py')")


def composite_from_feats(feats, bins, grid: TileGrid):
    """Tile-binned composite from per-splat features -> per-tile [T, 8, P].

    feats is [N + 1, 16] (last row = null splat); ``bins`` is the dict from
    ops.binning.bin_splats. One row gather builds the instance buffer, then
    the composite forward kernel runs over it. Forward only: differentiating
    through it raises.
    """
    return _ForwardOnlyComposite.apply(
        feats, bins["inst_splat"], bins["tile_count"], grid)
