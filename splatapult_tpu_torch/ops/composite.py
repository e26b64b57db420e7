"""Tile-binned front-to-back alpha compositing, forward and backward.

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
  instance features  one of three row layouts (num_feats, unpack_feats):
                     [Mcap, 16] f32, cols: mean_x, mean_y, qa, qb, qc,
                     ln_alpha, r, g, b, 0...  (null row: ln_alpha = -100);
                     with grid.packed_colors [Mcap, 8] int32 (pack_color_feats:
                     the geometry bit for bit, colours 16-bit fixed point);
                     with grid.packed_feats16 [Mcap, 4] int32 (pack_feats16:
                     every field quantized)
  per-tile output    [T, 8, P] f32, or bf16 with grid.accum_dtype="bfloat16",
                     rows: premult r, g, b, alpha, T, 0, 0, 0

  instance gradients [9, Mcap] f32, rows: d_mean_x, d_mean_y, d_qa, d_qb,
                     d_qc, d_ln_alpha, d_r, d_g, d_b (instance order)

A tile's chain is cut into segments of SEGMENT_BLOCKS blocks
(first_segments). The forward runs in two kernels: every segment walked on
its own from colour 0 and T = 1 gives a "local" (colour, T)
(composite_fwd_segments), and one pass per tile scans the locals in order,
C += T * c, T *= t, into the rows (combine_segments); in training that scan
leaves the state before every segment, its checkpoint (Segments), and decides
the early stop.

Backward: the transmittance-replay kernel re-walks each tile front to back
and emits nine gradient columns per instance; a sort-and-difference tail
(per_splat_sums) turns them into per-splat feature gradients. The backward
kernel walks each segment in a CTA of its own, started from its checkpoint.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from splatapult_tpu_torch import kernels
from splatapult_tpu_torch.ops.binning import TileGrid, run_stage

NUM_FEATS = 16
# packed_colors: the geometry's six f32 bit patterns and RGB as 16-bit fixed
# point (step 2^-12, range +-8) in 8 int32 = 32 B rows
NUM_FEATS_PACKED = 8
COLOR_SCALE = 4096.0
# packed_feats16: every field quantized into 4 int32 = 16 B rows:
#   w0: mean_x << 16 | mean_y, unsigned 16-bit fixed point over [-W, 2W) x
#       [-H, 2H) (step 3W/65536, 3H/65536)
#   w1: f16(qa) << 16 | f16(qb);  w2: f16(qc) << 16 | f16(ln_alpha)
#   w3: r:11 | g:11 | b:10, unsigned fixed point over [-4, 4)
# (the null row's ln_alpha = -100 is an f16 value: it survives exactly)
NUM_FEATS_PACKED16 = 4
MEAN16_STEPS = 65536.0
COLOR11_SCALE = 256.0  # 11-bit channels: step 1/256 over [-4, 4)
COLOR10_SCALE = 128.0  # 10-bit channel: step 1/128 over [-4, 4)
OUT_ROWS = 8
NUM_GRAD_COLS = 9  # d_mx, d_my, d_qa, d_qb, d_qc, d_lna, dr, dg, db
_PREFIX_BLOCK = 1024  # slots per block of the tail's two-level prefix sum (divides emax)
NULL_LN_ALPHA = -100.0  # exp(-100) underflows to (sub)zero weight in float32
# blocks per segment of a tile's chain; the kernels' kSegBlocks
# (kernels/csrc/segments.cuh), whose launchers refuse any other value
SEGMENT_BLOCKS = 8
# feature column indices
F_MX, F_MY, F_QA, F_QB, F_QC, F_LNA, F_R, F_G, F_B = range(9)


def num_feats(grid: TileGrid) -> int:
    """Columns of an instance row in the grid's layout (16 f32, 8 or 4 int32)."""
    if grid.packed_feats16:
        return NUM_FEATS_PACKED16
    return NUM_FEATS_PACKED if grid.packed_colors else NUM_FEATS


def _out_dtype(grid: TileGrid) -> torch.dtype:
    """The dtype of the forward's rows (the JAX package's _acc_dtype)."""
    return torch.bfloat16 if grid.accum_dtype == "bfloat16" else torch.float32


def _mean16_scales(grid: TileGrid):
    """(sx, sy): steps per pixel of the 16-bit mean fields, as the JAX package
    computes them (Python floats; the arithmetic rounds them to f32)."""
    return MEAN16_STEPS / (3.0 * grid.width), MEAN16_STEPS / (3.0 * grid.height)


def mean16_steps(grid: TileGrid):
    """(step_x, step_y): pixels per step of the 16-bit mean fields, 3W/65536
    and 3H/65536 computed as the JAX decode computes them (1 / scale, rounded
    to f32 where it is used). The kernels take these from the wrapper."""
    sx, sy = _mean16_scales(grid)
    return 1.0 / sx, 1.0 / sy


def _wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) or [-2^31, 2^31) -> the int32 of the same low
    32 bits (torch has little uint32 arithmetic: the fields are put together
    in int64 and wrapped once)."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the f16 bit pattern (round to nearest even) as int64 in [0, 2^16)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _bits_f16(h: torch.Tensor) -> torch.Tensor:
    """int64 f16 bit patterns in [0, 2^16) -> f32 (exact, subnormals included)."""
    return torch.where(h >= 2 ** 15, h - 2 ** 16, h).to(torch.int16).view(
        torch.float16).to(torch.float32)


def _fixed(x: torch.Tensor, scale: float, lo: float, hi: float) -> torch.Tensor:
    """round(x * scale) (half to even, as jnp.round) clipped to [lo, hi] -> int64."""
    return torch.clamp(torch.round(x * scale), lo, hi).to(torch.int64)


def pack_color_feats(feats: torch.Tensor) -> torch.Tensor:
    """[*, 16] f32 feature rows -> [*, 8] int32: columns 0-5 the geometry's
    f32 bit patterns, RGB as three 16-bit fixed-point halves in columns 6-7
    (r << 16 | g, b << 16). The same words as the JAX package's
    _pack_color_feats, bit for bit."""
    q = _fixed(feats[:, F_R:F_B + 1], COLOR_SCALE, -32768.0, 32767.0)
    colour = torch.stack([(q[:, 0] << 16) | (q[:, 1] & 0xFFFF), q[:, 2] << 16], dim=1)
    geo = feats[:, :6].contiguous().view(torch.int32)
    return torch.cat([geo, _wrap_int32(colour)], dim=1)


def pack_feats16(feats: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[*, 16] f32 feature rows -> [*, 4] int32 (see NUM_FEATS_PACKED16). The
    same words as the JAX package's _pack_feats16, bit for bit. Means outside
    [-W, 2W) x [-H, 2H) clip to its edge; a splat the projection culled has
    ln_alpha = ln(1e-37), under the discard wherever its mean lands."""
    sx, sy = _mean16_scales(grid)
    qx = _fixed(feats[:, F_MX] + grid.width, sx, 0.0, 65535.0)
    qy = _fixed(feats[:, F_MY] + grid.height, sy, 0.0, 65535.0)
    qr = _fixed(feats[:, F_R] + 4.0, COLOR11_SCALE, 0.0, 2047.0)
    qg = _fixed(feats[:, F_G] + 4.0, COLOR11_SCALE, 0.0, 2047.0)
    qb = _fixed(feats[:, F_B] + 4.0, COLOR10_SCALE, 0.0, 1023.0)
    words = torch.stack([
        (qx << 16) | qy,
        (_f16_bits(feats[:, F_QA]) << 16) | _f16_bits(feats[:, F_QB]),
        (_f16_bits(feats[:, F_QC]) << 16) | _f16_bits(feats[:, F_LNA]),
        (qr << 21) | (qg << 10) | qb,
    ], dim=1)
    return _wrap_int32(words)


def pack_src(feats: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """The feature table in the grid's row layout, ready for the row gather."""
    if grid.packed_feats16:
        return pack_feats16(feats, grid)
    return pack_color_feats(feats) if grid.packed_colors else feats


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] for a contiguous row table src [N, F] whose rows are a
    multiple of 16 bytes (every layout: 64, 32 or 16 B), idx [M] int64 ->
    [M, F]. The rows are moved as 16-byte elements out of a 1-D view of the
    table: on an H100 torch's indexing of [N, F] rows took 1.72 ms for the
    2.83M slots of a 1080p garden view whatever the row size, while a gather
    of one 16-byte element per slot from a 1-D tensor took 0.05 ms
    (tools/profile_phases.py, phases row_gather*)."""
    per_row = src.shape[1] * src.element_size() // 16
    flat = src.contiguous().view(torch.complex128).reshape(-1)
    if per_row == 1:
        at = idx
    else:
        at = idx[:, None] * per_row + torch.arange(per_row, device=idx.device)
    return flat[at].reshape(-1, per_row).view(src.dtype)


def unpack_feats(raw: torch.Tensor, grid: TileGrid):
    """Rows in the grid's layout -> (geometry [*, 6] f32: mean_x, mean_y, qa,
    qb, qc, ln_alpha; colours [*, 3] f32). The same values as the JAX
    package's _unpack_feats, bit for bit: the f16 fields are widened exactly
    (IEEE f16 -> f32), the fixed-point fields scaled as JAX scales them."""
    if num_feats(grid) == NUM_FEATS:
        return raw[:, :6], raw[:, F_R:F_B + 1]
    if not grid.packed_feats16:
        w6, w7 = raw[:, 6].to(torch.int64), raw[:, 7].to(torch.int64)
        q = torch.stack([w6 >> 16, ((w6 & 0xFFFF) ^ 0x8000) - 0x8000, w7 >> 16], dim=1)
        return raw[:, :6].view(torch.float32), q.to(torch.float32) * (1.0 / COLOR_SCALE)
    u = raw.to(torch.int64) & 0xFFFFFFFF
    step_x, step_y = mean16_steps(grid)
    geo = torch.stack([
        ((u[:, 0] >> 16) & 0xFFFF).to(torch.float32) * step_x - grid.width,
        (u[:, 0] & 0xFFFF).to(torch.float32) * step_y - grid.height,
        _bits_f16((u[:, 1] >> 16) & 0xFFFF), _bits_f16(u[:, 1] & 0xFFFF),
        _bits_f16((u[:, 2] >> 16) & 0xFFFF), _bits_f16(u[:, 2] & 0xFFFF),
    ], dim=1)
    colours = torch.stack([
        ((u[:, 3] >> 21) & 0x7FF).to(torch.float32) * (1.0 / COLOR11_SCALE) - 4.0,
        ((u[:, 3] >> 10) & 0x7FF).to(torch.float32) * (1.0 / COLOR11_SCALE) - 4.0,
        (u[:, 3] & 0x3FF).to(torch.float32) * (1.0 / COLOR10_SCALE) - 4.0,
    ], dim=1)
    return geo, colours


def _decoded_rows(inst: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Instance rows in any layout -> [*, 9] f32 (mean_x .. b, columns F_MX ..
    F_B): what the plain versions walk."""
    return torch.cat(unpack_feats(inst, grid), dim=1)


def _round_state(color, trans, grid: TileGrid):
    """The carried (colour, T) rounded to the rows' dtype and back to f32
    (round to nearest even): bf16 accumulation rounds it once per segment."""
    if grid.accum_dtype != "bfloat16":
        return color, trans
    return color.to(torch.bfloat16).float(), trans.to(torch.bfloat16).float()


def tile_block_ranges(tile_count: torch.Tensor, block: int):
    """Per-tile block range in the tile-sorted instance buffer ->
    (tile_start [T] int32, tile_nblk [T] int32): tile t owns blocks
    [tile_start[t], tile_start[t] + tile_nblk[t])."""
    nblk = torch.div(tile_count + (block - 1), block, rounding_mode="floor").to(torch.int32)
    start = torch.cumsum(nblk, 0, dtype=torch.int32) - nblk
    return start, nblk


class Segments(NamedTuple):
    """What the forward leaves for the backward at the cuts of the tiles'
    chains (S = num_segments_cap(grid); segment numbers: first_segments)."""

    # [S, 4, P] f32: (r, g, b so far, T) of every pixel before the segment's
    # first block; written only for segments the forward reached
    ckpt: torch.Tensor
    # [T] int32: blocks the forward walked (< tile_nblk where the early stop
    # ended the tile); the backward walks exactly these
    walked: torch.Tensor


def num_segments_cap(grid: TileGrid) -> int:
    """Static bound on a view's segment numbers (see first_segments): the size
    of the checkpoint buffer and of the backward kernel's grid."""
    return grid.num_blocks // SEGMENT_BLOCKS + grid.num_tiles


def first_segments(tile_start: torch.Tensor) -> torch.Tensor:
    """Number of every tile's first segment -> [T] int32; segment j of tile t
    (its blocks [j K, (j + 1) K), K = SEGMENT_BLOCKS) is number
    first_segments[t] + j. The kernels compute the same from tile_start[t] and
    t alone (kernels/csrc/segments.cuh), so no table is built on the render
    path: tile_start[t] // K + t. Consecutive tiles' numbers differ by
    floor((start + nblk) / K) - floor(start / K) + 1 >= ceil(nblk / K), so no
    two segments share a number, and the largest stays below
    num_blocks // K + T = num_segments_cap."""
    t = torch.arange(tile_start.shape[0], dtype=torch.int32, device=tile_start.device)
    return torch.div(tile_start, SEGMENT_BLOCKS, rounding_mode="floor").to(torch.int32) + t


def segment_table(tile_start, tile_nblk, grid: TileGrid):
    """The map the backward kernel's CTAs make for themselves, segment number
    -> (tile, first block), for every number below num_segments_cap ->
    (seg_tile [S], seg_blk0 [S], live [S] bool). CTA s takes the last tile
    whose first segment number is <= s and the block (s - that number) * K;
    the number belongs to a segment (``live``) iff that block exists in the
    tile's chain, and otherwise the CTA exits. (Plain PyTorch for tests and
    checks; nothing on the render path calls it.)"""
    seg0 = first_segments(tile_start)
    s = torch.arange(num_segments_cap(grid), dtype=torch.int32, device=tile_start.device)
    seg_tile = (torch.searchsorted(seg0, s, right=True) - 1).to(torch.int32)
    seg_blk0 = (s - seg0[seg_tile.long()]) * SEGMENT_BLOCKS
    return seg_tile, seg_blk0, seg_blk0 < tile_nblk[seg_tile.long()]


def _local_coords(grid: TileGrid, device):
    """Tile-local pixel-centre offsets from the tile centre -> ([P] u, [P] v)."""
    ts = grid.tile_size
    pidx = torch.arange(grid.tile_pixels, device=device)
    u = (pidx % ts).to(torch.float32) + 0.5 - 0.5 * ts
    v = 0.5 * ts - torch.div(pidx, ts, rounding_mode="floor").to(torch.float32) - 0.5
    return u, v


def _tile_centers(grid: TileGrid, device):
    """Centre of every tile in gl screen coordinates (+y up) -> ([T], [T])."""
    ts = grid.tile_size
    t = torch.arange(grid.num_tiles, device=device)
    tcx = (t % grid.tiles_x).to(torch.float32) * ts + 0.5 * ts
    tcy = grid.height - torch.div(t, grid.tiles_x, rounding_mode="floor").to(torch.float32) * ts - 0.5 * ts
    return tcx, tcy


def _pixel_coords(grid: TileGrid, device):
    """gl_FragCoord-style pixel centers of every tile -> ([T, P] x, [T, P] y)."""
    tcx, tcy = _tile_centers(grid, device)
    u, v = _local_coords(grid, device)
    return tcx[:, None] + u[None, :], tcy[:, None] + v[None, :]


def _block_weights(f, px, py, active, grid: TileGrid):
    """Per-(instance, pixel) weights w = alpha * g of one block per tile:
    f [T, B, F] rows, px/py [T, P] -> [T, B, P]; 0 below the 1/256 discard
    (a comparison on the exponent) and for tiles that are not ``active``."""
    dx = px[:, None, :] - f[:, :, F_MX, None]
    dy = py[:, None, :] - f[:, :, F_MY, None]
    qh = (f[:, :, F_QA, None] * dx * dx + f[:, :, F_QB, None] * dx * dy
          + f[:, :, F_QC, None] * dy * dy + f[:, :, F_LNA, None])
    if grid.alpha_cutoff > 0.0:
        # the discarded weights are 0 whatever exp gives them, so their
        # exponents are clamped at the cutoff first: on the CPU, exp of large
        # negative arguments takes a slow path (about 40x), and most
        # (instance, pixel) pairs of a block lie there. The kept weights are
        # the same bits.
        cut = math.log(grid.alpha_cutoff)
        w = torch.where(qh > cut, torch.exp(torch.clamp_min(qh, cut)), 0.0)
    else:
        w = torch.exp(qh)
    return torch.where(active[:, None, None], w, 0.0)


def composite_fwd_plain(inst, tile_start, tile_nblk, grid: TileGrid, checkpoints=False):
    """Plain PyTorch version of the composite forward kernel -> [T, 8, P] in
    the rows' dtype, or with ``checkpoints`` -> ([T, 8, P], Segments) as the
    kernel leaves them (checkpoints of segments the forward did not reach are
    zero here, unwritten there).

    The serial walk of every tile's whole chain, looping over block rank
    within tile so that all tiles advance together (_blend_block). The
    kernels cut the chains into segments and combine them
    (composite_fwd_segments_plain, combine_segments_plain); this is the
    yardstick both are held to. Rows in any layout are decoded first
    (unpack_feats). With bf16 accumulation the carried (colour, T) is
    rounded to bf16 where the combine rounds it, after every SEGMENT_BLOCKS
    blocks, and the rows are bf16. (The JAX kernel rounds after every block:
    the segmented design rounds a K-th as often, by design.)
    """
    return _serial_walk(_decoded_rows(inst, grid), tile_start, tile_nblk, grid, checkpoints)


def _serial_walk(rows, tile_start, tile_nblk, grid: TileGrid, checkpoints=False, blend=None):
    """composite_fwd_plain on decoded rows [mcap, 9]; ``blend`` takes
    _blend_block's arguments and stands in for it (the ablation tools' plain
    versions swap the per-block arithmetic so)."""
    blend = _blend_block if blend is None else blend
    dev = rows.device
    num_tiles, b, p = grid.num_tiles, grid.block, grid.tile_pixels
    px, py = _pixel_coords(grid, dev)  # [T, P]
    color = torch.zeros((num_tiles, 3, p), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    blocks = rows.reshape(-1, b, rows.shape[1])
    nb = blocks.shape[0]
    if checkpoints:
        tile_seg0 = first_segments(tile_start)
        ckpt = torch.zeros((num_segments_cap(grid), 4, p), dtype=torch.float32, device=dev)
        walked = torch.zeros_like(tile_nblk)
    # the deepest tile sets the loop length (one readback: this version is the
    # host path and the kernel's yardstick, never the CUDA render path)
    max_rank = int(tile_nblk.max()) if num_tiles > 0 else 0
    for rank in range(max_rank):
        active = rank < tile_nblk  # [T]
        if grid.early_stop_eps > 0.0 and rank > 0:
            active = active & (trans.amax(dim=1) >= grid.early_stop_eps)
        if checkpoints:
            walked += active  # T never grows: a stopped tile stays stopped
            if rank % SEGMENT_BLOCKS == 0:
                at = (tile_seg0 + rank // SEGMENT_BLOCKS)[active].long()
                ckpt[at] = torch.cat([color, trans[:, None]], dim=1)[active]
        f = blocks[torch.clamp(tile_start + rank, 0, nb - 1).long()]  # [T, B, 9]
        color, trans = blend(f, px, py, active, color, trans, grid)
        if (rank + 1) % SEGMENT_BLOCKS == 0:
            # a segment boundary (rounding the state of a tile that stopped or
            # ended before it again changes nothing its rows show)
            color, trans = _round_state(color, trans, grid)
    out = _rows(color, trans, grid)
    if checkpoints:
        return out, Segments(ckpt, walked)
    return out


def _blend_block(f, px, py, active, color, trans, grid: TileGrid):
    """One block of decoded rows per tile, f [T, B, 9], blended front to back
    into the state (colour [T, 3, P], T [T, P]) -> the state after it; tiles
    that are not ``active`` keep theirs bit for bit (their weights are 0). The
    within-block products are an exclusive cumprod along the instance axis."""
    w = _block_weights(f, px, py, active, grid)  # [T, B, P]
    incl = torch.cumprod(1.0 - w, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    eff = trans[:, None, :] * excl * w  # [T, B, P]
    color = color + torch.einsum("tbc,tbp->tcp", f[:, :, F_R:F_R + 3], eff)
    return color, trans * incl[:, -1]


def _rows(color, trans, grid: TileGrid):
    """The forward's output rows (r, g, b, 1 - T, T, 0, 0, 0) -> [T, 8, P] in
    the rows' dtype (each value computed in f32, then rounded)."""
    zeros = torch.zeros_like(color)
    rows = torch.cat([color, (1.0 - trans)[:, None], trans[:, None], zeros], dim=1)
    return rows.to(_out_dtype(grid))


def composite_fwd_segments_plain(inst, tile_start, tile_nblk, grid: TileGrid):
    """Plain PyTorch version of the segment pass -> locals [S, 4, P] f32
    (S = num_segments_cap(grid)): row first_segments[t] + j holds
    (r, g, b, T) of segment j of tile t — its blocks [j K, min((j + 1) K,
    nblk)) walked from colour 0 and T = 1, with no early stop. Numbers that
    belong to no segment hold zeros here (the kernel leaves them unwritten).
    The locals are f32 whatever the rows' dtype: per-segment arithmetic is
    f32, and the combine rounds."""
    whole = dataclasses.replace(grid, early_stop_eps=0.0, accum_dtype="float32")
    decoded = _decoded_rows(inst, grid)
    seg0 = first_segments(tile_start)
    locs = torch.zeros((num_segments_cap(grid), 4, grid.tile_pixels), dtype=torch.float32,
                       device=inst.device)
    max_nblk = int(tile_nblk.max()) if grid.num_tiles > 0 else 0  # host path: one readback
    for j in range(-(-max_nblk // SEGMENT_BLOCKS)):
        b0 = j * SEGMENT_BLOCKS
        rows = _serial_walk(decoded, tile_start + b0,
                            torch.clamp(tile_nblk - b0, 0, SEGMENT_BLOCKS), whole)
        has = tile_nblk > b0
        locs[(seg0 + j)[has].long()] = rows[has][:, [0, 1, 2, 4]]
    return locs


def combine_segments_plain(locs, inst, tile_start, tile_nblk, grid: TileGrid,
                           checkpoints=False):
    """Plain PyTorch version of the combine pass -> [T, 8, P] in the rows'
    dtype, or with ``checkpoints`` -> ([T, 8, P], Segments(locs, walked)).

    Scans every tile's locals (composite_fwd_segments) in order per pixel:
    C += T * c, T *= t, each product and sum rounded on its own. With
    ``checkpoints`` the state before every segment the scan applies is
    written over that segment's local in ``locs``, in place: it becomes the
    backward's checkpoint. The early stop (eps > 0): j* is the first segment
    boundary j >= 1 (the chain's end counts as one) where every pixel has
    T < eps. The serial walk's stop then lies inside segment j* - 1 or at
    block j* K, so that one segment is walked again from its prefix with the
    per-block vote; where the vote ends it at block b, walked = b and the rows
    are the state there, otherwise walked = min(j* K, nblk) and the rows are
    the prefix at j*. Without a j*, walked = nblk. Checkpoints after segment
    j* - 1 keep their locals (the backward never reads them). With bf16
    accumulation the state is rounded to bf16 after every segment the scan
    applies (the checkpoints hold the rounded state), before the vote.
    """
    dev = locs.device
    num_tiles, nsegs, eps = grid.num_tiles, locs.shape[0], grid.early_stop_eps
    seg0 = first_segments(tile_start)
    nseg = torch.div(tile_nblk + SEGMENT_BLOCKS - 1, SEGMENT_BLOCKS, rounding_mode="floor")
    color = torch.zeros((num_tiles, 3, grid.tile_pixels), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, grid.tile_pixels), dtype=torch.float32, device=dev)
    before = (color, trans)  # the state before the last segment each tile applied
    stop_seg = torch.zeros_like(tile_nblk)  # j* per tile, 0: none
    max_seg = int(nseg.max()) if num_tiles > 0 else 0  # host path: one readback
    for j in range(max_seg):
        active = (j < nseg) & (stop_seg == 0)  # [T]
        at = (seg0 + j).clamp_max(nsegs - 1).long()
        loc = locs[at]  # [T, 4, P]
        if checkpoints:
            locs[at[active]] = torch.cat([color, trans[:, None]], dim=1)[active]
        before = (torch.where(active[:, None, None], color, before[0]),
                  torch.where(active[:, None], trans, before[1]))
        color = torch.where(active[:, None, None], color + trans[:, None] * loc[:, :3], color)
        trans = torch.where(active[:, None], trans * loc[:, 3], trans)
        color, trans = _round_state(color, trans, grid)
        if eps > 0.0:
            stop_seg = torch.where(active & (trans.amax(dim=1) < eps), j + 1, stop_seg)
    walked = tile_nblk.clone()
    stopped = stop_seg > 0
    if bool(stopped.any()):
        # segment j* - 1 once more, from its prefix, with the serial per-block
        # vote (not at its first block: boundary j* - 1 passed the vote)
        b0 = (stop_seg - 1) * SEGMENT_BLOCKS
        b1 = torch.minimum(b0 + SEGMENT_BLOCKS, tile_nblk)
        walked = torch.where(stopped, b1, walked)
        px, py = _pixel_coords(grid, dev)
        blocks = _decoded_rows(inst, grid).reshape(-1, grid.block, 9)
        w_color, w_trans = before
        going = stopped
        for r in range(SEGMENT_BLOCKS):
            going = going & (b0 + r < b1)
            if r > 0:
                ends = going & (w_trans.amax(dim=1) < eps)
                walked = torch.where(ends, b0 + r, walked)
                going = going & ~ends
            f = blocks[torch.clamp(tile_start + b0 + r, 0, blocks.shape[0] - 1).long()]
            w_color, w_trans = _blend_block(f, px, py, going, w_color, w_trans, grid)
        ended = stopped & (walked < b1)
        color = torch.where(ended[:, None, None], w_color, color)
        trans = torch.where(ended[:, None], w_trans, trans)
    out = _rows(color, trans, grid)
    if checkpoints:
        return out, Segments(locs, walked)
    return out


def composite_bwd_plain(inst, tile_start, tile_nblk, out_res, dout, grid: TileGrid,
                        state=None, segments=None, block_step=None):
    """Plain PyTorch version of the composite backward kernel -> [9, mcap].

    All tiles advance together by block rank, as in composite_fwd_plain; the
    within-block prefix product (T before each instance) and prefix sum (S)
    are a cumprod and a cumsum along the instance axis, the pixel sums are
    contractions with the tile-local monomials [u^2, uv, v^2, u, v, 1].
    ``state`` = (T, S), [T, P] each, starts the walk in the middle of the
    chains (the kernel starts every segment so, from the forward's
    checkpoints); the default is their start, T = 1 and S = 0. Only the tests
    pass it, to replay on the CPU what the kernel does per segment (float32
    accumulation only).

    Rows in any layout are decoded first (unpack_feats); ``out_res`` and
    ``dout`` come in the rows' dtype and are widened to f32. With bf16
    accumulation the walk rounds (colour, T) to bf16 at every segment
    boundary and restarts S there from the rounded colour, as the kernel
    starts every segment from the forward's rounded checkpoint.

    ``segments``, the Segments the forward returned, makes the walk start
    every segment from its checkpoint (T, and S = dRGB . colour so far) and
    walk the blocks ``segments.walked`` says, as the kernel does: the kernel's
    exact inputs, for holding it against this version where a rounding
    between two forwards could otherwise differ (bf16 accumulation).

    ``block_step`` takes _bwd_block's arguments and stands in for it (the
    ablation tools' plain versions swap the per-block arithmetic so).
    """
    block_step = _bwd_block if block_step is None else block_step
    bf16 = grid.accum_dtype == "bfloat16"
    if bf16 and state is not None:
        raise ValueError("composite_bwd_plain takes a state with float32 accumulation only")
    if segments is not None:
        seg0 = first_segments(tile_start)
        tile_nblk = segments.walked
    dev = inst.device
    num_tiles, b, p = grid.num_tiles, grid.block, grid.tile_pixels
    px, py = _pixel_coords(grid, dev)  # [T, P]
    tcx, tcy = (c[:, None] for c in _tile_centers(grid, dev))  # [T, 1]
    u, v = _local_coords(grid, dev)  # [P]
    basis = torch.stack([u * u, u * v, v * v, u, v, torch.ones_like(u)], dim=1)  # [P, 6]
    geom = (basis, tcx, tcy)
    out_res, dout = out_res.float(), dout.float()
    d_rgb = dout[:, 0:3, :]  # [T, 3, P]
    kconst = ((dout[:, 3, :] - dout[:, 4, :]) * out_res[:, 4, :]
              - (d_rgb * out_res[:, 0:3, :]).sum(dim=1))  # [T, P]
    if state is None:
        trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
        ssum = torch.zeros((num_tiles, p), dtype=torch.float32, device=dev)
    else:
        trans, ssum = state
    color = torch.zeros((num_tiles, 3, p), dtype=torch.float32, device=dev) if bf16 else None
    blocks = _decoded_rows(inst, grid).reshape(-1, b, 9)
    nb = blocks.shape[0]
    d_blocks = torch.zeros((NUM_GRAD_COLS, nb, b), dtype=torch.float32, device=dev)
    max_rank = int(tile_nblk.max()) if num_tiles > 0 else 0  # host path: one readback
    for rank in range(max_rank):
        if segments is not None and rank % SEGMENT_BLOCKS == 0:
            at = (seg0 + rank // SEGMENT_BLOCKS).clamp_max(segments.ckpt.shape[0] - 1).long()
            ck = segments.ckpt[at]  # [T, 4, P]; written where rank < walked
            going = (rank < tile_nblk)[:, None]
            trans = torch.where(going, ck[:, 3], trans)
            ssum = torch.where(going, (d_rgb * ck[:, :3]).sum(dim=1), ssum)
        elif bf16 and rank > 0 and rank % SEGMENT_BLOCKS == 0:
            color, trans = _round_state(color, trans, grid)
            ssum = (d_rgb * color).sum(dim=1)
        active = rank < tile_nblk  # [T]
        if segments is None and grid.early_stop_eps > 0.0 and rank > 0:
            active = active & (trans.amax(dim=1) >= grid.early_stop_eps)
        f = blocks[torch.clamp(tile_start + rank, 0, nb - 1).long()]  # [T, B, 9]
        cols, eff, trans, ssum = block_step(f, px, py, active, trans, ssum, kconst, d_rgb,
                                            geom, grid)
        if bf16:
            color = color + torch.einsum("tbc,tbp->tcp", f[:, :, F_R:F_R + 3], eff)
        del eff
        # skipped and exhausted tiles keep their zero columns
        d_blocks[:, (tile_start + rank)[active].long()] = cols[:, active]
    return d_blocks.reshape(NUM_GRAD_COLS, nb * b)


def _bwd_block(f, px, py, active, trans, ssum, kconst, d_rgb, geom, grid: TileGrid):
    """One block of decoded rows per tile, f [T, B, 9], of composite_bwd_plain's
    walk from the state (T, S) [T, P] each -> (its nine gradient columns
    [9, T, B], eff [T, B, P], T and S after it). ``geom`` = (basis [P, 6],
    tcx, tcy [T, 1]): the tile-local monomials and the tile centres."""
    w = _block_weights(f, px, py, active, grid)  # [T, B, P]
    one_minus = 1.0 - w
    incl = torch.cumprod(one_minus, dim=1)
    t_before = trans[:, None, :] * torch.cat(
        [torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    eff = t_before * w  # [T, B, P]
    cdot = torch.einsum("tbc,tcp->tbp", f[:, :, F_R:F_R + 3], d_rgb)
    s_incl = ssum[:, None, :] + torch.cumsum(eff * cdot, dim=1)
    dqh = w * ((kconst[:, None, :] + s_incl) / torch.clamp_min(one_minus, 1e-9)
               + t_before * cdot)
    del cdot, t_before, one_minus, w
    cols = _grad_cols(f, dqh, eff, d_rgb, geom)
    return cols, eff, trans * incl[:, -1], s_incl[:, -1]


def _grad_cols(f, dqh, eff, d_rgb, geom):
    """The nine gradient columns [9, T, B] of one block per tile from dqh and
    eff [T, B, P]: the six geometry columns from dqh's pixel sums against the
    tile-local monomials, the three colour columns from eff's."""
    basis, tcx, tcy = geom
    mom = torch.einsum("tbp,pk->tbk", dqh, basis)  # [T, B, 6]
    m_uu, m_uv, m_vv, m_u, m_v, m_1 = mom.unbind(dim=2)  # [T, B] each
    mxu = f[:, :, F_MX] - tcx
    myu = f[:, :, F_MY] - tcy
    qa, qb, qc = f[:, :, F_QA], f[:, :, F_QB], f[:, :, F_QC]
    gx = m_u - mxu * m_1  # sum dqh * dx  (dx = u - mxu)
    gy = m_v - myu * m_1
    return torch.stack([
        -(2.0 * qa * gx + qb * gy),
        -(qb * gx + 2.0 * qc * gy),
        m_uu - 2.0 * mxu * m_u + mxu * mxu * m_1,
        m_uv - mxu * m_v - myu * m_u + mxu * myu * m_1,
        m_vv - 2.0 * myu * m_v + myu * myu * m_1,
        m_1,
        *torch.einsum("tbp,tcp->ctb", eff, d_rgb).unbind(dim=0),
    ])  # [9, T, B]


def _check_kernel_args(name, inst, tile_start, tile_nblk, grid: TileGrid):
    """Argument checks shared by the wrappers -> the device type. The rows
    come in the grid's layout: [mcap, 16] float32, or packed [mcap, 8] /
    [mcap, 4] int32 (int32, as the JAX package keeps them: a gather of
    packed words stays a gather of bytes)."""
    nf = num_feats(grid)
    dtype = torch.float32 if nf == NUM_FEATS else torch.int32
    if inst.dtype != dtype or inst.ndim != 2 or inst.shape != (grid.mcap, nf):
        raise ValueError(
            f"{name} takes inst [mcap={grid.mcap}, {nf}] {dtype} for this grid's "
            f"row layout, got {tuple(inst.shape)} {inst.dtype}")
    for what, a in (("tile_start", tile_start), ("tile_nblk", tile_nblk)):
        if a.dtype != torch.int32 or a.shape != (grid.num_tiles,) or a.device != inst.device:
            raise ValueError(
                f"{name} takes {what} [T={grid.num_tiles}] int32 on "
                f"{inst.device}, got {tuple(a.shape)} {a.dtype} {a.device}")
    if inst.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {inst.device}")
    if inst.device.type == "cuda" and grid.tile_pixels > 1024:
        raise ValueError(f"{name} kernel supports tiles up to 32 x 32 pixels")
    return inst.device.type


def _cutoff_args(grid: TileGrid):
    use_cutoff = grid.alpha_cutoff > 0.0
    return math.log(grid.alpha_cutoff) if use_cutoff else 0.0, int(use_cutoff)


# row layout -> the kernels' layout code (kernels/csrc/row_layout.cuh)
_LAYOUT_CODES = {NUM_FEATS: 0, NUM_FEATS_PACKED: 1, NUM_FEATS_PACKED16: 2}


def _layout_args(grid: TileGrid):
    """The kernels' row-layout arguments: the layout code, then what the
    i32x4 mean decode takes — its steps (mean16_steps: the JAX package's f32
    steps, passed in rather than derived in the kernel) and the offsets W
    and H."""
    step_x, step_y = mean16_steps(grid)
    return (_LAYOUT_CODES[num_feats(grid)], step_x, step_y, float(grid.width),
            float(grid.height))


def _contiguous_aligned(x):
    """The kernels read 16-byte vectors (the segment pass by bulk copies, which
    need 16-byte aligned addresses), in every row layout: rows of 64, 32 and
    16 bytes all keep a 16-byte aligned table aligned."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def composite_fwd_segments(inst, tile_start, tile_nblk, grid: TileGrid):
    """The forward's segment pass -> locals [S, 4, P] f32 (see
    composite_fwd_segments_plain). On a CUDA tensor this launches
    composite_fwd_segments_kernel (kernels/csrc/composite_fwd.cu) on the
    current stream, without synchronizing, or raises: one CTA per segment
    number below num_segments_cap(grid); numbers that belong to no segment
    leave their rows unwritten. The plain version runs only for CPU tensors."""
    if _check_kernel_args("composite_fwd_segments", inst, tile_start, tile_nblk,
                          grid) == "cpu":
        return composite_fwd_segments_plain(inst, tile_start, tile_nblk, grid)
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load()
    inst = _contiguous_aligned(inst)
    tile_start = tile_start.contiguous()
    tile_nblk = tile_nblk.contiguous()
    nseg = num_segments_cap(grid)
    locs = torch.empty((nseg, 4, grid.tile_pixels), dtype=torch.float32, device=inst.device)
    with torch.cuda.device(inst.device):
        code = lib.splat_composite_fwd_segments(
            inst.data_ptr(), tile_start.data_ptr(), tile_nblk.data_ptr(), locs.data_ptr(),
            nseg, SEGMENT_BLOCKS, grid.num_tiles, grid.tiles_x, grid.tile_size, grid.height,
            grid.block, *_cutoff_args(grid), *_layout_args(grid),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "composite_fwd_segments")
    kernels.LAUNCH_COUNTS["composite_fwd_segments"] += 1
    return locs


def combine_segments(locs, inst, tile_start, tile_nblk, grid: TileGrid, checkpoints=False):
    """The forward's combine pass over the locals of composite_fwd_segments ->
    [T, 8, P] in the rows' dtype (f32, or bf16), or with ``checkpoints`` -> ([T, 8, P], Segments(locs,
    walked)): the checkpoints are written over ``locs`` in place (see
    combine_segments_plain). On a CUDA tensor this launches
    composite_fwd_combine_kernel (kernels/csrc/composite_fwd.cu) on the
    current stream, without synchronizing, or raises; the plain version runs
    only for CPU tensors."""
    kind = _check_kernel_args("combine_segments", inst, tile_start, tile_nblk, grid)
    shape = (num_segments_cap(grid), 4, grid.tile_pixels)
    if (locs.dtype != torch.float32 or locs.shape != shape or locs.device != inst.device
            or not locs.is_contiguous()):
        raise ValueError(
            f"combine_segments takes locs {list(shape)} float32 contiguous on {inst.device}, "
            f"got {tuple(locs.shape)} {locs.dtype} {locs.device}")
    if kind == "cpu":
        return combine_segments_plain(locs, inst, tile_start, tile_nblk, grid, checkpoints)
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load()
    inst = _contiguous_aligned(inst)
    tile_start = tile_start.contiguous()
    tile_nblk = tile_nblk.contiguous()
    out = torch.empty((grid.num_tiles, OUT_ROWS, grid.tile_pixels),
                      dtype=_out_dtype(grid), device=inst.device)
    walked = torch.empty_like(tile_nblk) if checkpoints else None
    with torch.cuda.device(inst.device):
        code = lib.splat_composite_fwd_combine(
            inst.data_ptr(), tile_start.data_ptr(), tile_nblk.data_ptr(), locs.data_ptr(),
            out.data_ptr(), walked.data_ptr() if checkpoints else 0, int(checkpoints),
            SEGMENT_BLOCKS, grid.num_tiles, grid.tiles_x, grid.tile_size, grid.height,
            grid.block, *_cutoff_args(grid), float(grid.early_stop_eps),
            *_layout_args(grid), int(_out_dtype(grid) == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "composite_fwd_combine")
    kernels.LAUNCH_COUNTS["composite_fwd_combine"] += 1
    return (out, Segments(locs, walked)) if checkpoints else out


def composite_fwd(inst, tile_start, tile_nblk, grid: TileGrid, checkpoints=False):
    """Composite forward over the tile-sorted instance buffer (rows in the
    grid's layout) -> [T, 8, P] in the rows' dtype (f32, or bf16 with
    accum_dtype="bfloat16"), or with ``checkpoints`` (training) -> ([T, 8, P], Segments): what
    composite_bwd needs to start every segment of a tile's chain on its own.

    The port of splatapult_tpu/ops/composite.py::_fwd_kernel (via _fwd_call).
    On a CUDA tensor this launches the two hand-written kernels of
    kernels/csrc/composite_fwd.cu on the current stream, without
    synchronizing, or raises: composite_fwd_segments, then combine_segments.
    Serving gives the segment pass a scratch buffer of num_segments_cap(grid)
    x 4 x P floats; in training that buffer becomes Segments.ckpt. The rows
    are the same bits either way. The plain version of the whole
    (composite_fwd_plain) runs only for CPU tensors.
    """
    if _check_kernel_args("composite_fwd", inst, tile_start, tile_nblk, grid) == "cpu":
        return composite_fwd_plain(inst, tile_start, tile_nblk, grid, checkpoints)
    locs = composite_fwd_segments(inst, tile_start, tile_nblk, grid)
    return combine_segments(locs, inst, tile_start, tile_nblk, grid, checkpoints)


def composite_bwd(inst, tile_start, tile_nblk, out_res, dout, grid: TileGrid, segments=None):
    """Composite backward -> per-instance gradient columns [9, mcap] f32, zero
    for skipped and padding blocks.

    The port of splatapult_tpu/ops/composite.py::_bwd_kernel (via _bwd_call).
    ``out_res`` is the forward's output, ``dout`` its cotangent (both
    [T, 8, P] in the rows' dtype, f32 or bf16, widened to f32 where they are
    read; rows 0-4 are read). On a CUDA tensor this launches the
    hand-written kernel (kernels/csrc/composite_bwd.cu) on the current stream,
    without synchronizing, or raises; it needs ``segments``, the Segments
    that composite_fwd(..., checkpoints=True) returned for the same inputs.
    The plain version runs only for CPU tensors and walks whole chains, so it
    takes no segments.
    """
    kind = _check_kernel_args("composite_bwd", inst, tile_start, tile_nblk, grid)
    rows, out_dtype = (grid.num_tiles, OUT_ROWS, grid.tile_pixels), _out_dtype(grid)
    for what, a in (("out_res", out_res), ("dout", dout)):
        if a.dtype != out_dtype or a.shape != rows or a.device != inst.device:
            raise ValueError(
                f"composite_bwd takes {what} {list(rows)} {out_dtype} on {inst.device}, "
                f"got {tuple(a.shape)} {a.dtype} {a.device}")
    if kind == "cpu":
        return composite_bwd_plain(inst, tile_start, tile_nblk, out_res, dout, grid)
    if segments is None:
        raise ValueError(
            "composite_bwd on a CUDA tensor takes the forward's segments: "
            "composite_fwd(..., checkpoints=True)")
    nseg = num_segments_cap(grid)
    for what, a, shape, dtype in (
            ("ckpt", segments.ckpt, (nseg, 4, grid.tile_pixels), torch.float32),
            ("walked", segments.walked, (grid.num_tiles,), torch.int32)):
        if (a.dtype != dtype or a.shape != shape or a.device != inst.device
                or not a.is_contiguous()):
            raise ValueError(
                f"composite_bwd takes segments.{what} {list(shape)} {dtype} contiguous on "
                f"{inst.device}, got {tuple(a.shape)} {a.dtype} {a.device}")
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load()
    inst = _contiguous_aligned(inst)
    tile_start = tile_start.contiguous()
    out_res = out_res.contiguous()
    dout = dout.contiguous()  # autograd may hand over a strided cotangent
    # zeros: blocks that no tile owns or that the early stop skips are
    # written by no CTA
    d_inst = torch.zeros((NUM_GRAD_COLS, grid.mcap), dtype=torch.float32, device=inst.device)
    with torch.cuda.device(inst.device):
        code = lib.splat_composite_bwd(
            inst.data_ptr(), tile_start.data_ptr(), segments.walked.data_ptr(),
            segments.ckpt.data_ptr(), out_res.data_ptr(), dout.data_ptr(), d_inst.data_ptr(),
            nseg, SEGMENT_BLOCKS,
            grid.num_tiles, grid.mcap, grid.tiles_x, grid.tile_size, grid.height, grid.block,
            *_cutoff_args(grid), *_layout_args(grid), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "composite_bwd")
    kernels.LAUNCH_COUNTS["composite_bwd"] += 1
    return d_inst


def per_splat_sums(d_inst, inst_splat, seg_offs, seg_cnt, grid: TileGrid):
    """The backward's tail: per-instance gradient columns [9, mcap] -> per-splat
    feature gradients [N + 1, 16] (the null row and columns 9.. are zero).

    The port of the tail of splatapult_tpu/ops/composite.py::_cff_bwd, which
    the JAX package also computes outside any kernel. Sorting by splat id
    groups each splat's instances into the contiguous range
    [seg_offs, seg_offs + seg_cnt) (seg_offs is the exclusive cumsum of
    seg_cnt in splat order; null and padding slots carry id N and sort past
    every real instance, with zero columns). One prefix sum, read at the
    segment ends, and a first difference then give every segment's sum, in a
    fixed order: the result is the same from run to run, which a scatter with
    atomics is not. Splats with no instance get exactly zero. The prefix sum
    runs in float64: the rounding of a difference of two prefixes is
    relative to the running total, which over millions of slots can exceed
    a splat's own sum by six orders of magnitude; in float64 that is still
    below the float32 rounding of the splat's sum.

    With grad_sort_dtype="bfloat16" every per-instance value is rounded to
    bf16 (to nearest even) before the gather by the permutation, and the
    gather moves 2-byte columns; the prefix sums still run in float64.
    Numerically this is the JAX package's _pack_bf16_pairs /
    _unpack_bf16_pairs, which pack pairs of bf16 columns into one int32
    payload of its sort; here only the keys are sorted, so there is no
    payload to pack.

    The body is _tail_stages: its four stages in order, each a function of
    its own, so that tools/profile_bwd.py times the code that ships.
    """
    return _tail_stages(d_inst, inst_splat, seg_offs, seg_cnt, grid)


def _tail_stages(d_inst, inst_splat, seg_offs, seg_cnt, grid: TileGrid, record=None):
    """per_splat_sums' body, its stages run in order through run_stage: the
    id sort (_tail_order), the columns gathered at the permutation
    (_tail_columns), the two-level float64 prefix sum (_tail_prefix), the
    read at the segment ends and the difference (_tail_segment_sums). With a
    ``record`` list, every stage is appended to it as run_stage says."""
    stage = functools.partial(run_stage, record)
    perm = stage("tail/id sort", _tail_order, inst_splat)
    cols = stage("tail/column gather", _tail_columns, d_inst, perm, grid)
    local, carry = stage("tail/two-level prefix sum", _tail_prefix, cols)
    return stage("tail/segment ends + difference", _tail_segment_sums, local, carry,
                 seg_offs, seg_cnt, grid, d_inst.dtype)


def _tail_order(inst_splat):
    """The tail's id sort -> the permutation [mcap] int64 that groups each
    splat's instances (torch.sort takes one key: the columns are carried by
    gathering at the permutation, _tail_columns)."""
    return torch.sort(inst_splat, stable=True)[1]


def _tail_columns(d_inst, perm, grid: TileGrid):
    """The gradient columns at the permutation's first emax slots -> [9, emax]
    float64, splat-grouped; with grad_sort_dtype="bfloat16" each value is
    rounded to bf16 first and the gather moves 2-byte columns."""
    if grid.grad_sort_dtype == "bfloat16":
        return d_inst.to(torch.bfloat16)[:, perm[: grid.emax]].double()
    return d_inst[:, perm[: grid.emax]].double()


def _tail_prefix(cols):
    """Inclusive prefix sum along the slots of cols [9, emax] in two levels ->
    (local [9, emax / block, block]: the prefix within blocks of
    _PREFIX_BLOCK slots, carry [9, emax / block]: the exclusive prefix of the
    block totals). torch.cumsum over nine rows of millions of slots keeps
    nine thread blocks busy (4 ms for [9, 2.6M] on an H100, 80 % of the
    tail); as [9 * emax / block, block] it fills the card. emax is a multiple
    of 4096 by construction (TileGrid.create)."""
    local = torch.cumsum(cols.reshape(NUM_GRAD_COLS, -1, _PREFIX_BLOCK), dim=2)
    totals = local[:, :, -1]
    return local, torch.cumsum(totals, dim=1) - totals


def _tail_segment_sums(local, carry, seg_offs, seg_cnt, grid: TileGrid, dtype):
    """The prefix of _tail_prefix read at every splat's segment end, and the
    first difference -> d_feats [N + 1, 16] in ``dtype`` (the null row and
    columns 9.. zero; a splat with no instance exactly zero)."""
    n = seg_offs.shape[0]
    end = torch.clamp_max(seg_offs + seg_cnt, grid.emax)
    at = torch.clamp(end - 1, 0, grid.emax - 1).long()
    prefix_at = (local.reshape(NUM_GRAD_COLS, -1)[:, at]
                 + carry[:, torch.div(at, _PREFIX_BLOCK, rounding_mode="floor")])
    g = torch.where((end > 0)[None, :], prefix_at, 0.0)  # [9, N] prefix at segment ends
    d_feats = torch.zeros((n + 1, NUM_FEATS), dtype=dtype, device=local.device)
    d_feats[:n, :NUM_GRAD_COLS] = torch.diff(
        g, dim=1, prepend=g.new_zeros((NUM_GRAD_COLS, 1))).t().to(dtype)
    return d_feats


class _Composite(torch.autograd.Function):
    """Row gather + composite forward kernel; backward = composite backward
    kernel + per_splat_sums. The feature table is packed into the grid's row
    layout (pack_src) before the gather, and the gathered rows are kept for
    the backward in that layout (as the JAX package keeps them) rather than
    gathered again, and so are the forward's segment checkpoints. A
    forward_only grid stores neither. The backward is straight-through past
    the packing: the [N + 1, 16] f32 gradient is taken at the decoded
    (quantized) features."""

    @staticmethod
    def forward(ctx, feats, inst_splat, tile_count, seg_offs, seg_cnt, grid):
        inst = gather_rows(pack_src(feats, grid), inst_splat.long())
        start, nblk = tile_block_ranges(tile_count, grid.block)
        ctx.grid = grid
        if grid.forward_only:
            return composite_fwd(inst, start, nblk, grid)
        out, segments = composite_fwd(inst, start, nblk, grid, checkpoints=True)
        ctx.save_for_backward(inst, start, nblk, out, inst_splat, seg_offs, seg_cnt, *segments)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        grid = ctx.grid
        if grid.forward_only:
            raise ValueError(
                "composite_from_feats cannot be differentiated with "
                "forward_only=True: the viewer contract declares no backward. "
                "Render with forward_only=False to train.")
        inst, start, nblk, out, inst_splat, seg_offs, seg_cnt, *segments = ctx.saved_tensors
        # the cotangent of bf16 rows arrives in bf16, as in the JAX package
        d_inst = composite_bwd(inst, start, nblk, out, dout.to(out.dtype), grid,
                               Segments(*segments))
        d_feats = per_splat_sums(d_inst, inst_splat, seg_offs, seg_cnt, grid)
        return d_feats, None, None, None, None, None


def composite_from_feats(feats, bins, grid: TileGrid):
    """Tile-binned composite from per-splat features -> per-tile [T, 8, P]
    (f32, or bf16 with accum_dtype="bfloat16").

    feats is [N + 1, 16] (last row = null splat); ``bins`` is the dict from
    ops.binning.bin_splats. One row gather builds the instance buffer (in the
    grid's row layout: pack_src), then
    the composite forward kernel runs over it. Differentiable in feats: the
    backward kernel gives per-instance gradients and a sort-and-difference
    tail sums them per splat (no scatter-add), -> [N + 1, 16] gradients.
    """
    return _Composite.apply(
        feats, bins["inst_splat"], bins["tile_count"], bins["seg_offs"],
        bins["seg_cnt"], grid)
