"""Tile binning: splat -> (tile, depth)-ordered instance lists, all static shapes.

This replaces the reference's per-frame GPU sort machinery — the presort
compaction with an atomic counter (ref: shader/presort_compute.glsl:50-55) and
the full 32-bit radix sort of every visible splat (ref: src/splatrenderer.cpp:
153-312, shader/multi_radixsort*.glsl) — with the formulation of
splatapult_tpu/ops/binning.py, array for array:

1. Depth ordering happens *inside* the one binning sort: per-instance view
   depth rides in the sort key (full f32 bits by default — the reference
   quantizes depth into its 32-bit radix keys and saw artifacts at 24 bits,
   ref: src/splatrenderer.cpp:165-169), with descending splat index as the
   tie-break (the reference's stable back-to-front draw order implies
   higher-index-in-front under equal depth, ref: shader/presort_compute.glsl:
   52-53).
2. Dynamic instance counts are handled with a static-size instance buffer of
   ``emax`` enumeration slots; the expand kernel maps each slot back to its
   (splat, tile-within-rect) pair. No data-dependent shapes, no host readback
   (the reference stalls the pipe every frame reading its counter,
   src/splatrenderer.cpp:196-204): nothing on this path calls ``.item()``.
3. Block alignment happens *inside the sort*: exact per-tile padding entries
   are appended before the tile sort, so every tile's segment in the sorted
   order starts at a multiple of the compositing block size B and is filled
   to a multiple of B with *null instances* (splat index N -> an all-zero
   feature row). The sorted order IS the instance buffer, and block metadata
   (owning tile, first-of-tile) falls out of strided slices.

Overflow: if the enumeration capacity ``emax`` is exceeded, whole FARTHEST
splats are dropped by the depth key, so the sorted structure stays exact; the
dropped instance count is reported, never silent.

``torch.sort`` takes one key where the JAX sort takes several. The
(tile, depth, -splat) order is reproduced bit for bit by packing
(tile, depth bits) into one integer key, laying the real entries out in
REVERSED enumeration order (descending splat id), appending the pads, and
sorting stably: equal keys then keep descending splat order, and pads and
sentinels all carry identical (key, splat = N) pairs.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import torch

from splatapult_tpu_torch import kernels

_log = logging.getLogger("splatapult_tpu_torch")


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static geometry of the tiled pipeline (hashable)."""

    width: int  # true image width in px
    height: int
    tile_size: int  # TS, pixels per tile side
    block: int  # B, instances per composite block (power of two)
    emax: int  # raw instance enumeration capacity
    mcap: int  # aligned instance buffer capacity (multiple of block)
    alpha_cutoff: float = 1.0 / 256.0
    early_stop_eps: float = 0.0
    # accumulation dtype for the composite output rows ("float32"/"bfloat16"),
    # the reference's --fp32/--fp16 offscreen-FBO knob (ref: src/app.cpp:
    # 1000-1035)
    accum_dtype: str = "float32"
    # dtype the per-instance gradient columns ride through the backward's
    # transpose sort; unused by the forward
    grad_sort_dtype: str = "float32"
    # 16-bit fixed-point splat RGB in 32 B feature rows
    packed_colors: bool = False
    # forward-only rendering (the reference's actual mode — it has no backward
    # at all). A pure contract marker: differentiating a composite raises.
    forward_only: bool = False
    # depth precision inside the instance sort key: 32 = full f32 depth bits
    # (exact ordering); 20 = the top 20 f32 bits (8 exponent + 12 explicit
    # mantissa bits, relative step ~2.4e-4) packed with the tile id into ONE
    # int32 key; 16 = bf16 depth. depth20 requires num_tiles < 2^11 (the
    # sentinel key num_tiles << 20 | 0xFFFFF must fit int32), 16 requires
    # < 2^15; both fall back to 32 otherwise. Ties order by the descending-
    # index tie-break (the reference's submission-order semantics).
    depth_bits: int = 32
    # whole instance feature rows quantized to 16 B
    packed_feats16: bool = False
    # INTERLEAVED tile-row ownership: with row_stride S > 1 the grid still
    # describes the FULL image (tile ids, pixel coords, sort-key packing are
    # all full-grid), but binning enumerates only the tile rows r with
    # r % S == row_offset. mcap sizes the alignment pad to the OWNED tile
    # count (num_tiles / S).
    row_stride: int = 1
    # tile rows added below the image (pixel y < 0), so that tiles_y divides
    # by a row_stride: pixel coordinates stay those of the image's height
    pad_rows: int = 0

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size) + self.pad_rows

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def num_blocks(self) -> int:  # NB: length of the flat block work-list
        return self.mcap // self.block

    @property
    def tile_pixels(self) -> int:
        return self.tile_size * self.tile_size

    @staticmethod
    def create(width, height, num_splats, tile_size=32, block=128,
               max_instance_mult=6, alpha_cutoff=1.0 / 256.0, early_stop_eps=0.0,
               accum_dtype="float32", grad_sort_dtype="float32",
               packed_colors=False, forward_only=False, depth_bits=32,
               packed_feats16=False, row_stride=1, pad_rows=0):
        if block & (block - 1) != 0:
            raise ValueError("block must be a power of two")
        if accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"accum_dtype {accum_dtype!r}")
        if grad_sort_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"grad_sort_dtype {grad_sort_dtype!r}")
        if depth_bits not in (16, 20, 32):
            raise ValueError(f"depth_bits {depth_bits!r}")
        emax = max(4096, -(-int(max_instance_mult * max(num_splats, 1)) // 4096) * 4096)
        tiles_y = -(-height // tile_size) + pad_rows
        if tiles_y % row_stride != 0:
            raise ValueError(
                f"tiles_y={tiles_y} must divide by row_stride={row_stride} "
                f"(add pad_rows)")
        tiles = (-(-width // tile_size)) * tiles_y
        # worst-case alignment padding: < block per OWNED tile
        mcap = emax + (tiles // row_stride) * block
        return TileGrid(
            width=width, height=height, tile_size=tile_size, block=block,
            emax=emax, mcap=mcap, alpha_cutoff=alpha_cutoff,
            early_stop_eps=early_stop_eps, accum_dtype=accum_dtype,
            grad_sort_dtype=grad_sort_dtype, packed_colors=packed_colors,
            forward_only=forward_only, depth_bits=depth_bits,
            packed_feats16=packed_feats16, row_stride=row_stride, pad_rows=pad_rows,
        )


def sort_key_mode(grid: TileGrid) -> str:
    """The instance-sort key mode this grid ACTUALLY uses (a static property):
    "packed20" / "packed16" when the requested packed depth key fits the tile
    count, "exact32" otherwise (the downgrade is logged by bin_splats; the
    reference prints its sort-path choice at init,
    src/splatrenderer.cpp:86-103)."""
    if grid.depth_bits == 20 and grid.num_tiles < (1 << 11):
        return "packed20"
    if grid.depth_bits == 16 and grid.num_tiles < (1 << 15):
        return "packed16"
    return "exact32"


# sort_key_mode -> depth bits packed beside the tile id (0: the int64 key)
_PACKED_BITS = {"packed20": 20, "packed16": 16, "exact32": 0}
_SPILL_BINS = 1024  # _bincount_by_sort: discarded bins the sentinel ids are spread over


def _bincount_by_sort(ids: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Exact bincount of int ids in [0, num_bins] -> [num_bins] int32.

    Values equal to ``num_bins`` act as an ignored overflow/sentinel bucket.
    (The name is the JAX function's, which counts by sorting.) Integer adds
    into a fixed-size table: exact in any order, and no host readback —
    ``torch.bincount`` on a CUDA tensor reads the largest id back to size
    its output, which stalls the host once a frame. The sentinel ids (every
    unfilled enumeration slot: hundreds of thousands at full size) are
    spread over _SPILL_BINS discarded bins, because adds to one address
    serialise on the card.
    """
    spill = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device) % _SPILL_BINS
    idx = torch.where(ids < num_bins, ids, num_bins + spill)
    counts = torch.zeros(num_bins + _SPILL_BINS, dtype=torch.int32, device=ids.device)
    return counts.index_add_(0, idx, torch.ones_like(idx))[:num_bins]


def _tile_rects(mean2d, extent, grid: TileGrid, row_offset=None):
    """Per-splat covered tile rectangles -> (x0, r0, nx, ny, cnt).

    The AABB-vs-tile-grid overlap that replaces the reference's geometry-
    shader quad coverage (ref: shader/splat_geom.glsl:83-106): column range
    [x0, x0+nx), row range [r0, r0+ny), cnt = nx*ny (0 = culled).

    With grid.row_stride = S > 1, only tile rows r with r % S == row_offset
    count: ny becomes the OWNED row count inside the rect, r0 the first owned
    full-grid row, and the rect's j-th tile is
    tile0 + (j // nx) * (S * tiles_x) + j % nx (the row step every consumer
    applies via grid.row_stride)."""
    ts, tx_n, ty_n, h = grid.tile_size, grid.tiles_x, grid.tiles_y, grid.height
    mx, my = mean2d[:, 0], mean2d[:, 1]
    if extent.ndim == 1:
        rx = ry = extent
    else:
        rx, ry = extent[:, 0], extent[:, 1]
    valid = (rx > 0.0) & (ry > 0.0)

    def tile_index(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    x0 = tile_index(torch.floor((mx - rx) / ts), tx_n)
    x1 = tile_index(torch.ceil((mx + rx) / ts), tx_n)
    # gl y-up -> image rows: row = height - y
    r0 = tile_index(torch.floor((h - my - ry) / ts), ty_n)
    r1 = tile_index(torch.ceil((h - my + ry) / ts), ty_n)
    nx = torch.clamp_min(x1 - x0, 0)
    s = grid.row_stride
    if s > 1:
        if row_offset is None:
            raise ValueError("row_stride > 1 needs a row_offset")
        d = int(row_offset)
        ty_owned = ty_n // s
        # owned rows are r = d + k*s; the rect [r0, r1) covers owned indices
        # [ceil((r0-d)/s), ceil((r1-d)/s)). r0 - d >= -(s-1), so the +s-1
        # floor-div form never sees a negative numerator.
        k0 = torch.clamp(torch.div(r0 - d + s - 1, s, rounding_mode="floor"), 0, ty_owned)
        k1 = torch.clamp(torch.div(r1 - d + s - 1, s, rounding_mode="floor"), 0, ty_owned)
        ny = torch.clamp_min(k1 - k0, 0)
        r0 = d + k0 * s  # first OWNED full-grid row
    else:
        ny = torch.clamp_min(r1 - r0, 0)
    cnt = torch.where(valid, nx * ny, 0).to(torch.int32)
    return x0, r0, nx, ny, cnt


def instance_demand(mean2d, extent, grid: TileGrid, row_offset=None):
    """Total tile-instance count this view would enumerate -> scalar int32
    tensor (no readback).

    The cheap pre-pass behind capacity auto-tuning: measure the demand once,
    then size ``max_instance_mult`` with a small headroom instead of paying
    for worst-case capacity in every sort/gather/kernel of every frame (the
    analog of the reference's radix-workgroup auto-tuner,
    ref: src/app.cpp:843-874). With grid.row_stride > 1, the demand of the
    ``row_offset`` band's interleaved tile rows."""
    _, _, _, _, cnt = _tile_rects(mean2d, extent, grid, row_offset=row_offset)
    return cnt.sum(dtype=torch.int32)  # fine to ~2.1e9 instances


def _depth_sort_bits(depth: torch.Tensor) -> torch.Tensor:
    """f32 depth -> int32 bit pattern that sorts like the float (non-negative
    f32 bits are monotone; negative depths clamp to 0 first)."""
    return torch.clamp_min(depth.to(torch.float32), 0.0).contiguous().view(torch.int32)


def expand_fill_plain(ends, tile0, nx, dbits, emax: int, row_step: int):
    """Plain PyTorch version of the expand kernel -> [3, emax] int32.

    ``ends`` is the inclusive cumsum of the kept per-splat counts; slot m is
    covered by the first row i with ends[i] > m (rows with count 0 are
    skipped by the search itself). Rows: tile id, splat id, depth bits;
    uncovered slots (m >= ends[-1]) are 0.
    """
    n = ends.shape[0]
    m = torch.arange(emax, dtype=torch.int32, device=ends.device)
    out = torch.zeros((3, emax), dtype=torch.int32, device=ends.device)
    if n == 0:
        return out
    i = torch.searchsorted(ends, m, right=True)
    covered = i < n
    i = torch.clamp_max(i, n - 1)
    offs = torch.where(i > 0, ends[torch.clamp_min(i - 1, 0)], 0)
    w = torch.clamp_min(nx[i], 1)
    j = m - offs
    tile = tile0[i] + torch.div(j, w, rounding_mode="floor") * row_step + j % w
    out[0] = torch.where(covered, tile, 0)
    out[1] = torch.where(covered, i.to(torch.int32), 0)
    out[2] = torch.where(covered, dbits[i], 0)
    return out


def expand_fill(ends, tile0, nx, dbits, emax: int, row_step: int):
    """Enumeration expand -> [3, emax] int32 (tile id, splat id, depth bits).

    The port of splatapult_tpu/ops/binning.py::_expand_fill_pallas. On a CUDA
    tensor this launches the hand-written kernel (kernels/csrc/expand.cu) on
    the current stream, without synchronizing, or raises; the plain version
    runs only for CPU tensors.
    """
    cols = (ends, tile0, nx, dbits)
    n = ends.shape[0]
    for c in cols:
        if c.dtype != torch.int32 or c.shape != (n,) or c.device != ends.device:
            raise ValueError(
                "expand_fill takes four int32 [N] columns on one device, got "
                f"{[(tuple(c.shape), c.dtype, str(c.device)) for c in cols]}")
    if ends.device.type == "cpu":
        return expand_fill_plain(ends, tile0, nx, dbits, emax, row_step)
    if ends.device.type != "cuda":
        raise ValueError(f"expand_fill: unsupported device {ends.device}")
    from splatapult_tpu_torch.kernels import _build

    lib = _build.load()
    ends, tile0, nx, dbits = (c.contiguous() for c in cols)
    out = torch.empty((3, emax), dtype=torch.int32, device=ends.device)
    with torch.cuda.device(ends.device):
        code = lib.splat_expand_fill(
            ends.data_ptr(), tile0.data_ptr(), nx.data_ptr(), dbits.data_ptr(),
            out.data_ptr(), n, emax, row_step,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "expand_fill")
    kernels.LAUNCH_COUNTS["expand_fill"] += 1
    return out


def _keep_within_capacity(depth_f, cnt_raw, emax: int):
    """Overflow drop -> bool [N] of splats kept: when the view enumerates more
    than ``emax`` instances, drop WHOLE FARTHEST splats so every kept splat's
    rect stays complete and the histogram/padding stay exact.

    Computed unconditionally and selected with a mask (the JAX version runs
    the threshold search under lax.cond): one [N] sort per call even when
    nothing overflows, in exchange for a path with no host readback.
    """
    n = cnt_raw.shape[0]
    d_sorted, order = torch.sort(depth_f, stable=True)
    cum = torch.cumsum(cnt_raw[order], 0, dtype=torch.int32)
    total_raw = cum[-1]
    # last depth-sorted index whose cumulative instance count fits
    k = torch.searchsorted(
        cum, torch.full((1,), emax, dtype=torch.int32, device=cum.device),
        right=True)[0]
    thr = torch.where(
        k > 0, torch.take(d_sorted, torch.clamp(k - 1, 0, n - 1)),
        torch.full((), float("-inf"), device=depth_f.device))
    keep_lt = depth_f < thr  # total of these is <= cum[k-1] <= emax
    used = torch.where(keep_lt, cnt_raw, 0).sum(dtype=torch.int32)
    # splats exactly at the threshold depth: admit greedily in input order
    # while capacity remains (exact under depth ties)
    at_thr = depth_f == thr
    c_at = torch.where(at_thr, cnt_raw, 0)
    fits = used + torch.cumsum(c_at, 0, dtype=torch.int32) <= emax
    keep_drop = keep_lt | (at_thr & fits)
    return torch.where(total_raw > emax, keep_drop, True)


def _table_from_rects(rects, keep, depth_f, grid: TileGrid):
    """The table's stage: the rects of _tile_rects and the kept mask of
    _keep_within_capacity -> the per-splat table the expand kernel reads, a
    dict of int32 [N] columns: ``ends`` (inclusive cumsum of the kept
    counts), ``tile0`` (first covered tile of the rect), ``nx`` (rect width
    in tiles), ``dbits`` (sortable depth bits), plus ``cnt`` (kept count; 0 =
    culled or dropped by the capacity overflow) and ``cnt_raw`` (count
    before the drop)."""
    x0, r0, nx, _, cnt_raw = rects
    cnt = torch.where(keep, cnt_raw, 0)
    return {
        "ends": torch.cumsum(cnt, 0, dtype=torch.int32),
        "tile0": r0 * grid.tiles_x + x0,
        "nx": nx,
        "dbits": _depth_sort_bits(depth_f),
        "cnt": cnt,
        "cnt_raw": cnt_raw,
    }


def expand_table(mean2d, extent, grid: TileGrid, depth, row_offset=None):
    """The per-splat table the expand kernel reads (see _table_from_rects):
    the first three stages of bin_splats (_bin_stages) composed, the rects
    and counts, the overflow drop and the table's cumsums."""
    rects = _tile_rects(mean2d, extent, grid, row_offset=row_offset)
    depth_f = depth.to(torch.float32)
    keep = _keep_within_capacity(depth_f, rects[4], grid.emax)
    return _table_from_rects(rects, keep, depth_f, grid)


def _slot_columns(out3, total, grid: TileGrid, n: int):
    """The expand kernel's [3, emax] rows -> (tile [emax], splat [emax],
    valid [emax] bool): slots past the ``total`` filled ones get the sentinel
    tile num_tiles (it sorts to the end) and the null splat n."""
    m = torch.arange(grid.emax, dtype=torch.int32, device=out3.device)
    valid_m = m < total
    tile = torch.where(valid_m, out3[0], grid.num_tiles)
    s = torch.where(valid_m, out3[1], n)
    return tile, s, valid_m


def _alignment_pads(tile_count, grid: TileGrid, row_offset=None):
    """Alignment padding entries, exact per OWNED tile -> [owned tiles * B]
    int32 tile ids: row t of the [T_owned, B] candidates holds (-count) % B
    real pads of its tile, the rest the sentinel num_tiles."""
    dev, i32 = tile_count.device, torch.int32
    b, num_tiles, stride, tx_n = grid.block, grid.num_tiles, grid.row_stride, grid.tiles_x
    pad_col = torch.arange(b, dtype=i32, device=dev)[None, :]
    if stride == 1:
        pad_t = (-tile_count) % b  # in [0, b)
        pad_tile_grid = torch.arange(num_tiles, dtype=i32, device=dev)[:, None]
    else:
        # owned tile index i -> full-grid tile id (row i//tx * S + d) * tx + col
        d_off = int(row_offset)
        cnt_owned = tile_count.reshape(grid.tiles_y // stride, stride, tx_n)[:, d_off, :]
        cnt_owned = cnt_owned.reshape(-1)
        pad_t = (-cnt_owned) % b
        oidx = torch.arange(num_tiles // stride, dtype=i32, device=dev)[:, None]
        pad_tile_grid = (torch.div(oidx, tx_n, rounding_mode="floor") * stride
                         + d_off) * tx_n + oidx % tx_n
    return torch.where(pad_col < pad_t[:, None], pad_tile_grid, num_tiles).reshape(-1)


def _instance_keys(tile, s, dep_enum, valid_m, pad_tile, grid: TileGrid, n: int):
    """The main sort's key -> (key [mcap]: int32 packed or int64 exact, splat
    id [mcap] of every entry): the REVERSED enumeration, then the pads.

    Sorted stably by the key (_sort_by_key), pads land at each tile's end
    (maximal depth code), sentinels at the very end. Every tile segment is
    then exactly ceil(count/b)*b long, so segment starts are b-aligned and
    the sorted order IS the block-aligned instance buffer.
    STRICT < gates (sort_key_mode): the sentinel/pad key is
    (num_tiles << bits) | mask, which must stay <= INT32_MAX — at exactly
    2048 tiles the 20-bit sentinel would wrap the int32 sign bit and sort
    BEFORE every real instance.
    packed20: (tile << 20 | top-20 f32 depth bits): real depth codes are
    <= 0x7F800000 >> 11 = 0xFF000 < 0xFFFFF, so the pad/sentinel code sorts
    strictly after every real instance. packed16: (tile << 16 | bf16 depth).
    exact32: (tile << 32 | f32 depth bits) in int64.
    """
    pad_cap = pad_tile.shape[0]
    packed_bits = _PACKED_BITS[sort_key_mode(grid)]
    s_all = torch.cat([s.flip(0), torch.full((pad_cap,), n, dtype=torch.int32,
                                             device=s.device)])
    if packed_bits:
        # 16: bits [31:16] of the f32; 20: bits [30:11] (sign bit is always 0)
        shift = 16 if packed_bits == 16 else 11
        sentd = (1 << packed_bits) - 1
        key = (tile << packed_bits) | torch.where(
            valid_m, (dep_enum >> shift) & sentd, sentd)
        return torch.cat([key.flip(0), (pad_tile << packed_bits) | sentd]), s_all
    imax = 2**31 - 1
    key = (tile.to(torch.int64) << 32) | torch.where(valid_m, dep_enum, imax)
    return torch.cat([key.flip(0), (pad_tile.to(torch.int64) << 32) | imax]), s_all


def _sort_by_key(key_all, s_all, grid: TileGrid):
    """The main sort: ONE stable sort by the (tile, depth) key of
    _instance_keys -> (tile id of every sorted slot [mcap] int32,
    inst_splat [mcap])."""
    key_sorted, perm = torch.sort(key_all, stable=True)
    packed_bits = _PACKED_BITS[sort_key_mode(grid)]
    if packed_bits:
        tile_sorted = key_sorted >> packed_bits
    else:
        tile_sorted = (key_sorted >> 32).to(torch.int32)
    return tile_sorted, s_all[perm]


def _block_metadata(tile_sorted, grid: TileGrid):
    """Block metadata as strided slices of the sorted tile ids -> (block_tile,
    block_first, block_live), each [NB] int32."""
    i32, b, nb, num_tiles = torch.int32, grid.block, grid.num_blocks, grid.num_tiles
    bt = tile_sorted[::b]  # [NB] tile of each block's first row
    prev = torch.cat([torch.full((1,), -1, dtype=i32, device=tile_sorted.device),
                      tile_sorted[b - 1::b][:-1]])
    block_live_mask = bt < num_tiles
    block_first = (block_live_mask & (bt != prev)).to(i32)
    block_live = block_live_mask.to(i32)
    # dead blocks (the sentinel suffix) name the tile of the LAST live block,
    # as the reference's work-list does. bt is nondecreasing, so the last
    # live block is just before the first sentinel block.
    idx_last = torch.clamp(block_live.sum() - 1, 0, nb - 1)
    last_tile = torch.clamp_max(torch.take(bt, idx_last), num_tiles - 1)
    block_tile = torch.where(block_live_mask, bt, last_tile).to(i32)
    return block_tile, block_first, block_live


def bin_splats(mean2d, extent, grid: TileGrid, depth, row_offset=None):
    """Build the (tile, depth)-ordered instance buffer and flat block work-list.

    Args (index plumbing; nothing here is differentiable):
      mean2d [N, 2] screen centers (gl convention, +y up), any splat order
      extent [N, 2] tight AABB half-extents (rx, ry) in px, or [N] isotropic
        radius (both 0 = culled)
      depth [N] view depth per splat: rides the tile sort inside the key;
        ties break by descending splat index (reference parity, see module
        docstring)

    Returns dict:
      inst_splat [mcap] int32 — splat index per aligned instance slot (N = null)
      seg_offs/seg_cnt [N] — per-splat enumeration segments (for the backward
        transpose of the training slice)
      block_tile [NB] int32 — owning tile of each B-block
      block_first [NB] int32 — 1 iff block is the first of its tile
      block_live [NB] int32 — 0 for blocks past the last real tile
      block_meta [NB] int32 — (tile << 2 | first << 1 | live)
      tile_ok [T] bool — tile has at least one instance
      tile_count [T] int32 — true instance count per tile
      num_culled_instances [] int32 — instances dropped by capacity overflow

    With grid.row_stride = S > 1, ``row_offset`` (a Python int) selects the
    owned tile rows r % S == row_offset; tile ids stay FULL-grid and only
    owned tiles get alignment padding.

    The body is _bin_stages: its stages in order, each a function of its
    own, so that tools/profile_bin.py times the code that ships.
    """
    return _bin_stages(mean2d, extent, grid, depth, row_offset)


def run_stage(record, name: str, fn, *args):
    """One stage of a staged function (_bin_stages, composite's
    per_splat_sums) -> fn(*args); with a ``record`` list, (name, fn, args,
    result) is also appended to it, so that a profiler can time the stage
    alone on the very inputs it got and check it against what it gave."""
    out = fn(*args)
    if record is not None:
        record.append((name, fn, args, out))
    return out


def _bin_stages(mean2d, extent, grid: TileGrid, depth, row_offset=None, record=None):
    """bin_splats' body (see there), its stages run in order through
    run_stage: the rects and counts (_tile_rects), the overflow drop
    (_keep_within_capacity), the table's cumsums (_table_from_rects), the
    expand kernel (expand_fill), the slot columns, the tile histogram
    (_bincount_by_sort), the alignment pads, the sort key (_instance_keys),
    the main sort (_sort_by_key), the block metadata. With a ``record``
    list, every stage is appended to it as run_stage says."""
    n = mean2d.shape[0]
    if n == 0:
        raise ValueError("bin_splats needs at least one splat")
    stride = grid.row_stride
    pad_cap = (grid.num_tiles // stride) * grid.block
    if grid.mcap != grid.emax + pad_cap:
        raise ValueError(f"inconsistent grid: mcap={grid.mcap} emax={grid.emax} pad={pad_cap}")
    if stride > 1 and row_offset is None:
        raise ValueError("row_stride > 1 needs a row_offset")
    if grid.depth_bits != 32 and sort_key_mode(grid) == "exact32":
        _log.warning(
            "depth_bits=%d requested but num_tiles=%d exceeds the "
            "packed-key budget (%s); using the exact sort key",
            grid.depth_bits, grid.num_tiles,
            "< 2048" if grid.depth_bits == 20 else "< 32768")

    stage = functools.partial(run_stage, record)
    rects = stage("rects+counts", _tile_rects, mean2d, extent, grid, row_offset)
    depth_f = depth.to(torch.float32)
    keep = stage("overflow drop", _keep_within_capacity, depth_f, rects[4], grid.emax)
    table = stage("table cumsums", _table_from_rects, rects, keep, depth_f, grid)
    ends, cnt = table["ends"], table["cnt"]
    total = ends[-1]
    # ---- enumeration slots -> (splat, tile-within-rect): the expand kernel
    out3 = stage("expand fill (B1)", expand_fill, ends, table["tile0"], table["nx"],
                 table["dbits"], grid.emax,
                 grid.tiles_x * stride)  # tile-id step between owned rows
    tile, s, valid_m = stage("slot columns", _slot_columns, out3, total, grid, n)
    # exact per-tile counts (truncation-aware) -> exact alignment padding
    tile_count = stage("tile histogram", _bincount_by_sort, tile, grid.num_tiles)
    pad_tile = stage("alignment pads", _alignment_pads, tile_count, grid, row_offset)
    key_all, s_all = stage("sort key", _instance_keys, tile, s, out3[2], valid_m, pad_tile,
                           grid, n)
    tile_sorted, inst_splat = stage("main sort", _sort_by_key, key_all, s_all, grid)
    block_tile, block_first, block_live = stage("block metadata", _block_metadata,
                                                tile_sorted, grid)
    return {
        "inst_splat": inst_splat,
        "block_meta": (block_tile << 2) | (block_first << 1) | block_live,
        "seg_offs": ends - cnt,  # exclusive
        "seg_cnt": cnt,
        "block_tile": block_tile,
        "block_first": block_first,
        "block_live": block_live,
        "tile_ok": tile_count > 0,
        "tile_count": tile_count,
        "num_culled_instances": table["cnt_raw"].sum(dtype=torch.int32) - total,
    }
