// composite_fwd: per-tile front-to-back alpha compositing, for sm_90a, in two
// launches: a segment pass and a per-tile combine.
//
// Replaces the TPU kernel splatapult_tpu/ops/composite.py::_fwd_kernel
// (launched by _fwd_call; helpers _unpack_feats, _block_weights,
// _excl_cumprod_rows, _pixel_coords).
//
// This file holds the launchers and the C entries; the kernels are in
// composite_fwd.cuh, shared with composite_fwd_ablate.cu (the ablation
// microbenchmark's variants, which leave these instantiations as they are).
//
// Contract. `inst` is the tile-sorted, block-aligned instance buffer in one
// of three row layouts (row_layout.cuh): [mcap, 16] f32 (columns mean_x,
// mean_y, qa, qb, qc, ln_alpha, r, g, b, 0...; null rows carry ln_alpha =
// -100), or packed [mcap, 8] / [mcap, 4] int32 rows, decoded where they are
// read (every kernel is instantiated for each layout). Tile t owns the `block`-row
// blocks [tile_start[t], tile_start[t] + tile_nblk[t]). For every pixel p of
// the tile, walking its instances in order with T = 1 at the start:
//   qh = qa*dx*dx + qb*dx*dy + qc*dy*dy + ln_alpha     (dx, dy from the
//        gl_FragCoord-style pixel centre, +y up)
//   w  = exp(qh), or 0 where qh <= ln(alpha_cutoff)    (the 1/256 discard)
//   rgb += T * w * colour;  T *= 1 - w
// and the output rows [T, 8, P] are (r, g, b, 1 - T, T, 0, 0, 0), in f32 or,
// with bf16 accumulation, in bf16. A tile with
// no block writes the background (0, 0, 0, 0, 1, 0, 0, 0). With
// early_stop_eps > 0 the walk ends before the first block b > 0 at which no
// pixel of the tile has T >= eps — the block-level test the TPU kernel makes,
// so both give the same image — and `tile_walked[t]` (training) is b, or
// tile_nblk[t] where the walk never ended early.
//
// Segments. A tile's chain is cut into segments of kSegBlocks blocks
// (segments.cuh), numbered without a table as in the backward. The state of
// a pixel after a run of instances is an affine map of the state before it:
// (C, T) -> (C + T * c, T * t), where (c, t) is the run walked from colour 0
// and T = 1 — its "local". So:
//   1. composite_fwd_segments_kernel gives every segment its own CTA, which
//      walks the segment's blocks from (0, 1) and stores its local
//      (r, g, b, T) [4, P] into row `seg` of `locs` [S, 4, P];
//   2. composite_fwd_combine_kernel, one CTA per tile, scans the tile's
//      locals in order per pixel, C += T * c, T *= t, and writes the rows.
//      Before it applies segment j it holds the state before segment j: in
//      training (store_prefix) it writes that state back over the local it
//      has just read — exactly the checkpoint the backward
//      (composite_bwd.cu) starts segment j from. Serving leaves `locs`
//      scratch.
// The rows are the same bits with and without checkpoints: the stores are
// the only difference.
//
// bf16 accumulation (the reference's --fp16). The segment pass and every
// block's arithmetic stay f32. The combine rounds the carried (colour, T) to
// bf16 (round to nearest even) after every segment it applies, so the votes
// and the checkpoints see the rounded state (the checkpoints stay f32
// storage), and it writes the rows in bf16. The JAX kernel rounds its carried
// rows after every block; rounding between segments instead is a deliberate
// difference of the segmented design (a K-th as many roundings). The plain
// versions round at the same points as this kernel.
//
// The early stop (eps > 0) is decided in the combine, since a segment does
// not know T at its start. The segment pass never stops early: it walks all
// its blocks. The combine votes at every segment boundary j >= 1 (the end of
// the chain counts as one) whether every pixel has T < eps there. The first
// such boundary j* puts the serial walk's stop inside segment j* - 1, or
// exactly at block j* K (T only falls; at boundary j* - 1 some pixel still
// had T >= eps, or it was the chain's start). The combine walks that one
// segment again from its prefix with the serial per-block vote: if the vote
// ends the walk at block b, walked = b and the rows are the state there,
// otherwise walked = min(j* K, nblk) and the rows are the prefix at j*.
// Checkpoints past j* - 1 keep the locals: the backward walks only the
// blocks walked here and never reads them.
//
// Design for this card, and what bounds it. The first version gave one CTA a
// whole tile and evaluated every (row, pixel) pair: 3.2 ms on an H100 for a
// garden view (1.5M splats, 1920x1080, 2.40M live rows; tiles of 9.2 blocks
// on average and up to 147, a serial chain of 18,816 rows on one SM). Two
// things held it back: the deep tiles' chains, and instruction issue — of the
// pairs, 14 % lie above the discard, and a warp laid out as an 8 x 4 patch is
// touched by 21 % of the rows. Here:
//   - no CTA walks more than kSegBlocks blocks (8 x 128 rows), so the deep
//     tiles spread over as many SMs as they have segments;
//   - one pixel per thread, warps as 8 x 4 patches (row_cull.cuh), colour
//     and T in four registers;
//   - a segment's rows go to shared memory by the copy engine, packed as
//     they are in the buffer: one thread issues one bulk copy
//     (cp.async.bulk; 2 KB, 1 KB or 512 B by layout) per sub-chunk of 32
//     rows, each completing on its own mbarrier, all at the CTA's start.
//     8 x 128 rows are 64, 32 or 16 KB, resident whole (two CTAs an SM: the
//     threads are the limit), so each warp waits
//     only for the sub-chunk it is about to walk and no CTA-wide barrier
//     falls in the loop; a segment of more than kStageRows rows (blocks of
//     256 rows and more) is staged in pieces, with one CTA barrier between
//     pieces;
//   - per sub-chunk, per warp, the row list of the backward (row_cull.cuh):
//     lane r decodes row r's geometry and tests it against the warp's
//     rectangle of pixel centres, a ballot is the list, and the warp
//     evaluates only the listed rows, each decoded once more in every lane
//     from the broadcast shared-memory row. A row
//     that is not listed has w = 0 at every pixel of the warp: skipping it
//     changes no bit.
// The combine reads and writes 16 B per pixel and segment (79 MB for that
// view) and the rows: a few hundredths of a millisecond. Measured for that
// view: 1.23 ms, of which the combine 0.06 (0.07 storing checkpoints), and
// on the tiles of at most 16 blocks (49 % of the rows) 48 % of that: no tail. Arithmetic: expf,
// not __expf, and no fast-math: w is what the plain version computes. The
// combine's products and sums are rounded one by one (__fmul_rn,
// __fadd_rn), as the plain combine rounds them.
//
// Bound on an H100: operations, counted on the pairs that need them. A
// (row, pixel) pair whose weight falls under the discard changes no output,
// so the work the function needs is one exp and about 15 fp32 multiply-adds
// (2 * 15 flop) per pair ABOVE the discard, plus per row one test against its
// tile's rectangle (2 * 25 flop); the number of such pairs depends on the
// view and is counted from the inputs (chip_smoke.py does, with the plain
// weights). A listed row is evaluated in all 32 lanes of the warp, so the
// kernel does more than that. Bytes: 64, 32 or 16 B per slot by layout +
// 32 B (16 B in bf16) per pixel, at most about 0.22 GB, 0.07 ms at
// 3.35 TB/s; the locals are the design's traffic, not the function's. The
// packed layouts change the bytes, not the operations (their decode is a few
// integer operations per row, against ~15 per (row, pixel) pair).

#include "composite_fwd.cuh"

namespace {

template <int kLayout>
int launch_combine_rows(int rows_bf16, const void* inst, const void* tile_start,
                        const void* tile_nblk, void* locs, void* out, void* tile_walked,
                        int store_prefix, int num_tiles, int tiles_x, int tile_size,
                        int height, int block, float ln_cutoff, int use_cutoff,
                        float early_stop_eps, MeanDecode md, cudaStream_t stream) {
  if (rows_bf16) {
    return launch_combine<kLayout, __nv_bfloat16>(
        inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix, num_tiles, tiles_x,
        tile_size, height, block, ln_cutoff, use_cutoff, early_stop_eps, md, stream);
  }
  return launch_combine<kLayout, float>(
      inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix, num_tiles, tiles_x,
      tile_size, height, block, ln_cutoff, use_cutoff, early_stop_eps, md, stream);
}

}  // namespace

extern "C" int splat_composite_fwd_segments(const void* inst, const void* tile_start,
                                            const void* tile_nblk, void* locs,
                                            int num_segments, int seg_blocks, int num_tiles,
                                            int tiles_x, int tile_size, int height, int block,
                                            float ln_cutoff, int use_cutoff, int layout,
                                            float mean_step_x, float mean_step_y,
                                            float mean_off_x, float mean_off_y, void* stream) {
  if (num_tiles <= 0 || num_segments <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || seg_blocks != kSegBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MeanDecode md{mean_step_x, mean_step_y, mean_off_x, mean_off_y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kRowF32x16:
      return launch_segments<kRowF32x16>(inst, tile_start, tile_nblk, locs, num_segments,
                                         num_tiles, tiles_x, tile_size, height, block,
                                         ln_cutoff, use_cutoff, md, s);
    case kRowI32x8:
      return launch_segments<kRowI32x8>(inst, tile_start, tile_nblk, locs, num_segments,
                                        num_tiles, tiles_x, tile_size, height, block,
                                        ln_cutoff, use_cutoff, md, s);
    case kRowI32x4:
      return launch_segments<kRowI32x4>(inst, tile_start, tile_nblk, locs, num_segments,
                                        num_tiles, tiles_x, tile_size, height, block,
                                        ln_cutoff, use_cutoff, md, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int splat_composite_fwd_combine(const void* inst, const void* tile_start,
                                           const void* tile_nblk, void* locs, void* out,
                                           void* tile_walked, int store_prefix,
                                           int seg_blocks, int num_tiles, int tiles_x,
                                           int tile_size, int height, int block,
                                           float ln_cutoff, int use_cutoff,
                                           float early_stop_eps, int layout,
                                           float mean_step_x, float mean_step_y,
                                           float mean_off_x, float mean_off_y, int rows_bf16,
                                           void* stream) {
  if (num_tiles <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || seg_blocks != kSegBlocks ||
      (store_prefix && tile_walked == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MeanDecode md{mean_step_x, mean_step_y, mean_off_x, mean_off_y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kRowF32x16:
      return launch_combine_rows<kRowF32x16>(
          rows_bf16, inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix,
          num_tiles, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, early_stop_eps,
          md, s);
    case kRowI32x8:
      return launch_combine_rows<kRowI32x8>(
          rows_bf16, inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix,
          num_tiles, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, early_stop_eps,
          md, s);
    case kRowI32x4:
      return launch_combine_rows<kRowI32x4>(
          rows_bf16, inst, tile_start, tile_nblk, locs, out, tile_walked, store_prefix,
          num_tiles, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, early_stop_eps,
          md, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
