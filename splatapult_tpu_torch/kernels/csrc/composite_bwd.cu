// composite_bwd: transmittance-replay backward of the per-tile compositing,
// for sm_90a.
//
// Replaces the TPU kernel splatapult_tpu/ops/composite.py::_bwd_kernel
// (launched by _bwd_call; helpers moment_basis, _block_weights, _tile_centers,
// _scan_rows_add, _excl_cumprod_rows).
//
// This file holds the launchers and the C entries; the kernels are in
// composite_bwd.cuh, shared with composite_bwd_ablate.cu (the ablation
// microbenchmark's variants, which leave these instantiations as they are).
//
// Contract. `inst` and `tile_start` are the forward's (composite_fwd.cu),
// the rows in any of the three layouts of row_layout.cuh (every kernel is
// instantiated for each): rows arrive packed and are decoded where they are
// read. `out_res` [T, 8, P] holds the forward's final rows (r, g, b, alpha,
// T_fin, ...), `dout` [T, 8, P] the cotangent of those rows, both f32 or,
// with bf16 accumulation, bf16 (widened to f32 as they are read); rows 0-4
// of each are read. With bf16 accumulation the checkpoints hold the
// forward's rounded state, and each segment starts from it. For every pixel p of tile t, with the per-pixel constant
//   K = (dalpha - dT) * T_fin - (dR * r_fin + dG * g_fin + dB * b_fin)
// the backward walks the tile's instances front to back with T = 1, S = 0:
//   qh   = qa*dx*dx + qb*dx*dy + qc*dy*dy + ln_alpha
//   w    = exp(qh), or 0 where qh <= ln(alpha_cutoff)
//   cdot = r*dR + g*dG + b*dB
//   eff  = T * w;  S += eff * cdot
//   dw   = (K + S) / max(1 - w, 1e-9) + T * cdot
//   dqh  = w * dw;  T *= 1 - w
// and emits, per instance, sums over the tile's pixels: the six moments
// sum dqh * [u^2, uv, v^2, u, v, 1] in tile-local offsets (u, v) from the tile
// centre, turned into d_qa, d_qb, d_qc, d_ln_alpha, d_mean_x, d_mean_y, and
// (dr, dg, db) = sum eff * [dR, dG, dB]. Output `d_inst` is [9, mcap] f32 in
// instance order, rows (d_mx, d_my, d_qa, d_qb, d_qc, d_lna, dr, dg, db). The
// caller zero-fills it: blocks skipped by the forward's early stop and blocks
// past every tile's list are written by no CTA.
//
// Segments. A tile's chain is not walked by one CTA. The forward leaves, for
// every segment of kSegBlocks blocks (segments.cuh), a checkpoint [4, P] of
// (r, g, b so far, T) at the segment's first block, and per tile the number
// of blocks it walked (`tile_walked`, short of the tile's list when the early
// stop ended it). CTA s of the grid takes segment number s: its tile is the
// last one whose first segment number is <= s (a 32-way search over the tiles
// that every warp makes for itself, three rounds for 2040 tiles; no table is
// built), its first block (s - first number) * kSegBlocks; a number whose
// first block lies past the blocks walked belongs to no segment and the CTA
// exits. It starts from T of its checkpoint and from
// S = dR*r + dG*g + dB*b of the checkpoint's colour (cdot is linear in the
// colour, so the running sum of eff * cdot IS that product), and walks the
// blocks [blk0, min(blk0 + kSegBlocks, tile_walked[t])). Both passes
// therefore walk the same blocks without a second early-stop test here. S
// from the checkpoint differs from the replayed sum by float association
// only (about 1e-7 relative).
//
// What bounds it, measured on an H100 (garden 1.5M splats, 1920x1080, 2.40M
// live rows, 2040 tiles of 32 x 32 pixels; counts from tools/profile_phases.py,
// each decision below timed against its reverse on the same inputs). The
// first version gave one CTA a whole tile and evaluated every (row, pixel)
// pair: 12.4 ms.
// Tiles hold 9.2 blocks on average but up to 147, and the 178 tiles (9 %)
// deeper than 16 blocks hold 51 % of the rows; restricted to the other tiles
// (49 % of the rows) that kernel took 3.6 ms, so about 5 ms of the 12.4 were a
// few SMs finishing deep chains alone. Segments remove that tail. What is
// left is instruction issue: a warp that evaluates a row per pixel pays about
// 30 instructions for the quadratic form and a hundred more for the rest
// (exp, a division, nine products, the warp sums). A warp laid out as a
// 32 x 1 strip of the tile is touched by 32 % of the rows (47 % in the deepest
// tiles), as an 8 x 4 patch by 21 % (32 %): warps are patches (kPatchWarps;
// tiles whose side is no multiple of 8 keep strips; strips measured 4.5 ms
// where patches take 3.9). And the other four fifths of the (row, warp) pairs
// need not be looked at per pixel at all: see the row lists below (5.1 ms
// without them, 3.9 with). Segments of 4, 8 and 16 blocks measured within 2 %
// of each other; 8 keeps that view's checkpoints at 79 MB.
//
// One CTA, one segment, one pixel per thread (T and S are two registers):
//   - rows arrive in sub-chunks of 32 by cp.async into a ring of four
//     buffers of 2 KB, 1 KB or 512 B by layout (16-byte copies: four, two
//     or one per row), the next sub-chunk while this one is walked;
//   - per sub-chunk every warp first makes its list of rows: lane r takes row
//     r and asks whether its gaussian can exceed the discard anywhere in the
//     rectangle of the warp's pixel centres (decoding its geometry;
//     row_may_touch in row_cull.cuh,
//     shared with the forward: the exact maximum of the exponent over the
//     rectangle, about 50 instructions once per lane), and a ballot is the
//     list. The warp then walks only the listed
//     rows; the others cost it nothing;
//   - a listed row gets the full arithmetic in every lane (lanes below the
//     discard carry w = 0 and add zeros), and the warp reduces its nine
//     values by shuffles (warp_sum9: 14 where nine butterflies take 45) into
//     its slot of the sub-chunk's slot array [warp][row][9] in shared
//     memory; slots of rows that are not listed are never written and stay
//     0. (A vote whether any lane has w != 0 before the arithmetic, as the
//     first version had, only costs time now: the lists leave few rows that
//     it would stop, 4.0 ms with it against 3.9 without.)
//   - the slot array is double-buffered: while all warps walk sub-chunk i,
//     nine of them first add the slots of sub-chunk i-1 in fixed warp order
//     (the result is the same from run to run; shared-memory atomics would
//     not be), zero them for sub-chunk i+1, meet at a named barrier, and one
//     warp applies the moment algebra and writes 32 consecutive floats to
//     each of the nine output rows. One CTA-wide barrier per sub-chunk.
// 83 KB of dynamic shared memory (f32x16 rows; 79 and 77 KB packed) and 32
// registers: two CTAs per SM (one CTA
// per SM with 48 registers measured 4.3 ms against 3.9; sub-chunks of 16 rows
// 4.5 ms: the warps of a CTA finish a sub-chunk at different times and wait
// at its barrier, and fewer rows between barriers even that out less).
// Arithmetic: expf as in the forward; the one division per (row, pixel) is
// __fdividef (2 ulp, divisor in [1e-9, 1]) because the IEEE division's slow
// path and the registers it pins cost 14 % of the kernel (4.5 -> 3.9 ms) for
// a last-bit difference, 2e-6 of a column's scale in the result. __expf would
// save 5 % more (3.7 ms) and was not taken: w stays the forward's.
//
// Bound on an H100: operations, counted on the pairs that need them. A
// (row, pixel) pair whose weight falls under the discard adds nothing to any
// output, so the work the function needs is, per pair ABOVE the discard, the
// forward's replay (one exp, ~15 fp32 multiply-adds) and the gradient
// arithmetic (cdot 3, eff/S 2, dw with its division ~6, dqh/T 2, nine
// products ~9, the reduction's adds ~9 amortised), counted as 2 * 40 flop,
// plus per row one test against its tile's rectangle (2 * 25 flop). How many
// pairs lie above the discard depends on the view and is counted from the
// inputs (chip_smoke.py does, with the plain weights). A warp evaluates a
// listed row in all 32 lanes, so the kernel does several times that work.
// Bytes: 64, 32 or 16 B per slot read by layout, 36 B per slot written,
// 56 B (36 B in bf16) per pixel and segment read. The packed layouts change
// the bytes, not the operations.

#include "composite_bwd.cuh"

namespace {

template <int kLayout>
int launch_bwd_rows(int rows_bf16, const void* inst, const void* tile_start,
                    const void* tile_walked, const void* ckpt, const void* out_res,
                    const void* dout, void* d_inst, int num_segments, int num_tiles, int mcap,
                    int tiles_x, int tile_size, int height, int block, float ln_cutoff,
                    int use_cutoff, MeanDecode md, cudaStream_t stream) {
  if (rows_bf16) {
    return launch_bwd<kLayout, __nv_bfloat16>(
        inst, tile_start, tile_walked, ckpt, out_res, dout, d_inst, num_segments, num_tiles,
        mcap, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, md, stream);
  }
  return launch_bwd<kLayout, float>(
      inst, tile_start, tile_walked, ckpt, out_res, dout, d_inst, num_segments, num_tiles,
      mcap, tiles_x, tile_size, height, block, ln_cutoff, use_cutoff, md, stream);
}

}  // namespace

extern "C" int splat_composite_bwd(const void* inst, const void* tile_start,
                                   const void* tile_walked, const void* ckpt,
                                   const void* out_res, const void* dout,
                                   void* d_inst, int num_segments, int seg_blocks,
                                   int num_tiles, int mcap, int tiles_x,
                                   int tile_size, int height, int block,
                                   float ln_cutoff, int use_cutoff, int layout,
                                   float mean_step_x, float mean_step_y, float mean_off_x,
                                   float mean_off_y, int rows_bf16, void* stream) {
  if (num_tiles <= 0 || num_segments <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || mcap <= 0 || seg_blocks != kSegBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MeanDecode md{mean_step_x, mean_step_y, mean_off_x, mean_off_y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kRowF32x16:
      return launch_bwd_rows<kRowF32x16>(rows_bf16, inst, tile_start, tile_walked, ckpt,
                                         out_res, dout, d_inst, num_segments, num_tiles, mcap,
                                         tiles_x, tile_size, height, block, ln_cutoff,
                                         use_cutoff, md, s);
    case kRowI32x8:
      return launch_bwd_rows<kRowI32x8>(rows_bf16, inst, tile_start, tile_walked, ckpt,
                                        out_res, dout, d_inst, num_segments, num_tiles, mcap,
                                        tiles_x, tile_size, height, block, ln_cutoff,
                                        use_cutoff, md, s);
    case kRowI32x4:
      return launch_bwd_rows<kRowI32x4>(rows_bf16, inst, tile_start, tile_walked, ckpt,
                                        out_res, dout, d_inst, num_segments, num_tiles, mcap,
                                        tiles_x, tile_size, height, block, ln_cutoff,
                                        use_cutoff, md, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
