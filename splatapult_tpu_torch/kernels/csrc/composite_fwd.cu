// composite_fwd: per-tile front-to-back alpha compositing, for sm_90a.
//
// Replaces the TPU kernel splatapult_tpu/ops/composite.py::_fwd_kernel
// (launched by _fwd_call; helpers _unpack_feats, _block_weights,
// _excl_cumprod_rows, _pixel_coords).
//
// Contract. `inst` is the tile-sorted, block-aligned instance buffer
// [mcap, 16] f32 (columns mean_x, mean_y, qa, qb, qc, ln_alpha, r, g,
// b, 0...; null rows carry ln_alpha = -100). Tile t owns the `block`-row
// blocks [tile_start[t], tile_start[t] + tile_nblk[t]). For every pixel p of
// the tile, walking its instances in order with T = 1 at the start:
//   qh = qa*dx*dx + qb*dx*dy + qc*dy*dy + ln_alpha     (dx, dy from the
//        gl_FragCoord-style pixel centre, +y up)
//   w  = exp(qh), or 0 where qh <= ln(alpha_cutoff)    (the 1/256 discard)
//   rgb += T * w * colour;  T *= 1 - w
// and the output rows [T, 8, P] are (r, g, b, 1 - T, T, 0, 0, 0). A tile with
// no block writes the background (0, 0, 0, 0, 1, 0, 0, 0). With
// early_stop_eps > 0 a whole block is skipped once every pixel of the tile
// has T < eps — the same block-level test the TPU kernel makes, so both give
// the same image.
//
// Design for this card. On the TPU the grid walks all blocks in order and the
// output block doubles as the carry between grid steps; here nothing carries
// between CTAs, so one CTA owns one tile and loops over that tile's blocks
// itself. Each thread owns ONE pixel (a 32x32 tile = 1024 threads) with colour
// and transmittance in registers; each chunk of up to 128 feature rows is
// staged through 8 KB of shared memory with 16-byte loads and then read back
// as broadcasts (every thread reads the same row). The sequential product
// over the instances replaces the log-space triangular matrix scan of the TPU
// kernel (no 1e-37 floor: a fully opaque instance leaves T exactly 0). The
// early-stop test is a CTA-wide vote (__syncthreads_or). expf, not __expf,
// and no fast-math: results stay within float rounding of the plain version.
//
// Tile depths are very uneven (a garden view: mean 9 blocks, deepest 147), and
// a tile's instances are a serial chain, so the deepest tiles set the
// kernel's time. Two things answer that: one pixel per thread keeps a deep
// tile's chain as short as it can be inside one CTA (more pixels per thread
// amortise the shared-memory reads but lengthen the chain, and measured
// slower), and CTAs take their tiles from `tile_order`, deepest first, so
// the long chains start at once and the shallow tiles fill in behind them.
// Splitting a deep tile's list over several CTAs and combining the partial
// (colour, T) pairs is the next step, for a later change.
//
// Bound on an H100: operations. Per (instance slot, pixel) it does one exp
// and about 15 fp32 multiply-adds; with S slots and P pixels per tile that
// is 2 * 15 * S * P flop against 67 TFLOP/s fp32 (S = 2.4M, P = 1024:
// 74 GFLOP, about 1.1 ms), above both the exp count at the special-function
// rate (16 per SM per clock) and the bytes (64 B per slot + 32 B per pixel:
// about 0.22 GB, 0.07 ms at 3.35 TB/s).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // one pixel per thread: tiles up to 32 x 32
constexpr int kChunkRows = 128;    // feature rows staged per shared-memory fill
constexpr int kNumFeats = 16;     // floats per feature row (64 B)
constexpr int kOutRows = 8;

__global__ void __launch_bounds__(kMaxThreads)
composite_fwd_kernel(const float* __restrict__ inst,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_nblk,
                     const int* __restrict__ tile_order,
                     float* __restrict__ out,
                     int tiles_x, int tile_size, int height, int block,
                     float ln_cutoff, int use_cutoff, float early_stop_eps) {
  __shared__ __align__(16) float rows[kChunkRows * kNumFeats];

  const int t = tile_order[blockIdx.x];
  const int p = threadIdx.x;  // this thread's pixel (blockDim >= npix)
  const int npix = tile_size * tile_size;
  const bool has_pixel = p < npix;

  // pixel centre, exactly as the reference lays it out: tile centre plus
  // tile-local offset, all exact in f32 (integers and halves)
  const float tcx = (float)(t % tiles_x) * tile_size + 0.5f * tile_size;
  const float tcy = (float)height - (float)(t / tiles_x) * tile_size - 0.5f * tile_size;
  const float px = tcx + ((float)(p % tile_size) + 0.5f - 0.5f * tile_size);
  const float py = tcy + (0.5f * tile_size - (float)(p / tile_size) - 0.5f);
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, tr = 1.0f;

  const int nblk = tile_nblk[t];
  const size_t first_row = (size_t)tile_start[t] * block;
  for (int blk = 0; blk < nblk; ++blk) {
    if (early_stop_eps > 0.0f && blk > 0) {
      // block-level early stop: skip once no pixel of the tile has T >= eps
      if (!__syncthreads_or(has_pixel && tr >= early_stop_eps)) break;
    }
    for (int c0 = 0; c0 < block; c0 += kChunkRows) {
      const int nrows = min(kChunkRows, block - c0);
      const float* src = inst + (first_row + (size_t)blk * block + c0) * kNumFeats;
      const int nfloat = nrows * kNumFeats;
      __syncthreads();  // previous chunk fully consumed
      for (int i = p * 4; i < nfloat; i += blockDim.x * 4) {
        *reinterpret_cast<float4*>(rows + i) =
            *reinterpret_cast<const float4*>(src + i);
      }
      __syncthreads();
      for (int r = 0; r < nrows; ++r) {
        const float* f = rows + r * kNumFeats;
        const float4 g0 = *reinterpret_cast<const float4*>(f);      // mx my qa qb
        const float4 g1 = *reinterpret_cast<const float4*>(f + 4);  // qc lna r g
        const float colb = f[8];
        const float dx = px - g0.x;
        const float dy = py - g0.y;
        const float qh = g0.z * dx * dx + g0.w * dx * dy + g1.x * dy * dy + g1.y;
        float w = 0.0f;
        if (!use_cutoff || qh > ln_cutoff) w = expf(qh);
        const float eff = tr * w;
        cr += eff * g1.z;
        cg += eff * g1.w;
        cb += eff * colb;
        tr *= 1.0f - w;
      }
    }
  }

  if (has_pixel) {
    float* o = out + (size_t)t * kOutRows * npix;
    o[p] = cr;
    o[npix + p] = cg;
    o[2 * npix + p] = cb;
    o[3 * npix + p] = 1.0f - tr;
    o[4 * npix + p] = tr;
    o[5 * npix + p] = 0.0f;
    o[6 * npix + p] = 0.0f;
    o[7 * npix + p] = 0.0f;
  }
}

}  // namespace

extern "C" int splat_composite_fwd(const void* inst, const void* tile_start,
                                   const void* tile_nblk, const void* tile_order,
                                   void* out, int num_tiles, int tiles_x,
                                   int tile_size, int height, int block,
                                   float ln_cutoff, int use_cutoff,
                                   float early_stop_eps, void* stream) {
  if (num_tiles <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (npix + 31) / 32 * 32;
  composite_fwd_kernel<<<num_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_nblk), static_cast<const int*>(tile_order),
      static_cast<float*>(out), tiles_x, tile_size, height, block, ln_cutoff,
      use_cutoff, early_stop_eps);
  return static_cast<int>(cudaGetLastError());
}
