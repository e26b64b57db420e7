// composite_bwd: transmittance-replay backward of the per-tile compositing,
// for sm_90a.
//
// Replaces the TPU kernel splatapult_tpu/ops/composite.py::_bwd_kernel
// (launched by _bwd_call; helpers moment_basis, _block_weights, _tile_centers,
// _scan_rows_add, _excl_cumprod_rows).
//
// Contract. `inst`, `tile_start`, `tile_nblk` and `tile_order` are the
// forward's (composite_fwd.cu). `out_res` [T, 8, P] holds the forward's final
// rows (r, g, b, alpha, T_fin, ...), `dout` [T, 8, P] the cotangent of those
// rows; rows 0-4 of each are read. For every pixel p of tile t, with the
// per-pixel constant
//   K = (dalpha - dT) * T_fin - (dR * r_fin + dG * g_fin + dB * b_fin)
// the kernel re-walks the tile's instances front to back with T = 1, S = 0:
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
// caller zero-fills it: blocks skipped by the early stop and blocks past
// every tile's list are written by no CTA. The early stop is the forward's
// block-level test (from a tile's second block on, run only while some pixel
// has T >= eps), so both passes walk the same blocks.
//
// Design for this card. The TPU kernel carries (T, colour so far) between
// grid steps in scratch memory, takes its within-block prefix sums as
// triangular matrix products and its pixel sums as a [B,P]x[P,8] product,
// because that machine has a matrix unit and no cheap per-lane recurrence.
// Here one CTA owns a tile and one thread owns a pixel, exactly as in the
// forward, so T and S are two registers and the prefix sums are the loop
// itself. What costs is the other direction: nine sums over the CTA's pixels
// for every instance. A warp is one 32-pixel stretch of the tile and most
// instances touch few of them, so each warp first votes (__any_sync) whether
// any of its lanes has w != 0 and otherwise does no arithmetic at all; a warp
// that is touched reduces its nine values by shuffles (warp_sum9: 14 of them,
// where nine separate butterflies take 45 and measured 16.2 ms against 12.2)
// into the warp's slot in shared memory. Rows go through in sub-chunks of 32
// (32 rows x 32 warps x 9 floats = 36 KB of static shared memory); after each
// sub-chunk the CTA adds the slots in fixed warp order, so the result is the
// same from run to run (shared-memory atomics would not be), applies the
// moment algebra and writes 32 consecutive floats to each of the nine output
// rows. expf and a true division, no fast-math: results stay within float
// rounding of the plain version.
//
// Bound on an H100: operations. Per (instance slot, pixel) the replay costs
// what the forward costs (one exp, ~15 fp32 multiply-adds) and the gradient
// arithmetic about as much again (cdot 3, eff/S 2, dw with its division ~6,
// dqh/T 2, nine products ~9, the reduction's adds ~9 amortised): counted as
// 2 * 40 flop. Bytes are small beside that: 64 B per slot read, 36 B per slot
// written, 40 B per pixel read.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // one pixel per thread: tiles up to 32 x 32
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunkRows = 32;  // instance rows reduced per shared-memory round
constexpr int kNumFeats = 16;   // floats per feature row (64 B)
constexpr int kOutRows = 8;
constexpr int kGradCols = 9;
constexpr unsigned kFullMask = 0xffffffffu;

// Sums of nine per-lane values over the warp. The first eight are reduced
// "transposed": at each of the first three steps a lane keeps half of its
// values and hands the other half to its partner, so the eight sums take
// 4 + 2 + 1 + 2 shuffles instead of 8 x 5 and end up spread over the lanes:
// afterwards m[0] of lane l holds the warp's sum of value l / 4. The ninth
// takes the plain five-step butterfly and ends up in m[8] of every lane.
__device__ __forceinline__ void warp_sum9(float (&m)[kGradCols], int lane) {
  {
    const bool hi = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = hi ? m[i] : m[i + 4];
      const float keep = hi ? m[i + 4] : m[i];
      m[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
    }
  }
  {
    const bool hi = (lane & 8) != 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = hi ? m[i] : m[i + 2];
      const float keep = hi ? m[i + 2] : m[i];
      m[i] = keep + __shfl_xor_sync(kFullMask, send, 8);
    }
  }
  {
    const bool hi = (lane & 4) != 0;
    const float send = hi ? m[0] : m[1];
    const float keep = hi ? m[1] : m[0];
    m[0] = keep + __shfl_xor_sync(kFullMask, send, 4);
  }
  m[0] += __shfl_xor_sync(kFullMask, m[0], 2);
  m[0] += __shfl_xor_sync(kFullMask, m[0], 1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m[8] += __shfl_xor_sync(kFullMask, m[8], off);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
composite_bwd_kernel(const float* __restrict__ inst,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_nblk,
                     const int* __restrict__ tile_order,
                     const float* __restrict__ out_res,
                     const float* __restrict__ dout,
                     float* __restrict__ d_inst, size_t mcap,
                     int tiles_x, int tile_size, int height, int block,
                     float ln_cutoff, int use_cutoff, float early_stop_eps) {
  __shared__ __align__(16) float rows[kChunkRows * kNumFeats];
  __shared__ float part[kChunkRows * kMaxWarps * kGradCols];

  const int t = tile_order[blockIdx.x];
  const int p = threadIdx.x;  // this thread's pixel (blockDim >= npix)
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = blockDim.x >> 5;
  const int npix = tile_size * tile_size;
  const bool has_pixel = p < npix;

  // tile-local offsets and pixel centre, as in the forward
  const float tcx = (float)(t % tiles_x) * tile_size + 0.5f * tile_size;
  const float tcy = (float)height - (float)(t / tiles_x) * tile_size - 0.5f * tile_size;
  const float u = (float)(p % tile_size) + 0.5f - 0.5f * tile_size;
  const float v = 0.5f * tile_size - (float)(p / tile_size) - 0.5f;
  const float px = tcx + u;
  const float py = tcy + v;

  // per-pixel cotangents and the constant K
  float dR = 0.0f, dG = 0.0f, dB = 0.0f, kconst = 0.0f;
  if (has_pixel) {
    const float* o = out_res + (size_t)t * kOutRows * npix;
    const float* d = dout + (size_t)t * kOutRows * npix;
    dR = d[p];
    dG = d[npix + p];
    dB = d[2 * npix + p];
    kconst = (d[3 * npix + p] - d[4 * npix + p]) * o[4 * npix + p]
             - (dR * o[p] + dG * o[npix + p] + dB * o[2 * npix + p]);
  }
  float tr = 1.0f;    // T before the current instance
  float ssum = 0.0f;  // S: running sum of eff * cdot

  const int nblk = tile_nblk[t];
  const size_t first_row = (size_t)tile_start[t] * block;
  for (int blk = 0; blk < nblk; ++blk) {
    if (early_stop_eps > 0.0f && blk > 0) {
      // the forward's block-level early stop: T never grows, so every later
      // block is skipped too (their columns stay zero)
      if (!__syncthreads_or(has_pixel && tr >= early_stop_eps)) break;
    }
    for (int c0 = 0; c0 < block; c0 += kChunkRows) {
      const int nrows = min(kChunkRows, block - c0);
      const size_t row0 = first_row + (size_t)blk * block + c0;
      const float* src = inst + row0 * kNumFeats;
      const int nfloat = nrows * kNumFeats;
      __syncthreads();  // previous sub-chunk's rows and slots fully consumed
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
        if (has_pixel && (!use_cutoff || qh > ln_cutoff)) w = expf(qh);
        float m[kGradCols];
#pragma unroll
        for (int k = 0; k < kGradCols; ++k) m[k] = 0.0f;
        if (__any_sync(kFullMask, w != 0.0f)) {
          const float cdot = g1.z * dR + g1.w * dG + colb * dB;
          const float eff = tr * w;
          ssum += eff * cdot;
          const float dw = (kconst + ssum) / fmaxf(1.0f - w, 1e-9f) + tr * cdot;
          const float dqh = w * dw;
          tr *= 1.0f - w;
          const float dqh_u = dqh * u;
          const float dqh_v = dqh * v;
          m[0] = dqh_u * u;
          m[1] = dqh_u * v;
          m[2] = dqh_v * v;
          m[3] = dqh_u;
          m[4] = dqh_v;
          m[5] = dqh;
          m[6] = eff * dR;
          m[7] = eff * dG;
          m[8] = eff * dB;
          warp_sum9(m, lane);
        }
        // the warp's slot (zeros when untouched): sums 0-7 sit in lanes 0, 4, .., 28
        float* slot = part + (r * nwarps + warp) * kGradCols;
        if ((lane & 3) == 0) slot[lane >> 2] = m[0];
        if (lane == 0) slot[8] = m[8];
      }
      __syncthreads();

      // the CTA's sums in fixed warp order, left in warp 0's slot
      for (int i = p; i < nrows * kGradCols; i += blockDim.x) {
        const int r = i / kGradCols;
        const int k = i - r * kGradCols;
        const float* col = part + (size_t)r * nwarps * kGradCols + k;
        float acc = col[0];
        for (int wp = 1; wp < nwarps; ++wp) acc += col[wp * kGradCols];
        part[(size_t)r * nwarps * kGradCols + k] = acc;
      }
      __syncthreads();

      // moments -> the nine gradient columns of each row (dx = u - mxu,
      // dy = v - myu with the mean in tile-local coordinates)
      if (p < nrows) {
        const float* mo = part + (size_t)p * nwarps * kGradCols;
        const float* f = rows + p * kNumFeats;
        const float mxu = f[0] - tcx;
        const float myu = f[1] - tcy;
        const float qa = f[2], qb = f[3], qc = f[4];
        const float m_uu = mo[0], m_uv = mo[1], m_vv = mo[2];
        const float m_u = mo[3], m_v = mo[4], m_1 = mo[5];
        const float gx = m_u - mxu * m_1;  // sum dqh * dx
        const float gy = m_v - myu * m_1;
        float* o = d_inst + row0 + p;
        o[0] = -(2.0f * qa * gx + qb * gy);
        o[mcap] = -(qb * gx + 2.0f * qc * gy);
        o[2 * mcap] = m_uu - 2.0f * mxu * m_u + mxu * mxu * m_1;
        o[3 * mcap] = m_uv - mxu * m_v - myu * m_u + mxu * myu * m_1;
        o[4 * mcap] = m_vv - 2.0f * myu * m_v + myu * myu * m_1;
        o[5 * mcap] = m_1;
        o[6 * mcap] = mo[6];
        o[7 * mcap] = mo[7];
        o[8 * mcap] = mo[8];
      }
    }
  }
}

}  // namespace

extern "C" int splat_composite_bwd(const void* inst, const void* tile_start,
                                   const void* tile_nblk, const void* tile_order,
                                   const void* out_res, const void* dout,
                                   void* d_inst, int num_tiles, int mcap,
                                   int tiles_x, int tile_size, int height,
                                   int block, float ln_cutoff, int use_cutoff,
                                   float early_stop_eps, void* stream) {
  if (num_tiles <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || mcap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (npix + 31) / 32 * 32;
  composite_bwd_kernel<<<num_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_nblk), static_cast<const int*>(tile_order),
      static_cast<const float*>(out_res), static_cast<const float*>(dout),
      static_cast<float*>(d_inst), static_cast<size_t>(mcap), tiles_x, tile_size,
      height, block, ln_cutoff, use_cutoff, early_stop_eps);
  return static_cast<int>(cudaGetLastError());
}
