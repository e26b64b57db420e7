// composite_bwd: transmittance-replay backward of the per-tile compositing,
// for sm_90a.
//
// Replaces the TPU kernel splatapult_tpu/ops/composite.py::_bwd_kernel
// (launched by _bwd_call; helpers moment_basis, _block_weights, _tile_centers,
// _scan_rows_add, _excl_cumprod_rows).
//
// Contract. `inst` and `tile_start` are the forward's (composite_fwd.cu).
// `out_res` [T, 8, P] holds the forward's final rows (r, g, b, alpha, T_fin,
// ...), `dout` [T, 8, P] the cotangent of those rows; rows 0-4 of each are
// read. For every pixel p of tile t, with the per-pixel constant
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
//   - rows arrive in sub-chunks of 32 by cp.async into a ring of four 2 KB
//     buffers, the next sub-chunk while this one is walked;
//   - per sub-chunk every warp first makes its list of rows: lane r takes row
//     r and asks whether its gaussian can exceed the discard anywhere in the
//     rectangle of the warp's pixel centres (row_may_touch in row_cull.cuh,
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
// 83 KB of dynamic shared memory and 32 registers: two CTAs per SM (one CTA
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
// Bytes: 64 B per slot read, 36 B per slot written, 56 B per pixel and
// segment read.

#include <cuda_runtime.h>

#include "row_cull.cuh"
#include "segments.cuh"
#include "warp_search.cuh"

namespace {

constexpr bool kPatchWarps = true;  // a warp is 8 x 4 pixels, not 32 x 1
constexpr int kMaxThreads = 1024;  // one pixel per thread: tiles up to 32 x 32
constexpr int kChunkRows = 32;     // instance rows per sub-chunk
constexpr int kNumFeats = 16;      // floats per feature row (64 B)
constexpr int kRowBufs = 4;        // ring of staged sub-chunks (walked, summed, arriving)
constexpr int kRowBufFloats = kChunkRows * kNumFeats;
constexpr int kOutRows = 8;
constexpr int kGradCols = 9;
constexpr int kSlotFloats = kChunkRows * kGradCols;  // one warp's slots of a sub-chunk
constexpr int kSumThreads = (kSlotFloats + 31) / 32 * 32;  // warps that add the slots
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int smem_floats(int nwarps) {
  return kRowBufs * kRowBufFloats + 2 * nwarps * kSlotFloats + kSlotFloats;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Barrier among the first `count` threads of the CTA (a multiple of 32).
__device__ __forceinline__ void sum_threads_barrier(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}

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

__global__ void __launch_bounds__(kMaxThreads, 2)
composite_bwd_kernel(const float* __restrict__ inst,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_walked,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ out_res,
                     const float* __restrict__ dout,
                     float* __restrict__ d_inst, size_t mcap, int num_tiles,
                     int tiles_x, int tile_size, int height, int block,
                     float ln_cutoff, int use_cutoff) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // segment number -> (tile, first block); the same in every warp
  const int seg = blockIdx.x;
  const int t = warp_upper_bound(
      [&](int i) { return first_segment(__ldg(tile_start + i), i); }, num_tiles, seg, lane) - 1;
  const int tile_start_t = tile_start[t];
  const int blk0 = (seg - first_segment(tile_start_t, t)) * kSegBlocks;
  const int nblk = min(kSegBlocks, tile_walked[t] - blk0);
  // no such segment: the chain is shorter, or the forward's early stop ended it
  if (nblk <= 0) return;

  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int npix = tile_size * tile_size;
  float* const rows = smem;
  float* const part = rows + kRowBufs * kRowBufFloats;  // [2][nwarps][kSlotFloats]
  float* const sums = part + 2 * nwarps * kSlotFloats;  // [kSlotFloats]

  // this thread's pixel of the tile (row-major index p)
  const int p = kPatchWarps ? patch_pixel(tid, tile_size) : tid;
  const bool has_pixel = p < npix;

  // tile-local offsets and pixel centre, as in the forward
  const float tcx = (float)(t % tiles_x) * tile_size + 0.5f * tile_size;
  const float tcy = (float)height - (float)(t / tiles_x) * tile_size - 0.5f * tile_size;
  const float u = (float)(p % tile_size) + 0.5f - 0.5f * tile_size;
  const float v = 0.5f * tile_size - (float)(p / tile_size) - 0.5f;
  const float px = tcx + u;
  const float py = tcy + v;

  const size_t first_row = ((size_t)tile_start_t + blk0) * block;
  const int nrows_seg = nblk * block;
  const int nsub = (nrows_seg + kChunkRows - 1) / kChunkRows;

  // sub-chunk i of the segment -> rows[i % kRowBufs], asynchronously
  auto stage = [&](int i) {
    const int n16 = min(kChunkRows, nrows_seg - i * kChunkRows) * (kNumFeats / 4);
    float* dst = rows + (i & (kRowBufs - 1)) * kRowBufFloats;
    const float* src = inst + (first_row + (size_t)i * kChunkRows) * kNumFeats;
    for (int c = tid; c < n16; c += nthreads) cp_async16(dst + c * 4, src + c * 4);
  };
  stage(0);
  for (int i = tid * 4; i < 2 * nwarps * kSlotFloats; i += nthreads * 4) {
    *reinterpret_cast<float4*>(part + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // per-pixel cotangents, the constant K, and the state at the segment's start
  float dR = 0.0f, dG = 0.0f, dB = 0.0f, kconst = 0.0f;
  float tr = 1.0f;    // T before the current instance
  float ssum = 0.0f;  // S: running sum of eff * cdot
  if (has_pixel) {
    const float* o = out_res + (size_t)t * kOutRows * npix;
    const float* d = dout + (size_t)t * kOutRows * npix;
    const float* c = ckpt + (size_t)seg * 4 * npix;
    dR = d[p];
    dG = d[npix + p];
    dB = d[2 * npix + p];
    kconst = (d[3 * npix + p] - d[4 * npix + p]) * o[4 * npix + p]
             - (dR * o[p] + dG * o[npix + p] + dB * o[2 * npix + p]);
    ssum = dR * c[p] + dG * c[npix + p] + dB * c[2 * npix + p];
    tr = c[3 * npix + p];
  }
  cp_async_wait_all();
  __syncthreads();

  const int nsum = min(nthreads, kSumThreads);
  // phase i: walk sub-chunk i into slot buffer i % 2, while the first warps
  // turn slot buffer (i - 1) % 2 into the output rows of sub-chunk i - 1
  for (int i = 0; i <= nsub; ++i) {
    if (i + 1 < nsub) stage(i + 1);

    if (i > 0 && tid < nsum) {
      float* prev = part + ((i - 1) & 1) * nwarps * kSlotFloats;
      for (int j = tid; j < kSlotFloats; j += nsum) {
        float acc = 0.0f;
#pragma unroll 8
        for (int wp = 0; wp < nwarps; ++wp) {
          acc += prev[wp * kSlotFloats + j];
          prev[wp * kSlotFloats + j] = 0.0f;
        }
        sums[j] = acc;
      }
      sum_threads_barrier(nsum);
      // moments -> the nine gradient columns of each row (dx = u - mxu,
      // dy = v - myu with the mean in tile-local coordinates)
      const int prev_rows = min(kChunkRows, nrows_seg - (i - 1) * kChunkRows);
      if (warp == 0 && lane < prev_rows) {
        const float* mo = sums + lane * kGradCols;
        const float* f = rows + ((i - 1) & (kRowBufs - 1)) * kRowBufFloats + lane * kNumFeats;
        const float mxu = f[0] - tcx;
        const float myu = f[1] - tcy;
        const float qa = f[2], qb = f[3], qc = f[4];
        const float m_uu = mo[0], m_uv = mo[1], m_vv = mo[2];
        const float m_u = mo[3], m_v = mo[4], m_1 = mo[5];
        const float gx = m_u - mxu * m_1;  // sum dqh * dx
        const float gy = m_v - myu * m_1;
        float* o = d_inst + first_row + (size_t)(i - 1) * kChunkRows + lane;
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

    if (i < nsub) {
      const float* rb = rows + (i & (kRowBufs - 1)) * kRowBufFloats;
      float* slots = part + ((i & 1) * nwarps + warp) * kSlotFloats;
      const int nrows = min(kChunkRows, nrows_seg - i * kChunkRows);
      // which rows can reach this warp's pixels at all: lane r rules on row r
      // against the warp's rectangle of pixel centres, the ballot is the list
      unsigned cand;
      {
        float xlo, xhi, ylo, yhi;
        warp_rect(px, py, has_pixel, xlo, xhi, ylo, yhi);
        bool maybe = lane < nrows;
        if (maybe && use_cutoff) {
          const float* f = rb + lane * kNumFeats;
          const float4 g0 = *reinterpret_cast<const float4*>(f);      // mx my qa qb
          const float2 g1 = *reinterpret_cast<const float2*>(f + 4);  // qc lna
          maybe = row_may_touch(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, ln_cutoff,
                                xlo, xhi, ylo, yhi);
        }
        cand = __ballot_sync(kFullMask, maybe);
      }
      while (cand != 0u) {
        const int r = __ffs(cand) - 1;
        cand &= cand - 1u;
        const float* f = rb + r * kNumFeats;
        const float4 g0 = *reinterpret_cast<const float4*>(f);      // mx my qa qb
        const float4 g1 = *reinterpret_cast<const float4*>(f + 4);  // qc lna r g
        const float dx = px - g0.x;
        const float dy = py - g0.y;
        const float qh = g0.z * dx * dx + g0.w * dx * dy + g1.x * dy * dy + g1.y;
        float w = 0.0f;
        if (has_pixel && (!use_cutoff || qh > ln_cutoff)) w = expf(qh);
        const float cdot = g1.z * dR + g1.w * dG + f[8] * dB;
        const float eff = tr * w;
        ssum += eff * cdot;
        // the fast division (2 ulp; the divisor lies in [1e-9, 1]): the exact
        // one's slow path cost a seventh of the kernel's time
        const float dw = __fdividef(kconst + ssum, fmaxf(1.0f - w, 1e-9f)) + tr * cdot;
        const float dqh = w * dw;
        tr *= 1.0f - w;
        const float dqh_u = dqh * u;
        const float dqh_v = dqh * v;
        float m[kGradCols];
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
        // sums 0-7 sit in lanes 0, 4, .., 28, the ninth in every lane
        float* slot = slots + r * kGradCols;
        if ((lane & 3) == 0) slot[lane >> 2] = m[0];
        if (lane == 0) slot[8] = m[8];
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace

extern "C" int splat_composite_bwd(const void* inst, const void* tile_start,
                                   const void* tile_walked, const void* ckpt,
                                   const void* out_res, const void* dout,
                                   void* d_inst, int num_segments, int seg_blocks,
                                   int num_tiles, int mcap, int tiles_x,
                                   int tile_size, int height, int block,
                                   float ln_cutoff, int use_cutoff, void* stream) {
  if (num_tiles <= 0 || num_segments <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || mcap <= 0 || seg_blocks != kSegBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (npix + 31) / 32 * 32;
  const int smem_bytes = smem_floats(threads / 32) * static_cast<int>(sizeof(float));
  // above 48 KB shared memory is granted only on request: asked once per
  // device, not per launch
  static int granted_device = -1;
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != granted_device) {
    err = cudaFuncSetAttribute(composite_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_floats(kMaxThreads / 32) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_device = device;
  }
  composite_bwd_kernel<<<num_segments, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_walked), static_cast<const float*>(ckpt),
      static_cast<const float*>(out_res), static_cast<const float*>(dout),
      static_cast<float*>(d_inst), static_cast<size_t>(mcap), num_tiles, tiles_x,
      tile_size, height, block, ln_cutoff, use_cutoff);
  return static_cast<int>(cudaGetLastError());
}
