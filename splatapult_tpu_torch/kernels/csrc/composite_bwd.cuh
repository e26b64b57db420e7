// The kernel of composite_bwd.cu (its head comment has the contract and the
// design), for sm_90a, templated on an ablation variant. composite_bwd.cu
// instantiates kBwdFull, which is the shipped kernel: every other variant's
// code sits behind `if constexpr` and is compiled out of it.
// composite_bwd_ablate.cu instantiates the others for the f32x16 rows, for
// the ablation microbenchmark (splatapult_tpu_torch/tools/microbench_bwdk.py,
// the counterpart of tools/microbench_bwdk.py): each variant is this body
// with one piece taken out.
//   kBwdNoWork    the rows are staged (cp.async, the CTA barriers) and every
//                 row's nine d_inst values are written as zeros;
//   kBwdNoScan    T does not fall within a block (eff = T at the block's
//                 start times w); at the block's end T is multiplied by 1 - w
//                 of its last row (the forward's kFwdNoScan, replayed);
//   kBwdNoScan2   the running sum S of eff * cdot that dw reads is S at the
//                 block's start plus the current row's term only (S itself
//                 still runs on, to start the next block);
//   kBwdNoMom     the six geometry columns all equal the pixel sum of dqh:
//                 one warp sum of four values (dqh and the colour terms)
//                 replaces warp_sum9 and the moment algebra;
//   kBwdTriBf16   T before a row is T at the block's start times
//                 exp(sum of bf16(log(max(1 - w_j, 1e-37))) over the block's
//                 earlier rows), as the forward's kFwdScanBf16.
// A variant whose T walk differs from the shipped one (kBwdNoScan,
// kBwdTriBf16) starts every segment from the checkpoints and walked blocks
// of that variant's forward. They find a block's end by sub-chunk: their
// launcher takes blocks of a multiple of 32 rows only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_cull.cuh"
#include "row_layout.cuh"
#include "segments.cuh"
#include "warp_search.cuh"

enum BwdVariant : int {
  kBwdFull = 0,
  kBwdNoWork = 1,
  kBwdNoScan = 2,
  kBwdNoScan2 = 3,
  kBwdNoMom = 4,
  kBwdTriBf16 = 5,
};

namespace {

constexpr bool kPatchWarps = true;  // a warp is 8 x 4 pixels, not 32 x 1
constexpr int kMaxThreads = 1024;  // one pixel per thread: tiles up to 32 x 32
constexpr int kChunkRows = 32;     // instance rows per sub-chunk
constexpr int kRowBufs = 4;        // ring of staged sub-chunks (walked, summed, arriving)
constexpr int kOutRows = 8;
constexpr int kGradCols = 9;
constexpr int kSlotFloats = kChunkRows * kGradCols;  // one warp's slots of a sub-chunk
constexpr int kSumThreads = (kSlotFloats + 31) / 32 * 32;  // warps that add the slots
constexpr unsigned kFullMask = 0xffffffffu;

// the ring of staged rows (bytes, a multiple of 16), then the slot arrays
__host__ __device__ constexpr int row_ring_bytes(int row_bytes) {
  return kRowBufs * kChunkRows * row_bytes;
}

__host__ __device__ constexpr int smem_bytes(int nwarps, int row_bytes) {
  return row_ring_bytes(row_bytes) +
         (2 * nwarps * kSlotFloats + kSlotFloats) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// The forward's rows and their cotangent, read in their type (f32, or bf16
// with bf16 accumulation) and widened to f32.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// kBwdNoMom's warp sum: four values, reduced transposed as in warp_sum9
// (2 + 1 + 3 shuffles); afterwards m[0] of lane l holds the sum of value l / 8.
__device__ __forceinline__ void warp_sum4(float (&m)[4], int lane) {
  {
    const bool hi = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = hi ? m[i] : m[i + 2];
      const float keep = hi ? m[i + 2] : m[i];
      m[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
    }
  }
  {
    const bool hi = (lane & 8) != 0;
    const float send = hi ? m[0] : m[1];
    const float keep = hi ? m[1] : m[0];
    m[0] = keep + __shfl_xor_sync(kFullMask, send, 8);
  }
  m[0] += __shfl_xor_sync(kFullMask, m[0], 4);
  m[0] += __shfl_xor_sync(kFullMask, m[0], 2);
  m[0] += __shfl_xor_sync(kFullMask, m[0], 1);
}

template <int kLayout, typename Res, int kVariant>
__global__ void __launch_bounds__(kMaxThreads, 2)
composite_bwd_kernel(const unsigned char* __restrict__ inst,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_walked,
                     const float* __restrict__ ckpt,
                     const Res* __restrict__ out_res,
                     const Res* __restrict__ dout,
                     float* __restrict__ d_inst, size_t mcap, int num_tiles,
                     int tiles_x, int tile_size, int height, int block,
                     float ln_cutoff, int use_cutoff, MeanDecode md) {
  using Row = RowLayout<kLayout>;
  constexpr int kRowBufBytes = kChunkRows * Row::kBytes;
  extern __shared__ __align__(16) unsigned char smem[];

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
  unsigned char* const rows = smem;  // [kRowBufs][kChunkRows] rows in the layout
  float* const part = reinterpret_cast<float*>(smem + row_ring_bytes(Row::kBytes));
  // part: [2][nwarps][kSlotFloats]
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

  // sub-chunk i of the segment -> rows[i % kRowBufs], asynchronously, in
  // 16-byte pieces (4, 2 or 1 per row by layout)
  auto stage = [&](int i) {
    const int n16 = min(kChunkRows, nrows_seg - i * kChunkRows) * (Row::kBytes / 16);
    unsigned char* dst = rows + (i & (kRowBufs - 1)) * kRowBufBytes;
    const unsigned char* src = inst + (first_row + (size_t)i * kChunkRows) * Row::kBytes;
    for (int c = tid; c < n16; c += nthreads) cp_async16(dst + c * 16, src + c * 16);
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
    const Res* o = out_res + (size_t)t * kOutRows * npix;
    const Res* d = dout + (size_t)t * kOutRows * npix;
    const float* c = ckpt + (size_t)seg * 4 * npix;
    dR = widen(d[p]);
    dG = widen(d[npix + p]);
    dB = widen(d[2 * npix + p]);
    kconst = (widen(d[3 * npix + p]) - widen(d[4 * npix + p])) * widen(o[4 * npix + p])
             - (dR * widen(o[p]) + dG * widen(o[npix + p]) + dB * widen(o[2 * npix + p]));
    ssum = dR * c[p] + dG * c[npix + p] + dB * c[2 * npix + p];
    tr = c[3 * npix + p];
  }
  // the ablation variants' per-pixel state (the shipped kernel never reads
  // it): S at the block's start (kBwdNoScan2); the block's exclusive sum of
  // rounded logs and 1 - w of its last row (kBwdTriBf16)
  float s_blk = ssum;
  float lsum = 0.0f, last_om = 1.0f;
  cp_async_wait_all();
  __syncthreads();

  const int nsum = min(nthreads, kSumThreads);
  // phase i: walk sub-chunk i into slot buffer i % 2, while the first warps
  // turn slot buffer (i - 1) % 2 into the output rows of sub-chunk i - 1
  for (int i = 0; i <= nsub; ++i) {
    if (i + 1 < nsub) stage(i + 1);

    if (i > 0 && tid < nsum) {
      if constexpr (kVariant == kBwdNoWork) {
        const int prev_rows = min(kChunkRows, nrows_seg - (i - 1) * kChunkRows);
        if (warp == 0 && lane < prev_rows) {
          float* o = d_inst + first_row + (size_t)(i - 1) * kChunkRows + lane;
#pragma unroll
          for (int c = 0; c < kGradCols; ++c) o[c * mcap] = 0.0f;
        }
      } else {
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
        if constexpr (kVariant == kBwdNoMom) {
          if (warp == 0 && lane < prev_rows) {
            const float* mo = sums + lane * kGradCols;
            float* o = d_inst + first_row + (size_t)(i - 1) * kChunkRows + lane;
#pragma unroll
            for (int c = 0; c < 6; ++c) o[c * mcap] = mo[0];
            o[6 * mcap] = mo[6];
            o[7 * mcap] = mo[7];
            o[8 * mcap] = mo[8];
          }
        } else if (warp == 0 && lane < prev_rows) {
          const float* mo = sums + lane * kGradCols;
          const RowGeometry g = Row::geometry(
              rows + ((i - 1) & (kRowBufs - 1)) * kRowBufBytes + lane * Row::kBytes, md);
          const float mxu = g.mx - tcx;
          const float myu = g.my - tcy;
          const float qa = g.qa, qb = g.qb, qc = g.qc;
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
    }

    if (kVariant != kBwdNoWork && i < nsub) {
      const unsigned char* rb = rows + (i & (kRowBufs - 1)) * kRowBufBytes;
      float* slots = part + ((i & 1) * nwarps + warp) * kSlotFloats;
      const int nrows = min(kChunkRows, nrows_seg - i * kChunkRows);
      const bool ends_block = (i + 1) * kChunkRows % block == 0;
      if constexpr (kVariant == kBwdNoScan2) {
        if (i * kChunkRows % block == 0) s_blk = ssum;
      }
      // which rows can reach this warp's pixels at all: lane r rules on row r
      // against the warp's rectangle of pixel centres, the ballot is the list
      unsigned cand;
      {
        float xlo, xhi, ylo, yhi;
        warp_rect(px, py, has_pixel, xlo, xhi, ylo, yhi);
        bool maybe = lane < nrows;
        if (maybe && use_cutoff) {
          const RowGeometry g = Row::geometry(rb + lane * Row::kBytes, md);
          maybe = row_may_touch(g.mx, g.my, g.qa, g.qb, g.qc, g.lna, ln_cutoff,
                                xlo, xhi, ylo, yhi);
        }
        cand = __ballot_sync(kFullMask, maybe);
      }
      // kBwdNoScan: whether the sub-chunk's last row is listed, and the last
      // listed row's w (the walk takes the rows in order)
      const bool last_listed = (cand >> (nrows - 1)) & 1u;
      float w_last = 0.0f;
      while (cand != 0u) {
        const int r = __ffs(cand) - 1;
        cand &= cand - 1u;
        float colr, colg, colb;
        const RowGeometry g = Row::decode(rb + r * Row::kBytes, md, colr, colg, colb);
        const float dx = px - g.mx;
        const float dy = py - g.my;
        const float qh = g.qa * dx * dx + g.qb * dx * dy + g.qc * dy * dy + g.lna;
        float w = 0.0f;
        if (has_pixel && (!use_cutoff || qh > ln_cutoff)) w = expf(qh);
        const float cdot = colr * dR + colg * dG + colb * dB;
        float eff, dw;
        if constexpr (kVariant == kBwdNoScan) {
          eff = tr * w;  // T at the block's start
          ssum += eff * cdot;
          dw = __fdividef(kconst + ssum, fmaxf(1.0f - w, 1e-9f)) + tr * cdot;
          w_last = w;
        } else if constexpr (kVariant == kBwdTriBf16) {
          const float t_before = tr * expf(lsum);
          eff = t_before * w;
          ssum += eff * cdot;
          dw = __fdividef(kconst + ssum, fmaxf(1.0f - w, 1e-9f)) + t_before * cdot;
          if (ends_block && r == nrows - 1) {
            last_om = 1.0f - w;
          } else {
            lsum += __bfloat162float(__float2bfloat16_rn(logf(fmaxf(1.0f - w, 1e-37f))));
          }
        } else if constexpr (kVariant == kBwdNoScan2) {
          eff = tr * w;
          ssum += eff * cdot;
          dw = __fdividef(kconst + s_blk + eff * cdot, fmaxf(1.0f - w, 1e-9f)) + tr * cdot;
          tr *= 1.0f - w;
        } else {
          eff = tr * w;
          ssum += eff * cdot;
          // the fast division (2 ulp; the divisor lies in [1e-9, 1]): the exact
          // one's slow path cost a seventh of the kernel's time
          dw = __fdividef(kconst + ssum, fmaxf(1.0f - w, 1e-9f)) + tr * cdot;
          tr *= 1.0f - w;
        }
        const float dqh = w * dw;
        if constexpr (kVariant == kBwdNoMom) {
          float m[4] = {dqh, eff * dR, eff * dG, eff * dB};
          warp_sum4(m, lane);
          // sum 0 sits in lane 0, sums 1-3 in lanes 8, 16, 24
          float* slot = slots + r * kGradCols;
          if ((lane & 7) == 0) slot[lane == 0 ? 0 : 5 + (lane >> 3)] = m[0];
        } else {
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
      if constexpr (kVariant == kBwdNoScan) {
        if (ends_block && last_listed) tr *= 1.0f - w_last;
      } else if constexpr (kVariant == kBwdTriBf16) {
        if (ends_block) {
          tr = tr * (expf(lsum) * last_om);
          lsum = 0.0f;
          last_om = 1.0f;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <int kLayout, typename Res, int kVariant = kBwdFull>
int launch_bwd(const void* inst, const void* tile_start, const void* tile_walked,
               const void* ckpt, const void* out_res, const void* dout, void* d_inst,
               int num_segments, int num_tiles, int mcap, int tiles_x, int tile_size,
               int height, int block, float ln_cutoff, int use_cutoff, MeanDecode md,
               cudaStream_t stream) {
  constexpr int kRowBytes = RowLayout<kLayout>::kBytes;
  const int threads = (tile_size * tile_size + 31) / 32 * 32;
  // above 48 KB shared memory is granted only on request: asked once per
  // device and instantiation, not per launch
  static int granted_device = -1;
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != granted_device) {
    err = cudaFuncSetAttribute(composite_bwd_kernel<kLayout, Res, kVariant>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(kMaxThreads / 32, kRowBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_device = device;
  }
  composite_bwd_kernel<kLayout, Res, kVariant>
      <<<num_segments, threads, smem_bytes(threads / 32, kRowBytes), stream>>>(
          static_cast<const unsigned char*>(inst), static_cast<const int*>(tile_start),
          static_cast<const int*>(tile_walked), static_cast<const float*>(ckpt),
          static_cast<const Res*>(out_res), static_cast<const Res*>(dout),
          static_cast<float*>(d_inst), static_cast<size_t>(mcap), num_tiles, tiles_x,
          tile_size, height, block, ln_cutoff, use_cutoff, md);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
