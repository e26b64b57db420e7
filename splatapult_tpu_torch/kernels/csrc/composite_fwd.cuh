// The kernels of composite_fwd.cu (its head comment has the contract and the
// design), for sm_90a, templated on two things the shipped build fixes: an
// ablation variant and the segment length. composite_fwd.cu instantiates
// variant kFwdFull with kSegBlocks, which is the shipped kernel: every other
// variant's code sits behind `if constexpr` and is compiled out of it.
// composite_fwd_ablate.cu instantiates the others for the f32x16 rows, for
// the ablation microbenchmark (splatapult_tpu_torch/tools/microbench_kernel.py,
// the counterpart of tools/microbench_kernel.py): each variant is this body
// with one piece taken out.
//   kFwdNoScan    T does not fall within a block: every row's eff is T at the
//                 block's start times w, and at the block's end T is
//                 multiplied by 1 - w of its last row;
//   kFwdNoExp     w = min(0.01 qh, 0.99) above the discard: no expf;
//   kFwdScanBf16  T before row i of a block is T at its start times
//                 exp(sum over j < i of bf16(log(max(1 - w_j, 1e-37)))), the
//                 sum in f32 (the TPU variant's bf16 triangular product, here
//                 a serial per-pixel sum); the block's factor is that value
//                 at its last row times 1 - w of that row;
//   kFwdNoWork    the rows are staged (bulk copies, mbarrier waits) and
//                 nothing is blended: every local is (0, 0, 0, 1).
// A segment length other than kSegBlocks (16 and 32 blocks: the TPU tool's
// SUB = 2, 4 blocks a grid step) comes with the shipped arithmetic only.
// Each variant's block map stays linear in T at the block's start, so the
// segments and the combine compose it exactly as they compose the shipped
// one. The variants find a block's end by sub-chunk: their launchers take
// blocks of a multiple of 32 rows only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "row_cull.cuh"
#include "row_layout.cuh"
#include "segments.cuh"
#include "warp_search.cuh"

enum FwdVariant : int {
  kFwdFull = 0,
  kFwdNoScan = 1,
  kFwdNoExp = 2,
  kFwdScanBf16 = 3,
  kFwdNoWork = 4,
};

namespace {

constexpr int kMaxThreads = 1024;  // one pixel per thread: tiles up to 32 x 32
constexpr int kSubRows = 32;       // rows per sub-chunk: one row per lane in the row test
constexpr int kStageRows = 1024;   // rows of a segment resident in shared memory (64 KB f32x16)
constexpr int kStageSubs = kStageRows / kSubRows;  // one mbarrier per resident sub-chunk
constexpr int kChunkRows = 128;    // rows per fill when the combine walks a segment again
constexpr int kOutRows = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int segments_smem_bytes(int stage_rows, int row_bytes) {
  return kStageSubs * 8 + stage_rows * row_bytes;  // the mbarriers, then the rows
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine; `bar` completes its phase when they
// have arrived.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Wait until `bar` has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (done == 0u);
}

// Pixel centre of pixel p (row-major) of tile t, exactly as the reference lays
// it out: tile centre plus tile-local offset, all exact in f32 (integers and
// halves).
__device__ __forceinline__ void pixel_centre(int t, int p, int tiles_x, int tile_size,
                                             int height, float& px, float& py) {
  const float tcx = (float)(t % tiles_x) * tile_size + 0.5f * tile_size;
  const float tcy = (float)height - (float)(t / tiles_x) * tile_size - 0.5f * tile_size;
  px = tcx + ((float)(p % tile_size) + 0.5f - 0.5f * tile_size);
  py = tcy + (0.5f * tile_size - (float)(p / tile_size) - 0.5f);
}

// The rows' element type: f32, or bf16 with bf16 accumulation. With bf16 the
// combine rounds the carried (colour, T) to bf16 after every segment it
// applies (carried), as the plain combine does.
template <typename Out>
constexpr bool kBf16Rows = std::is_same<Out, __nv_bfloat16>::value;

template <typename Out>
__device__ __forceinline__ Out to_row(float v) {
  if constexpr (kBf16Rows<Out>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <typename Out>
__device__ __forceinline__ float carried(float v) {
  if constexpr (kBf16Rows<Out>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// What kFwdScanBf16 carries per pixel within a block besides (colour, T): the
// exclusive sum of the rounded logs so far and 1 - w of the block's last row.
// The shipped kernel never reads it.
struct ScanBf16State {
  float lsum = 0.0f;
  float last_om = 1.0f;
};

// Blend rows [0, nrows) (nrows <= 32) of a sub-chunk staged in shared memory
// at `rb` (in the layout kLayout, decoded where they are read) into this
// lane's pixel (colour cr, cg, cb and T tr), front to back. The warp first
// lists the rows that can reach its rectangle of pixel centres
// [xlo, xhi] x [ylo, yhi] (lane r tests row r, decoding its geometry) and
// evaluates only those, each decoded whole and broadcast to every lane. Both
// passes walk rows with it. All 32 lanes must call it. `ends_block` (the
// sub-chunk's last row ends a block) and `sb` serve the ablation variants
// only: with kFwdNoScan and kFwdScanBf16, T is the block's starting T until
// the block ends.
template <int kLayout, int kVariant>
__device__ __forceinline__ void blend_subchunk(const unsigned char* rb, int nrows, float px,
                                               float py, float xlo, float xhi, float ylo,
                                               float yhi, float ln_cutoff, int use_cutoff,
                                               const MeanDecode& md, int lane, float& cr,
                                               float& cg, float& cb, float& tr,
                                               bool ends_block, ScanBf16State& sb) {
  using Row = RowLayout<kLayout>;
  if constexpr (kVariant == kFwdNoWork) return;
  bool maybe = lane < nrows;
  if (maybe && use_cutoff) {
    const RowGeometry g = Row::geometry(rb + lane * Row::kBytes, md);
    maybe = row_may_touch(g.mx, g.my, g.qa, g.qb, g.qc, g.lna, ln_cutoff, xlo, xhi, ylo, yhi);
  }
  unsigned cand = __ballot_sync(kFullMask, maybe);
  // kFwdNoScan: whether the sub-chunk's last row is listed, and the last
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
    if constexpr (kVariant == kFwdNoExp) {
      if (!use_cutoff || qh > ln_cutoff) w = fminf(qh * 0.01f, 0.99f);
    } else {
      if (!use_cutoff || qh > ln_cutoff) w = expf(qh);
    }
    if constexpr (kVariant == kFwdNoScan) {
      const float eff = tr * w;
      cr += eff * colr;
      cg += eff * colg;
      cb += eff * colb;
      w_last = w;
    } else if constexpr (kVariant == kFwdScanBf16) {
      const float t_before = tr * expf(sb.lsum);
      const float eff = t_before * w;
      cr += eff * colr;
      cg += eff * colg;
      cb += eff * colb;
      if (ends_block && r == nrows - 1) {
        sb.last_om = 1.0f - w;
      } else {
        sb.lsum += __bfloat162float(__float2bfloat16_rn(logf(fmaxf(1.0f - w, 1e-37f))));
      }
    } else {
      const float eff = tr * w;
      cr += eff * colr;
      cg += eff * colg;
      cb += eff * colb;
      tr *= 1.0f - w;
    }
  }
  if constexpr (kVariant == kFwdNoScan) {
    if (ends_block && last_listed) tr *= 1.0f - w_last;
  } else if constexpr (kVariant == kFwdScanBf16) {
    if (ends_block) {
      tr = tr * (expf(sb.lsum) * sb.last_om);
      sb = ScanBf16State();
    }
  }
}

// Pass 1: CTA `seg` walks segment number `seg` (segments of kSeg blocks) from
// colour 0 and T = 1 and stores its local (r, g, b, T) into locs[seg].
// Numbers that belong to no segment exit at once. Rows stay packed in shared
// memory.
template <int kLayout, int kVariant, int kSeg>
__global__ void __launch_bounds__(kMaxThreads, 2)
composite_fwd_segments_kernel(const unsigned char* __restrict__ inst,
                              const int* __restrict__ tile_start,
                              const int* __restrict__ tile_nblk,
                              float* __restrict__ locs, int num_tiles, int tiles_x,
                              int tile_size, int height, int block, int stage_rows,
                              float ln_cutoff, int use_cutoff, MeanDecode md) {
  constexpr int kRowBytes = RowLayout<kLayout>::kBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* const bars = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* const rows = smem + kStageSubs * 8;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // segment number -> (tile, first block); the same in every warp
  const int seg = blockIdx.x;
  const int t = warp_upper_bound(
      [&](int i) { return first_segment<kSeg>(__ldg(tile_start + i), i); }, num_tiles, seg,
      lane) - 1;
  const int tile_start_t = tile_start[t];
  const int blk0 = (seg - first_segment<kSeg>(tile_start_t, t)) * kSeg;
  const int nblk = min(kSeg, tile_nblk[t] - blk0);
  if (nblk <= 0) return;  // no such segment: the chain is shorter

  const int nrows_seg = nblk * block;
  const int nsub = (nrows_seg + kSubRows - 1) / kSubRows;
  const int stage_subs = stage_rows / kSubRows;
  const unsigned char* const src = inst + ((size_t)tile_start_t + blk0) * block * kRowBytes;
  // one thread hands the sub-chunks of piece k of the segment to the copy
  // engine, sub-chunk i of the piece completing on bars[i]
  auto issue = [&](int k) {
    const int s0 = k * stage_subs;
    const int n = min(stage_subs, nsub - s0);
    for (int i = 0; i < n; ++i) {
      const int r0 = (s0 + i) * kSubRows;
      bulk_load(rows + i * kSubRows * kRowBytes, src + (size_t)r0 * kRowBytes,
                min(kSubRows, nrows_seg - r0) * kRowBytes, bars + i);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < min(stage_subs, nsub); ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(0);
  }

  const int npix = tile_size * tile_size;
  const int p = patch_pixel(tid, tile_size);
  const bool has_pixel = p < npix;
  float px, py;
  pixel_centre(t, p, tiles_x, tile_size, height, px, py);
  float xlo, xhi, ylo, yhi;
  warp_rect(px, py, has_pixel, xlo, xhi, ylo, yhi);
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, tr = 1.0f;
  ScanBf16State sb;
  __syncthreads();  // the mbarriers are initialised

  for (int k = 0; k * stage_subs < nsub; ++k) {
    if (k > 0) {
      __syncthreads();  // every warp is done with piece k - 1
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(k);
      }
    }
    const int s0 = k * stage_subs;
    const int n = min(stage_subs, nsub - s0);
    for (int i = 0; i < n; ++i) {
      mbar_wait(bars + i, k & 1);
      blend_subchunk<kLayout, kVariant>(
          rows + i * kSubRows * kRowBytes, min(kSubRows, nrows_seg - (s0 + i) * kSubRows), px,
          py, xlo, xhi, ylo, yhi, ln_cutoff, use_cutoff, md, lane, cr, cg, cb, tr,
          (s0 + i + 1) * kSubRows % block == 0, sb);
    }
  }

  if (has_pixel) {
    float* l = locs + (size_t)seg * 4 * npix;
    l[p] = cr;
    l[npix + p] = cg;
    l[2 * npix + p] = cb;
    l[3 * npix + p] = tr;
  }
}

// Pass 2: CTA t scans tile t's locals (segments of kSeg blocks) into its rows
// (and, with store_prefix, the checkpoints in place), deciding the early stop
// (see the head of composite_fwd.cu). Out is the rows' type: float, or
// __nv_bfloat16 with bf16 accumulation.
template <int kLayout, typename Out, int kVariant, int kSeg>
__global__ void __launch_bounds__(kMaxThreads)
composite_fwd_combine_kernel(const unsigned char* __restrict__ inst,
                             const int* __restrict__ tile_start,
                             const int* __restrict__ tile_nblk,
                             float* __restrict__ locs, Out* __restrict__ out,
                             int* __restrict__ tile_walked, int store_prefix, int tiles_x,
                             int tile_size, int height, int block, float ln_cutoff,
                             int use_cutoff, float early_stop_eps, MeanDecode md) {
  constexpr int kRowBytes = RowLayout<kLayout>::kBytes;
  __shared__ __align__(16) unsigned char rows[kChunkRows * kRowBytes];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int npix = tile_size * tile_size;
  const int p = patch_pixel(tid, tile_size);
  const bool has_pixel = p < npix;
  const int nblk = tile_nblk[t];
  const int nseg = (nblk + kSeg - 1) / kSeg;
  const int tile_start_t = tile_start[t];
  const bool vote = early_stop_eps > 0.0f;

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, tr = 1.0f;  // the state before segment j
  float pr = 0.0f, pg = 0.0f, pb = 0.0f, pt = 1.0f;  // the state before the last one applied
  int stop_seg = 0;  // j*: the first boundary with T < eps at every pixel (0: none)
  // The locals are loaded one segment ahead, and a checkpoint is stored only
  // once its segment's local has been used: stores over locals still being
  // loaded held up the loads behind them (on an H100 at the garden shape the
  // combine took 0.32 ms with checkpoints against 0.06 without; 0.07 so).
  float* loc = locs + (size_t)first_segment<kSeg>(tile_start_t, t) * 4 * npix;
  float nr = 0.0f, ng = 0.0f, nb = 0.0f, nt = 1.0f;  // the next segment's local
  if (has_pixel && nseg > 0) {
    nr = loc[p], ng = loc[npix + p], nb = loc[2 * npix + p], nt = loc[3 * npix + p];
  }
  for (int j = 0; j < nseg; ++j, loc += 4 * npix) {
    const float lr = nr, lg = ng, lb = nb, lt = nt;
    if (has_pixel && j + 1 < nseg) {
      const float* next = loc + 4 * npix;
      nr = next[p], ng = next[npix + p], nb = next[2 * npix + p], nt = next[3 * npix + p];
    }
    pr = cr, pg = cg, pb = cb, pt = tr;
    cr = carried<Out>(__fadd_rn(cr, __fmul_rn(tr, lr)));
    cg = carried<Out>(__fadd_rn(cg, __fmul_rn(tr, lg)));
    cb = carried<Out>(__fadd_rn(cb, __fmul_rn(tr, lb)));
    tr = carried<Out>(__fmul_rn(tr, lt));
    if (has_pixel && store_prefix) {  // the state before segment j, over its local
      loc[p] = pr;
      loc[npix + p] = pg;
      loc[2 * npix + p] = pb;
      loc[3 * npix + p] = pt;
    }
    if (vote && !__syncthreads_or(has_pixel && tr >= early_stop_eps)) {
      stop_seg = j + 1;
      break;
    }
  }

  int walked = nblk;
  if (stop_seg > 0) {
    // walk segment j* - 1 again from its prefix with the serial per-block
    // vote (not at its first block: boundary j* - 1 passed the vote)
    const int b0 = (stop_seg - 1) * kSeg;
    const int b1 = min(b0 + kSeg, nblk);
    float px, py;
    pixel_centre(t, p, tiles_x, tile_size, height, px, py);
    float xlo, xhi, ylo, yhi;
    warp_rect(px, py, has_pixel, xlo, xhi, ylo, yhi);
    ScanBf16State sb;
    walked = b1;
    for (int blk = b0; blk < b1; ++blk) {
      if (blk > b0 && !__syncthreads_or(has_pixel && pt >= early_stop_eps)) {
        walked = blk;
        break;
      }
      for (int c0 = 0; c0 < block; c0 += kChunkRows) {
        const int nrows = min(kChunkRows, block - c0);
        const int4* src = reinterpret_cast<const int4*>(
            inst + (((size_t)tile_start_t + blk) * block + c0) * kRowBytes);
        __syncthreads();  // the previous chunk fully consumed
        for (int i = tid; i < nrows * kRowBytes / 16; i += blockDim.x) {
          reinterpret_cast<int4*>(rows)[i] = src[i];
        }
        __syncthreads();
        for (int r0 = 0; r0 < nrows; r0 += kSubRows) {
          blend_subchunk<kLayout, kVariant>(
              rows + r0 * kRowBytes, min(kSubRows, nrows - r0), px, py, xlo, xhi, ylo, yhi,
              ln_cutoff, use_cutoff, md, lane, pr, pg, pb, pt, c0 + r0 + kSubRows == block, sb);
        }
      }
    }
    if (walked < b1) {  // the vote ended the walk inside the segment: the state there
      cr = pr, cg = pg, cb = pb, tr = pt;
    }
  }

  if (tile_walked != nullptr && tid == 0) tile_walked[t] = walked;
  if (has_pixel) {
    Out* o = out + (size_t)t * kOutRows * npix;
    o[p] = to_row<Out>(cr);
    o[npix + p] = to_row<Out>(cg);
    o[2 * npix + p] = to_row<Out>(cb);
    o[3 * npix + p] = to_row<Out>(1.0f - tr);
    o[4 * npix + p] = to_row<Out>(tr);
    o[5 * npix + p] = to_row<Out>(0.0f);
    o[6 * npix + p] = to_row<Out>(0.0f);
    o[7 * npix + p] = to_row<Out>(0.0f);
  }
}

template <int kLayout, int kVariant = kFwdFull, int kSeg = kSegBlocks>
int launch_segments(const void* inst, const void* tile_start, const void* tile_nblk,
                    void* locs, int num_segments, int num_tiles, int tiles_x, int tile_size,
                    int height, int block, float ln_cutoff, int use_cutoff, MeanDecode md,
                    cudaStream_t stream) {
  constexpr int kRowBytes = RowLayout<kLayout>::kBytes;
  const int npix = tile_size * tile_size;
  const int threads = (npix + 31) / 32 * 32;
  const int seg_rows = (kSeg * block + kSubRows - 1) / kSubRows * kSubRows;
  const int stage_rows = seg_rows < kStageRows ? seg_rows : kStageRows;
  // above 48 KB shared memory is granted only on request: asked once per
  // device and instantiation, not per launch
  static int granted_device = -1;
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != granted_device) {
    err = cudaFuncSetAttribute(composite_fwd_segments_kernel<kLayout, kVariant, kSeg>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               segments_smem_bytes(kStageRows, kRowBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_device = device;
  }
  composite_fwd_segments_kernel<kLayout, kVariant, kSeg>
      <<<num_segments, threads, segments_smem_bytes(stage_rows, kRowBytes), stream>>>(
          static_cast<const unsigned char*>(inst), static_cast<const int*>(tile_start),
          static_cast<const int*>(tile_nblk), static_cast<float*>(locs), num_tiles, tiles_x,
          tile_size, height, block, stage_rows, ln_cutoff, use_cutoff, md);
  return static_cast<int>(cudaGetLastError());
}

template <int kLayout, typename Out, int kVariant = kFwdFull, int kSeg = kSegBlocks>
int launch_combine(const void* inst, const void* tile_start, const void* tile_nblk, void* locs,
                   void* out, void* tile_walked, int store_prefix, int num_tiles, int tiles_x,
                   int tile_size, int height, int block, float ln_cutoff, int use_cutoff,
                   float early_stop_eps, MeanDecode md, cudaStream_t stream) {
  const int threads = (tile_size * tile_size + 31) / 32 * 32;
  composite_fwd_combine_kernel<kLayout, Out, kVariant, kSeg><<<num_tiles, threads, 0, stream>>>(
      static_cast<const unsigned char*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_nblk), static_cast<float*>(locs), static_cast<Out*>(out),
      static_cast<int*>(tile_walked), store_prefix, tiles_x, tile_size, height, block,
      ln_cutoff, use_cutoff, early_stop_eps, md);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
