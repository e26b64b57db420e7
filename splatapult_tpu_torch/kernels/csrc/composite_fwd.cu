// composite_fwd: per-tile front-to-back alpha compositing, for sm_90a, in two
// launches: a segment pass and a per-tile combine.
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
//   - a segment's rows go to shared memory by the copy engine: one thread
//     issues one bulk copy (cp.async.bulk, 2 KB) per sub-chunk of 32 rows,
//     each completing on its own mbarrier, all at the CTA's start. 8 x 128
//     rows are 64 KB, resident whole (two CTAs an SM), so each warp waits
//     only for the sub-chunk it is about to walk and no CTA-wide barrier
//     falls in the loop; a segment of more than kStageRows rows (blocks of
//     256 rows and more) is staged in pieces, with one CTA barrier between
//     pieces;
//   - per sub-chunk, per warp, the row list of the backward (row_cull.cuh):
//     lane r tests row r against the warp's rectangle of pixel centres, a
//     ballot is the list, and the warp evaluates only the listed rows. A row
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
// kernel does more than that. Bytes: 64 B per slot + 32 B per pixel, about
// 0.22 GB, 0.07 ms at 3.35 TB/s; the locals are the design's traffic, not
// the function's.

#include <cuda_runtime.h>

#include "row_cull.cuh"
#include "segments.cuh"
#include "warp_search.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // one pixel per thread: tiles up to 32 x 32
constexpr int kNumFeats = 16;      // floats per feature row (64 B)
constexpr int kRowBytes = kNumFeats * 4;
constexpr int kSubRows = 32;       // rows per sub-chunk: one row per lane in the row test
constexpr int kStageRows = 1024;   // rows of a segment resident in shared memory (64 KB)
constexpr int kStageSubs = kStageRows / kSubRows;  // one mbarrier per resident sub-chunk
constexpr int kChunkRows = 128;    // rows per fill when the combine walks a segment again
constexpr int kOutRows = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int segments_smem_bytes(int stage_rows) {
  return kStageSubs * 8 + stage_rows * kRowBytes;  // the mbarriers, then the rows
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
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
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

// Blend rows [0, nrows) (nrows <= 32) of a sub-chunk staged in shared memory
// at `rb` into this lane's pixel (colour cr, cg, cb and T tr), front to back.
// The warp first lists the rows that can reach its rectangle of pixel centres
// [xlo, xhi] x [ylo, yhi] (lane r tests row r) and evaluates only those. Both
// passes walk rows with it. All 32 lanes must call it.
__device__ __forceinline__ void blend_subchunk(const float* rb, int nrows, float px, float py,
                                               float xlo, float xhi, float ylo, float yhi,
                                               float ln_cutoff, int use_cutoff, int lane,
                                               float& cr, float& cg, float& cb, float& tr) {
  bool maybe = lane < nrows;
  if (maybe && use_cutoff) {
    const float* f = rb + lane * kNumFeats;
    const float4 g0 = *reinterpret_cast<const float4*>(f);      // mx my qa qb
    const float2 g1 = *reinterpret_cast<const float2*>(f + 4);  // qc lna
    maybe = row_may_touch(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, ln_cutoff, xlo, xhi, ylo, yhi);
  }
  unsigned cand = __ballot_sync(kFullMask, maybe);
  while (cand != 0u) {
    const int r = __ffs(cand) - 1;
    cand &= cand - 1u;
    const float* f = rb + r * kNumFeats;
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

// Pass 1: CTA `seg` walks segment number `seg` from colour 0 and T = 1 and
// stores its local (r, g, b, T) into locs[seg]. Numbers that belong to no
// segment exit at once.
__global__ void __launch_bounds__(kMaxThreads, 2)
composite_fwd_segments_kernel(const float* __restrict__ inst,
                              const int* __restrict__ tile_start,
                              const int* __restrict__ tile_nblk,
                              float* __restrict__ locs, int num_tiles, int tiles_x,
                              int tile_size, int height, int block, int stage_rows,
                              float ln_cutoff, int use_cutoff) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* const bars = reinterpret_cast<unsigned long long*>(smem);
  float* const rows = reinterpret_cast<float*>(smem + kStageSubs * 8);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // segment number -> (tile, first block); the same in every warp
  const int seg = blockIdx.x;
  const int t = warp_upper_bound(
      [&](int i) { return first_segment(__ldg(tile_start + i), i); }, num_tiles, seg, lane) - 1;
  const int tile_start_t = tile_start[t];
  const int blk0 = (seg - first_segment(tile_start_t, t)) * kSegBlocks;
  const int nblk = min(kSegBlocks, tile_nblk[t] - blk0);
  if (nblk <= 0) return;  // no such segment: the chain is shorter

  const int nrows_seg = nblk * block;
  const int nsub = (nrows_seg + kSubRows - 1) / kSubRows;
  const int stage_subs = stage_rows / kSubRows;
  const float* const src = inst + ((size_t)tile_start_t + blk0) * block * kNumFeats;
  // one thread hands the sub-chunks of piece k of the segment to the copy
  // engine, sub-chunk i of the piece completing on bars[i]
  auto issue = [&](int k) {
    const int s0 = k * stage_subs;
    const int n = min(stage_subs, nsub - s0);
    for (int i = 0; i < n; ++i) {
      const int r0 = (s0 + i) * kSubRows;
      bulk_load(rows + i * kSubRows * kNumFeats, src + (size_t)r0 * kNumFeats,
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
      blend_subchunk(rows + i * kSubRows * kNumFeats,
                     min(kSubRows, nrows_seg - (s0 + i) * kSubRows), px, py, xlo, xhi, ylo,
                     yhi, ln_cutoff, use_cutoff, lane, cr, cg, cb, tr);
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

// Pass 2: CTA t scans tile t's locals into its rows (and, with store_prefix,
// the checkpoints in place), deciding the early stop (see the head of this
// file).
__global__ void __launch_bounds__(kMaxThreads)
composite_fwd_combine_kernel(const float* __restrict__ inst,
                             const int* __restrict__ tile_start,
                             const int* __restrict__ tile_nblk,
                             float* __restrict__ locs, float* __restrict__ out,
                             int* __restrict__ tile_walked, int store_prefix, int tiles_x,
                             int tile_size, int height, int block, float ln_cutoff,
                             int use_cutoff, float early_stop_eps) {
  __shared__ __align__(16) float rows[kChunkRows * kNumFeats];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int npix = tile_size * tile_size;
  const int p = patch_pixel(tid, tile_size);
  const bool has_pixel = p < npix;
  const int nblk = tile_nblk[t];
  const int nseg = (nblk + kSegBlocks - 1) / kSegBlocks;
  const int tile_start_t = tile_start[t];
  const bool vote = early_stop_eps > 0.0f;

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, tr = 1.0f;  // the state before segment j
  float pr = 0.0f, pg = 0.0f, pb = 0.0f, pt = 1.0f;  // the state before the last one applied
  int stop_seg = 0;  // j*: the first boundary with T < eps at every pixel (0: none)
  // The locals are loaded one segment ahead, and a checkpoint is stored only
  // once its segment's local has been used: stores over locals still being
  // loaded held up the loads behind them (on an H100 at the garden shape the
  // combine took 0.32 ms with checkpoints against 0.06 without; 0.07 so).
  float* loc = locs + (size_t)first_segment(tile_start_t, t) * 4 * npix;
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
    cr = __fadd_rn(cr, __fmul_rn(tr, lr));
    cg = __fadd_rn(cg, __fmul_rn(tr, lg));
    cb = __fadd_rn(cb, __fmul_rn(tr, lb));
    tr = __fmul_rn(tr, lt);
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
    const int b0 = (stop_seg - 1) * kSegBlocks;
    const int b1 = min(b0 + kSegBlocks, nblk);
    float px, py;
    pixel_centre(t, p, tiles_x, tile_size, height, px, py);
    float xlo, xhi, ylo, yhi;
    warp_rect(px, py, has_pixel, xlo, xhi, ylo, yhi);
    walked = b1;
    for (int blk = b0; blk < b1; ++blk) {
      if (blk > b0 && !__syncthreads_or(has_pixel && pt >= early_stop_eps)) {
        walked = blk;
        break;
      }
      for (int c0 = 0; c0 < block; c0 += kChunkRows) {
        const int nrows = min(kChunkRows, block - c0);
        const float* src = inst + (((size_t)tile_start_t + blk) * block + c0) * kNumFeats;
        __syncthreads();  // the previous chunk fully consumed
        for (int i = tid * 4; i < nrows * kNumFeats; i += blockDim.x * 4) {
          *reinterpret_cast<float4*>(rows + i) = *reinterpret_cast<const float4*>(src + i);
        }
        __syncthreads();
        for (int r0 = 0; r0 < nrows; r0 += kSubRows) {
          blend_subchunk(rows + r0 * kNumFeats, min(kSubRows, nrows - r0), px, py, xlo, xhi,
                         ylo, yhi, ln_cutoff, use_cutoff, lane, pr, pg, pb, pt);
        }
      }
    }
    if (walked < b1) {  // the vote ended the walk inside the segment: the state there
      cr = pr, cg = pg, cb = pb, tr = pt;
    }
  }

  if (tile_walked != nullptr && tid == 0) tile_walked[t] = walked;
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

extern "C" int splat_composite_fwd_segments(const void* inst, const void* tile_start,
                                            const void* tile_nblk, void* locs,
                                            int num_segments, int seg_blocks, int num_tiles,
                                            int tiles_x, int tile_size, int height, int block,
                                            float ln_cutoff, int use_cutoff, void* stream) {
  if (num_tiles <= 0 || num_segments <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || seg_blocks != kSegBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (npix + 31) / 32 * 32;
  const int seg_rows = (kSegBlocks * block + kSubRows - 1) / kSubRows * kSubRows;
  const int stage_rows = seg_rows < kStageRows ? seg_rows : kStageRows;
  // above 48 KB shared memory is granted only on request: asked once per
  // device, not per launch
  static int granted_device = -1;
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != granted_device) {
    err = cudaFuncSetAttribute(composite_fwd_segments_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               segments_smem_bytes(kStageRows));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_device = device;
  }
  composite_fwd_segments_kernel<<<num_segments, threads, segments_smem_bytes(stage_rows),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_nblk), static_cast<float*>(locs), num_tiles, tiles_x,
      tile_size, height, block, stage_rows, ln_cutoff, use_cutoff);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int splat_composite_fwd_combine(const void* inst, const void* tile_start,
                                           const void* tile_nblk, void* locs, void* out,
                                           void* tile_walked, int store_prefix,
                                           int seg_blocks, int num_tiles, int tiles_x,
                                           int tile_size, int height, int block,
                                           float ln_cutoff, int use_cutoff,
                                           float early_stop_eps, void* stream) {
  if (num_tiles <= 0) return 0;
  const int npix = tile_size * tile_size;
  if (npix > kMaxThreads || block <= 0 || seg_blocks != kSegBlocks ||
      (store_prefix && tile_walked == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (npix + 31) / 32 * 32;
  composite_fwd_combine_kernel<<<num_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_nblk), static_cast<float*>(locs), static_cast<float*>(out),
      static_cast<int*>(tile_walked), store_prefix, tiles_x, tile_size, height, block,
      ln_cutoff, use_cutoff, early_stop_eps);
  return static_cast<int>(cudaGetLastError());
}
