// composite_fwd: per-tile front-to-back alpha compositing, for sm_90a, in two
// launches: a segment pass and a per-tile combine.
//
// Replaces the TPU kernel splatapult_tpu/ops/composite.py::_fwd_kernel
// (launched by _fwd_call; helpers _unpack_feats, _block_weights,
// _excl_cumprod_rows, _pixel_coords).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "row_cull.cuh"
#include "row_layout.cuh"
#include "segments.cuh"
#include "warp_search.cuh"

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

// Blend rows [0, nrows) (nrows <= 32) of a sub-chunk staged in shared memory
// at `rb` (in the layout kLayout, decoded where they are read) into this
// lane's pixel (colour cr, cg, cb and T tr), front to back. The warp first
// lists the rows that can reach its rectangle of pixel centres
// [xlo, xhi] x [ylo, yhi] (lane r tests row r, decoding its geometry) and
// evaluates only those, each decoded whole and broadcast to every lane. Both
// passes walk rows with it. All 32 lanes must call it.
template <int kLayout>
__device__ __forceinline__ void blend_subchunk(const unsigned char* rb, int nrows, float px,
                                               float py, float xlo, float xhi, float ylo,
                                               float yhi, float ln_cutoff, int use_cutoff,
                                               const MeanDecode& md, int lane, float& cr,
                                               float& cg, float& cb, float& tr) {
  using Row = RowLayout<kLayout>;
  bool maybe = lane < nrows;
  if (maybe && use_cutoff) {
    const RowGeometry g = Row::geometry(rb + lane * Row::kBytes, md);
    maybe = row_may_touch(g.mx, g.my, g.qa, g.qb, g.qc, g.lna, ln_cutoff, xlo, xhi, ylo, yhi);
  }
  unsigned cand = __ballot_sync(kFullMask, maybe);
  while (cand != 0u) {
    const int r = __ffs(cand) - 1;
    cand &= cand - 1u;
    float colr, colg, colb;
    const RowGeometry g = Row::decode(rb + r * Row::kBytes, md, colr, colg, colb);
    const float dx = px - g.mx;
    const float dy = py - g.my;
    const float qh = g.qa * dx * dx + g.qb * dx * dy + g.qc * dy * dy + g.lna;
    float w = 0.0f;
    if (!use_cutoff || qh > ln_cutoff) w = expf(qh);
    const float eff = tr * w;
    cr += eff * colr;
    cg += eff * colg;
    cb += eff * colb;
    tr *= 1.0f - w;
  }
}

// Pass 1: CTA `seg` walks segment number `seg` from colour 0 and T = 1 and
// stores its local (r, g, b, T) into locs[seg]. Numbers that belong to no
// segment exit at once. Rows stay packed in shared memory.
template <int kLayout>
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
      [&](int i) { return first_segment(__ldg(tile_start + i), i); }, num_tiles, seg, lane) - 1;
  const int tile_start_t = tile_start[t];
  const int blk0 = (seg - first_segment(tile_start_t, t)) * kSegBlocks;
  const int nblk = min(kSegBlocks, tile_nblk[t] - blk0);
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
      blend_subchunk<kLayout>(rows + i * kSubRows * kRowBytes,
                              min(kSubRows, nrows_seg - (s0 + i) * kSubRows), px, py, xlo, xhi,
                              ylo, yhi, ln_cutoff, use_cutoff, md, lane, cr, cg, cb, tr);
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
// file). Out is the rows' type: float, or __nv_bfloat16 with bf16
// accumulation.
template <int kLayout, typename Out>
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
        const int4* src = reinterpret_cast<const int4*>(
            inst + (((size_t)tile_start_t + blk) * block + c0) * kRowBytes);
        __syncthreads();  // the previous chunk fully consumed
        for (int i = tid; i < nrows * kRowBytes / 16; i += blockDim.x) {
          reinterpret_cast<int4*>(rows)[i] = src[i];
        }
        __syncthreads();
        for (int r0 = 0; r0 < nrows; r0 += kSubRows) {
          blend_subchunk<kLayout>(rows + r0 * kRowBytes, min(kSubRows, nrows - r0), px, py,
                                  xlo, xhi, ylo, yhi, ln_cutoff, use_cutoff, md, lane, pr, pg,
                                  pb, pt);
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

template <int kLayout>
int launch_segments(const void* inst, const void* tile_start, const void* tile_nblk,
                    void* locs, int num_segments, int num_tiles, int tiles_x, int tile_size,
                    int height, int block, float ln_cutoff, int use_cutoff, MeanDecode md,
                    cudaStream_t stream) {
  constexpr int kRowBytes = RowLayout<kLayout>::kBytes;
  const int npix = tile_size * tile_size;
  const int threads = (npix + 31) / 32 * 32;
  const int seg_rows = (kSegBlocks * block + kSubRows - 1) / kSubRows * kSubRows;
  const int stage_rows = seg_rows < kStageRows ? seg_rows : kStageRows;
  // above 48 KB shared memory is granted only on request: asked once per
  // device and layout, not per launch
  static int granted_device = -1;
  int device = -1;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != granted_device) {
    err = cudaFuncSetAttribute(composite_fwd_segments_kernel<kLayout>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               segments_smem_bytes(kStageRows, kRowBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_device = device;
  }
  composite_fwd_segments_kernel<kLayout>
      <<<num_segments, threads, segments_smem_bytes(stage_rows, kRowBytes), stream>>>(
          static_cast<const unsigned char*>(inst), static_cast<const int*>(tile_start),
          static_cast<const int*>(tile_nblk), static_cast<float*>(locs), num_tiles, tiles_x,
          tile_size, height, block, stage_rows, ln_cutoff, use_cutoff, md);
  return static_cast<int>(cudaGetLastError());
}

template <int kLayout, typename Out>
int launch_combine(const void* inst, const void* tile_start, const void* tile_nblk, void* locs,
                   void* out, void* tile_walked, int store_prefix, int num_tiles, int tiles_x,
                   int tile_size, int height, int block, float ln_cutoff, int use_cutoff,
                   float early_stop_eps, MeanDecode md, cudaStream_t stream) {
  const int threads = (tile_size * tile_size + 31) / 32 * 32;
  composite_fwd_combine_kernel<kLayout, Out><<<num_tiles, threads, 0, stream>>>(
      static_cast<const unsigned char*>(inst), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_nblk), static_cast<float*>(locs), static_cast<Out*>(out),
      static_cast<int*>(tile_walked), store_prefix, tiles_x, tile_size, height, block,
      ln_cutoff, use_cutoff, early_stop_eps, md);
  return static_cast<int>(cudaGetLastError());
}

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
