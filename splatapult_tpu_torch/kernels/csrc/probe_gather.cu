// probe_gather: the dynamic-gather probes, for sm_90a: the kernels of
// splatapult_tpu_torch/tools/probe_dyngather.py.
//
// Replaces the TPU kernels of tools/test_dyngather.py, which ask whether
// Mosaic lowers take_along_axis inside a kernel (int32 tables):
//   G1  :30  kernel_lane  out[i, j] = x[i, idx[i, j]]   (axis 1, cross-lane)
//   G2  :48  kernel_sub   out[i, j] = x[idx[i, j], j]   (axis 0, cross-sublane)
// The output has idx's shape: G1 x [R, L], idx [R, M]; G2 x [R, L], idx [M, L].
//
// Contract: every index lies in [0, L) for G1, [0, R) for G2. The wrappers
// (tools/probe_dyngather.py) check it on the device before they launch; the
// kernels trust it.
//
// Bound on an H100: bytes. Each kernel must read x and idx once and write
// the output once; it does no arithmetic but the addresses. At the JAX tool's
// shapes (20 KB and 1.3 MB tables) the launch and two dependent L2 round
// trips are the floor instead.
//
// G1 has two routes; the wrapper picks one from the shape
// (probe_dyngather.pick_route). G2 has one, staged.
//   direct  (G1) A thread reads 4 consecutive indices (one 16-byte load
//           where aligned), gathers their 4 values straight from x's row
//           (L2, and L1 for a row's neighbours, hold a small table) and
//           stores 4 outputs. One thread per 4 outputs, so the grid fills
//           the card at any shape, and no barrier. Also takes the rows too
//           wide to stage.
//   staged  Each CTA copies the part of x its outputs can reach into shared
//           memory with 16-byte cp.async (no register round trip, the whole
//           stage in flight at once) and loads its first indices into
//           registers while the copy lands; then gathers from shared memory.
//           Every global access is coalesced.
//     G1: a CTA owns consecutive rows of x and of idx; their x rows (at
//         most 32 KiB, at least one row, fewer where the grid would not
//         reach 4 CTAs an SM) are one contiguous range. idx and out are read
//         and written 16 bytes a thread, 4 vectors in flight each. The
//         gather reads shared memory at random columns (bank conflicts, not
//         DRAM traffic).
//     G2: a CTA owns a strip of 32 columns: x[:, c0:c0+32], R x 128 bytes
//         (640 x 32 int32 = 80 KiB for the tool's table; R up to 1816 rows
//         fits the SM's 227 KB), 8 cp.async parts a row; where the strips
//         are fewer than the CTAs the card holds at once, several CTAs share
//         a strip and split idx's rows. In the gather lane k reads column k
//         of the strip at its own row (bank k, no conflicts); each warp holds
//         16 rows of indices in registers at a time, so 16 KiB of idx a CTA
//         stay in flight.
// Where a base address or a width breaks the 16-byte alignment, the same
// kernels take 4-byte loads and stores (the template's kVec = false).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDirectThreads = 128;
constexpr int kLaneStageInts = 8192;  // G1: x ints a CTA stages, 32 KiB (at least one row)
constexpr int kLaneBatch = 4;         // G1: idx vectors a thread holds at once
constexpr int kSubCols = 32;          // G2: the strip's columns, one per lane
constexpr int kSubDepth = 16;         // G2: idx rows a warp holds at once
constexpr int kMaxSharedBytes = 232448;

enum Route { kDirect = 0, kStaged = 1 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One row's values at 1 or 4 column indices.
__device__ __forceinline__ int take(const int* row, int v) { return row[v]; }
__device__ __forceinline__ int4 take(const int* row, int4 v) {
  return make_int4(row[v.x], row[v.y], row[v.z], row[v.w]);
}

// G1, direct: idx and out [rows, m], x [rows, l]; a thread's outputs p0 ..
// p0 + 3 of the flat idx, element p at row p / m. kVec: m % 4 == 0 and idx,
// out 16-byte aligned, so the 4 lie in one row.
template <bool kVec>
__global__ void __launch_bounds__(kDirectThreads)
gather_lane_direct_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                          int* __restrict__ out, int64_t n, int l, int m) {
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kDirectThreads + threadIdx.x) * 4;
  if (p0 >= n) return;
  if (kVec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + p0));
    *reinterpret_cast<int4*>(out + p0) = take(x + (p0 / m) * l, v);
  } else {
    const int e_end = n - p0 < 4 ? static_cast<int>(n - p0) : 4;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < e_end ? __ldg(idx + p0 + e) : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < e_end) out[p0 + e] = __ldg(x + ((p0 + e) / m) * l + v[e]);
    }
  }
}

// G1, staged. kVec: x, idx and out 16-byte aligned, l % 4 == 0 and m % 4 == 0.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_lane_staged_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                          int* __restrict__ out, int rows, int l, int m, int rows_per_cta) {
  using V = typename std::conditional<kVec, int4, int>::type;
  constexpr int kWidth = kVec ? 4 : 1;
  extern __shared__ int4 s_x4[];
  int* s_x = reinterpret_cast<int*>(s_x4);
  const int r0 = blockIdx.x * rows_per_cta;
  const int nr = min(rows_per_cta, rows - r0);
  const int* src = x + static_cast<size_t>(r0) * l;
  const int n = nr * l;
  if (kVec) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int k = threadIdx.x; k < n / 4; k += kThreads) cp_async16(s_x4 + k, src4 + k);
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) s_x[k] = __ldg(src + k);
  }
  // idx and out of these rows: one contiguous range of nr * m ints, kLaneBatch
  // vectors a thread at a time; the first batch is in flight with the copy
  const size_t base = static_cast<size_t>(r0) * m;
  const V* idx_v = reinterpret_cast<const V*>(idx + base);
  V* out_v = reinterpret_cast<V*>(out + base);
  const int nv = nr * m / kWidth;
  V v[kLaneBatch];
#pragma unroll
  for (int t = 0; t < kLaneBatch; ++t) {
    const int k = threadIdx.x + t * kThreads;
    if (k < nv) v[t] = __ldg(idx_v + k);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int k0 = 0; k0 < nv; k0 += kLaneBatch * kThreads) {
    if (k0 > 0) {
#pragma unroll
      for (int t = 0; t < kLaneBatch; ++t) {
        const int k = k0 + threadIdx.x + t * kThreads;
        if (k < nv) v[t] = __ldg(idx_v + k);
      }
    }
#pragma unroll
    for (int t = 0; t < kLaneBatch; ++t) {
      const int k = k0 + threadIdx.x + t * kThreads;
      if (k < nv) out_v[k] = take(s_x + (k * kWidth / m) * l, v[t]);
    }
  }
}

// G2, staged. kVec: x 16-byte aligned and l % 4 == 0, so each 16-byte part
// of a strip row lies wholly inside x's row or wholly past its last column.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_sub_staged_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                         int* __restrict__ out, int r, int l, int m, int rows_per_split) {
  static_assert(kSubCols == 32, "a lane a column");
  extern __shared__ int4 s_strip4[];  // [r][kSubCols]
  int* s_strip = reinterpret_cast<int*>(s_strip4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kSubCols;
  const int col = c0 + lane;
  const bool live = col < l;
  if (kVec) {
    for (int q = threadIdx.x; q < r * (kSubCols / 4); q += kThreads) {
      const int c = c0 + (q & 7) * 4;
      if (c < l) cp_async16(s_strip4 + q, x + static_cast<size_t>(q >> 3) * l + c);
    }
  } else {
    for (int i = warp; i < r; i += kWarps) {
      s_strip[i * kSubCols + lane] = live ? __ldg(x + static_cast<size_t>(i) * l + col) : 0;
    }
  }
  // this CTA's rows of idx: [i_begin, i_end) (blockIdx.y splits them where
  // the strips alone would not fill the card); a warp's rows i0, i0 + kWarps,
  // ... at this lane's column, the first batch in flight with the copy
  const int i_begin = blockIdx.y * rows_per_split;
  const int i_end = min(m, i_begin + rows_per_split);
  int v[kSubDepth];
  int i0 = i_begin + warp;
#pragma unroll
  for (int d = 0; d < kSubDepth; ++d) {
    const int i = i0 + d * kWarps;
    v[d] = live && i < i_end ? __ldg(idx + static_cast<size_t>(i) * l + col) : 0;
  }
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
  for (; i0 < i_end; i0 += kSubDepth * kWarps) {
    if (i0 != i_begin + warp) {
#pragma unroll
      for (int d = 0; d < kSubDepth; ++d) {
        const int i = i0 + d * kWarps;
        v[d] = i < i_end ? __ldg(idx + static_cast<size_t>(i) * l + col) : 0;
      }
    }
#pragma unroll
    for (int d = 0; d < kSubDepth; ++d) {
      const int i = i0 + d * kWarps;
      if (i < i_end) out[static_cast<size_t>(i) * l + col] = s_strip[v[d] * kSubCols + lane];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The current device's SMs: the staged routes size their grids to them, so a
// small table's few rows or strips still spread over the card.
int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Dynamic shared memory above the default 48 KB needs the kernel's attribute.
template <typename Kernel>
int allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int launch_lane_direct(const int* x, const int* idx, int* out, int rows, int l, int m,
                       cudaStream_t stream) {
  const int64_t n = int64_t{rows} * m, per_cta = 4 * kDirectThreads;
  const unsigned blocks = static_cast<unsigned>((n + per_cta - 1) / per_cta);
  auto kernel = gather_lane_direct_kernel<false>;
  if (m % 4 == 0 && aligned16(idx) && aligned16(out)) kernel = gather_lane_direct_kernel<true>;
  kernel<<<blocks, kDirectThreads, 0, stream>>>(x, idx, out, n, l, m);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_lane_staged(const int* x, const int* idx, int* out, int rows, int l, int m,
                       cudaStream_t stream) {
  // at most kLaneStageInts of x a CTA, and few enough rows that the grid
  // reaches 4 CTAs an SM
  const int rows_per_cta =
      std::max(1, std::min(kLaneStageInts / l, ceil_div(rows, 4 * sm_count())));
  const int smem = rows_per_cta * l * 4;
  if (int code = allow_shared(gather_lane_staged_kernel<kVec>, smem)) return code;
  const int blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  gather_lane_staged_kernel<kVec><<<blocks, kThreads, smem, stream>>>(x, idx, out, rows, l, m,
                                                                      rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_sub_staged(const int* x, const int* idx, int* out, int r, int l, int m,
                      cudaStream_t stream) {
  const int smem = r * kSubCols * 4;
  if (int code = allow_shared(gather_sub_staged_kernel<kVec>, smem)) return code;
  // a CTA a strip; where the strips are fewer than the CTAs the card holds
  // at once (2 an SM at 80 KiB), idx's rows split among several CTAs a strip
  // (each stages the whole strip: the copies after the first read L2), each
  // split at least one batch of rows
  int resident = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, gather_sub_staged_kernel<kVec>,
                                                kThreads, smem);
  const int strips = ceil_div(l, kSubCols);
  const int splits = std::max(1, std::min(std::max(1, resident) * sm_count() / strips,
                                          ceil_div(m, kSubDepth * kWarps)));
  const int rows_per_split = ceil_div(m, splits);
  const dim3 grid(strips, ceil_div(m, rows_per_split));
  gather_sub_staged_kernel<kVec><<<grid, kThreads, smem, stream>>>(x, idx, out, r, l, m,
                                                                   rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G1. x [rows, l], idx and out [rows, m], int32, contiguous; idx in [0, l).
// route 0 direct, 1 staged (l at most kMaxSharedBytes / 4 = 58112).
extern "C" int splat_probe_gather_lane(const void* x_, const void* idx_, void* out_, int rows,
                                       int l, int m, int route, void* stream_) {
  if (rows < 0 || l <= 0 || m < 0 || (route != kDirect && route != kStaged) ||
      (route == kStaged && l > kMaxSharedBytes / 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || m == 0) return 0;
  const int* x = static_cast<const int*>(x_);
  const int* idx = static_cast<const int*>(idx_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (route == kDirect) return launch_lane_direct(x, idx, out, rows, l, m, stream);
  if (l % 4 == 0 && m % 4 == 0 && aligned16(x) && aligned16(idx) && aligned16(out)) {
    return launch_lane_staged<true>(x, idx, out, rows, l, m, stream);
  }
  return launch_lane_staged<false>(x, idx, out, rows, l, m, stream);
}

// G2. x [r, l], idx and out [m, l], int32, contiguous; idx in [0, r); r at
// most kMaxSharedBytes / 128 = 1816.
extern "C" int splat_probe_gather_sub(const void* x_, const void* idx_, void* out_, int r, int l,
                                      int m, void* stream_) {
  if (r <= 0 || l < 0 || m < 0 || r > kMaxSharedBytes / (kSubCols * 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (l == 0 || m == 0) return 0;
  const int* x = static_cast<const int*>(x_);
  const int* idx = static_cast<const int*>(idx_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (l % 4 == 0 && aligned16(x)) return launch_sub_staged<true>(x, idx, out, r, l, m, stream);
  return launch_sub_staged<false>(x, idx, out, r, l, m, stream);
}
