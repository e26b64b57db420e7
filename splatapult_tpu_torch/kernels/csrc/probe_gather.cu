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
// the output once; it does no arithmetic but the addresses.
//
// Design. A direct gather reads one 32-byte sector for each 4-byte value once
// the table outgrows L2 (50 MB), eight times the bytes. So each CTA stages
// the part of x its outputs can reach in shared memory with coalesced loads,
// and gathers from there; every global access is then coalesced.
//   G1: a CTA owns consecutive rows of x and of idx; their x rows (about
//       32 KiB, at least one row) are one contiguous range, loaded 16 bytes a
//       thread where aligned. The gather reads shared memory at random
//       columns (bank conflicts, not DRAM traffic).
//   G2: a CTA owns a strip of 32 columns: x[:, c0:c0+32], R x 128 bytes
//       (640 x 32 int32 = 80 KiB for the tool's table, dynamic shared memory;
//       R up to 1816 rows fits the SM's 227 KB). A warp loads one row's 128
//       bytes at a time, and in the gather lane k reads column k of the strip
//       at its own row: bank k, no conflicts.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneStageInts = 8192;  // G1: x ints a CTA stages, 32 KiB (at least one row)
constexpr int kSubCols = 32;          // G2: the strip's columns, one per lane
constexpr int kMaxSharedBytes = 232448;

__global__ void __launch_bounds__(kThreads)
gather_lane_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                   int* __restrict__ out, int rows, int l, int m, int rows_per_cta) {
  extern __shared__ int4 s_x4[];
  int* s_x = reinterpret_cast<int*>(s_x4);
  const int r0 = blockIdx.x * rows_per_cta;
  const int nr = min(rows_per_cta, rows - r0);
  const int* src = x + static_cast<size_t>(r0) * l;
  const int n = nr * l;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % 4 == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int k = threadIdx.x; k < n / 4; k += kThreads) s_x4[k] = __ldg(src4 + k);
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) s_x[k] = __ldg(src + k);
  }
  __syncthreads();
  for (int rr = 0; rr < nr; ++rr) {
    const size_t row = static_cast<size_t>(r0 + rr) * m;
    const int* s_row = s_x + rr * l;
    for (int j = threadIdx.x; j < m; j += kThreads) out[row + j] = s_row[__ldg(idx + row + j)];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_sub_kernel(const int* __restrict__ x, const int* __restrict__ idx,
                  int* __restrict__ out, int r, int l, int m) {
  extern __shared__ int s_strip[];  // [r][kSubCols]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kSubCols + lane;
  const bool live = col < l;
#pragma unroll 4
  for (int i = warp; i < r; i += kWarps) {
    s_strip[i * kSubCols + lane] = live ? __ldg(x + static_cast<size_t>(i) * l + col) : 0;
  }
  __syncthreads();
  if (!live) return;
#pragma unroll 4
  for (int i = warp; i < m; i += kWarps) {
    const size_t at = static_cast<size_t>(i) * l + col;
    out[at] = s_strip[__ldg(idx + at) * kSubCols + lane];
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's attribute.
template <typename Kernel>
int allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// G1. x [rows, l], idx and out [rows, m], int32, contiguous; idx in [0, l).
extern "C" int splat_probe_gather_lane(const void* x, const void* idx, void* out, int rows,
                                       int l, int m, void* stream) {
  if (rows < 0 || l <= 0 || m < 0 || l > kMaxSharedBytes / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || m == 0) return 0;
  const int rows_per_cta = std::max(1, std::min(rows, kLaneStageInts / l));
  const int smem = rows_per_cta * l * 4;
  if (int code = allow_shared(gather_lane_kernel, smem)) return code;
  const int blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  gather_lane_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(idx), static_cast<int*>(out), rows, l,
      m, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

// G2. x [r, l], idx and out [m, l], int32, contiguous; idx in [0, r); r at
// most kMaxSharedBytes / 128 = 1816.
extern "C" int splat_probe_gather_sub(const void* x, const void* idx, void* out, int r, int l,
                                      int m, void* stream) {
  if (r <= 0 || l < 0 || m < 0 || r > kMaxSharedBytes / (kSubCols * 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (l == 0 || m == 0) return 0;
  const int smem = r * kSubCols * 4;
  if (int code = allow_shared(gather_sub_kernel, smem)) return code;
  const int blocks = (l + kSubCols - 1) / kSubCols;
  gather_sub_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(idx), static_cast<int*>(out), r, l, m);
  return static_cast<int>(cudaGetLastError());
}
