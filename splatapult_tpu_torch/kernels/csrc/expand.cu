// expand_fill: enumeration expand of the tile binning, for sm_90a.
//
// Replaces the TPU kernel splatapult_tpu/ops/binning.py::_expand_fill_pallas
// (bodies onehot_kernel / onehot2_kernel / packed_kernel).
//
// Contract (identical to the JAX function): for each instance slot m < emax
// find the covering splat = the kept table row i whose enumeration segment
// [offs_i, offs_i + cnt_i) holds m, and emit three int32 rows [3, emax]:
//   row 0  tile id   tile0_i + ((m - offs_i) / nx_i) * row_step + (m - offs_i) % nx_i
//   row 1  splat id  i
//   row 2  depth     the non-negative f32 depth bits of splat i
// Slots past the last segment (m >= total) come out as 0; the caller masks
// them with m < total.
//
// Design for this card. The TPU kernel had neither scatter nor a cheap
// per-lane search, so it slid a candidate window over a compacted table and
// selected fields through a one-hot matrix product (which forced the 2^24
// field limit and the 16-bit depth halves). Here the covering row is the
// upper bound of m in `ends` = the inclusive cumsum of the per-splat counts
// (offs_i = ends[i-1]); rows with count 0 (culled or dropped splats) share
// their predecessor's end and are skipped by the search itself, so no
// compaction and no sentinel offsets are needed.
//
// What bounds it: latency, not bytes. A first version gave every thread one
// slot and a full binary search over all n rows: 21 dependent loads through
// L2 for n = 1.5M, 0.067 ms on an H100 for 2.57M slots, 4.1x the byte bound
// and a little slower than torch.searchsorted (0.064 ms); this one takes
// 0.036-0.038 ms there (0.030 ms of device time). A CTA's slots are
// consecutive, so the rows they can need are one short range: a CTA owns
// 1024 consecutive slots, four per thread, and
//   1. two warps find the upper bounds of the CTA's first and last slot, each
//      by a 32-way search (warp_search.cuh: every lane probes the end of one
//      of 32 chunks of the range, a ballot picks the chunk: 5 rounds for 1.5M
//      rows, not 21);
//   2. ends[lo0-1 .. lo1-1] go to shared memory with coalesced loads when the
//      range fits (it holds at most one non-empty row per slot, but runs of
//      zero-count rows inside it do not vanish, so it can be wider than the
//      slot count; a range that does not fit is searched in global memory by
//      the same code through a generic pointer);
//   3. every thread searches only that range for its first slot (about 10
//      steps in shared memory) and steps forward for the next three: same
//      row, next row, or a search of what is left, so a long run of culled
//      rows costs a search and not a walk;
//   4. the three table columns are read at the row found (neighbouring
//      threads read neighbouring rows: these loads hit L1) and each output
//      row is written with one 16-byte store per thread.
//
// Bound on an H100: bytes. It must write 12 B per slot and read the 16 B
// per-splat table once: (12 * emax + 16 * n) / 3.35e12 s. The integer work
// (a few compare steps and one division per slot) is far below the card's
// integer rate for the same time.

#include <cuda_runtime.h>

#include "warp_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSlotsPerCta = kThreads * kSlotsPerThread;
constexpr int kRangeCap = 4096;  // rows of `ends` staged in shared memory (16 KB)

// Smallest i in [lo, hi] with i == hi or e[i - eoff] > m (one thread).
__device__ __forceinline__ int upper_bound(const int* e, int eoff, int lo, int hi,
                                           int m) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid - eoff] > m) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_fill_kernel(const int* __restrict__ ends, const int* __restrict__ tile0,
                   const int* __restrict__ nx, const int* __restrict__ dbits,
                   int* __restrict__ out, int n, int emax, int row_step) {
  __shared__ int s_ends[kRangeCap];
  __shared__ int s_bounds[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m_first = blockIdx.x * kSlotsPerCta;
  const int m_last = min(m_first + kSlotsPerCta, emax) - 1;

  // 1. the rows this CTA can need: [lo0, lo1]
  if (warp < 2) {
    const int b = warp_upper_bound([&](int i) { return __ldg(ends + i); }, n,
                                   warp == 0 ? m_first : m_last, lane);
    if (lane == 0) s_bounds[warp] = b;
  }
  __syncthreads();
  const int lo0 = s_bounds[0];
  const int lo1 = s_bounds[1];

  // 2. ends[base .. lo1 - 1], base = max(lo0 - 1, 0): the rows the searches
  // compare against and the offsets of the rows they can return
  const int base = max(lo0 - 1, 0);
  const int* e = ends;
  int eoff = 0;
  if (lo1 - base <= kRangeCap) {
    for (int j = tid; j < lo1 - base; j += kThreads) s_ends[j] = __ldg(ends + base + j);
    e = s_ends;
    eoff = base;
  }
  __syncthreads();

  // 3. + 4. this thread's four consecutive slots
  const int m0 = m_first + tid * kSlotsPerThread;
  if (m0 >= emax) return;
  int tile[kSlotsPerThread], sid[kSlotsPerThread], dep[kSlotsPerThread];
  int lo = upper_bound(e, eoff, lo0, lo1, m0);
  int offs = 0, w = 1, t0 = 0, db = 0, loaded = -1;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int m = m0 + k;
    if (k > 0 && lo < lo1 && e[lo - eoff] <= m) {
      ++lo;
      if (lo < lo1 && e[lo - eoff] <= m) lo = upper_bound(e, eoff, lo + 1, lo1, m);
    }
    tile[k] = 0;
    sid[k] = 0;
    dep[k] = 0;
    if (lo < n && m < emax) {
      if (lo != loaded) {
        offs = lo > 0 ? e[lo - 1 - eoff] : 0;
        w = max(__ldg(nx + lo), 1);
        t0 = __ldg(tile0 + lo);
        db = __ldg(dbits + lo);
        loaded = lo;
      }
      const int j = m - offs;
      tile[k] = t0 + (j / w) * row_step + j % w;
      sid[k] = lo;
      dep[k] = db;
    }
  }
  int* o0 = out + m0;
  int* o1 = out + (size_t)emax + m0;
  int* o2 = out + 2 * (size_t)emax + m0;
  if ((emax & 3) == 0) {  // rows 16-byte aligned and no ragged last thread
    *reinterpret_cast<int4*>(o0) = make_int4(tile[0], tile[1], tile[2], tile[3]);
    *reinterpret_cast<int4*>(o1) = make_int4(sid[0], sid[1], sid[2], sid[3]);
    *reinterpret_cast<int4*>(o2) = make_int4(dep[0], dep[1], dep[2], dep[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) {
      if (m0 + k < emax) {
        o0[k] = tile[k];
        o1[k] = sid[k];
        o2[k] = dep[k];
      }
    }
  }
}

}  // namespace

extern "C" int splat_expand_fill(const void* ends, const void* tile0,
                                 const void* nx, const void* dbits, void* out,
                                 int n, int emax, int row_step, void* stream) {
  if (emax <= 0) return 0;
  const int blocks = (emax + kSlotsPerCta - 1) / kSlotsPerCta;
  expand_fill_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ends), static_cast<const int*>(tile0),
      static_cast<const int*>(nx), static_cast<const int*>(dbits),
      static_cast<int*>(out), n, emax, row_step);
  return static_cast<int>(cudaGetLastError());
}
