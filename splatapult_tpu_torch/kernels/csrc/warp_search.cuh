// A sorted search made by a whole warp, for sm_90a.
#pragma once

// Smallest i in [0, n] with i == n or key(i) > m, for a key that does not
// decrease with i. The range [lo, hi) is cut into 32 chunks, lane k probes
// the last index of chunk k, and the first lane whose probe exceeds m names
// the chunk that holds the answer: log32(n) rounds of one load each (5 for
// 1.5M keys) where a binary search takes log2(n) dependent loads (21). All
// 32 lanes must call it; every lane returns the same value.
template <typename Key>
__device__ __forceinline__ int warp_upper_bound(Key key, int n, int m, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = min(lo + lane * step + step - 1, hi - 1);
    const unsigned above = __ballot_sync(0xffffffffu, key(idx) > m);
    if (above == 0u) return hi;
    const int k = __ffs(above) - 1;
    hi = min(lo + k * step + step - 1, hi - 1);  // known to exceed m
    lo = lo + k * step;
  }
  return lo;
}
