// The live leaf segments of a finished tree, as K4 (scatter_segments.cu)
// and K6 (compact_carry.cu) walk them: leaf l < nl holds seg[l] = (start,
// count) of the arena's columns, and its rows follow leaf l - 1's in
// leaf-index order.
//
// Every block of those kernels scans the live counts itself into an
// exclusive prefix in shared memory (the offset of every K-th leaf), so a
// launch needs no host sync and no second pass; a thread then finds the
// leaf of a position of the live rows by a binary search of the prefix and
// a walk of at most K - 1 counts (`find_leaf`).
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ int live_count(const int* seg, int l, int live) {
  return l < live ? seg[2 * l + 1] : 0;
}

// The leaf holding live row j (0 <= j < the live rows): the last prefix
// group whose offset is <= j, then its leaves in turn.  Sets m, its offset
// and its count.
__device__ __forceinline__ void find_leaf(const int* __restrict__ seg,
                                          int live, const int* pre, int ng,
                                          int K, long long j, int& m,
                                          long long& off, long long& cnt) {
  int lo = 0, hi = ng;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= j) lo = mid; else hi = mid;
  }
  m = lo * K;
  off = pre[lo];
  cnt = live_count(seg, m, live);
  while (j >= off + cnt) {
    off += cnt;
    cnt = live_count(seg, ++m, live);
  }
}

}  // namespace
