// Shared-memory (sum g, sum h, count) sub-histograms of K3's pred mode
// (partition.cuh) and K7 (leaf_histogram.cu).
//
// An entry is three accumulator words, laid out as the [F, B, 3] output.
// For f32 g/h the count word holds an int32 during accumulation: an f32
// atomicAdd to shared memory is a compare-and-swap loop on Hopper, an
// int32 one a native add, so one of the three atomics of every row and
// feature is the cheap kind.  The flush converts the count to the output
// type (exact: counts stay below 2^24 rows).  For f64 g/h (K7's f64
// payload) the count word holds a uint64 (a native shared atomic), exact
// in the f64 output.  For int8 codes all three words are int32 (exact).
#pragma once

#include "histogram.cuh"

namespace {

__device__ __forceinline__ void hist_add(float* e, float g, float h) {
  atomicAdd(e, g);
  atomicAdd(e + 1, h);
  atomicAdd(reinterpret_cast<int*>(e + 2), 1);
}
__device__ __forceinline__ void hist_add(int* e, int g, int h) {
  atomicAdd(e, g);
  atomicAdd(e + 1, h);
  atomicAdd(e + 2, 1);
}
__device__ __forceinline__ void hist_add(double* e, double g, double h) {
  atomicAdd(e, g);
  atomicAdd(e + 1, h);
  atomicAdd(reinterpret_cast<unsigned long long*>(e + 2), 1ull);
}

// The same sums straight into the global [F, B, 3] output (whose count is
// in the output type).
__device__ __forceinline__ void hist_add_global(float* e, float g, float h) {
  atomicAdd(e, g);
  atomicAdd(e + 1, h);
  atomicAdd(e + 2, 1.f);
}
__device__ __forceinline__ void hist_add_global(int* e, int g, int h) {
  atomicAdd(e, g);
  atomicAdd(e + 1, h);
  atomicAdd(e + 2, 1);
}

// Entry word i of a shared sub-histogram in the output type.
__device__ __forceinline__ float hist_value(const float* sh, int i) {
  return i % 3 == 2 ? (float)__float_as_int(sh[i]) : sh[i];
}
__device__ __forceinline__ int hist_value(const int* sh, int i) {
  return sh[i];
}
__device__ __forceinline__ double hist_value(const double* sh, int i) {
  return i % 3 == 2
             ? (double)*reinterpret_cast<const unsigned long long*>(sh + i)
             : sh[i];
}

template <typename A>
__device__ __forceinline__ void hist_zero(A* sh, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) sh[i] = A(0);
}

// Add the non-zero words of a block's sub-histogram into out (the words
// of the block's feature range), with global atomics.
template <typename A>
__device__ __forceinline__ void hist_flush(const A* sh, A* out, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const A v = hist_value(sh, i);
    if (v != A(0)) atomicAdd(out + i, v);
  }
}

}  // namespace
