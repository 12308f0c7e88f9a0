// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes plain C entry points (no PyTorch headers), so
// each file builds with nvcc in seconds and loads through ctypes.  Each
// entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() so that a refused launch reaches the Python
// wrapper, which raises.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LGBT_API extern "C" __attribute__((visibility("default")))

// Lane layout of one packed split row, shared with ops/split_kernel.py and
// the grower's split cache (the Pallas scan's _OG.._ORO lanes).
enum : int {
  OG = 0, OF = 1, OT = 2, ODL = 3, OLG = 4, OLH = 5, OLC = 6, OLO = 7,
  ORG = 8, ORH = 9, ORC = 10, ORO = 11, ROW_W = 12
};

// The arena of the partition engine (ops/partition_kernel.py): a segment is
// a contiguous column range of every plane.  P is the payload type: float
// (gradient, hessian) or int8_t (their quantized codes).
template <typename P>
struct ArenaT {
  uint8_t* bins;    // [G, cap] feature bins
  P* gh;            // [2, cap] payload
  int* rid;         // [cap] row id
  long long cap;
};

// NaN-propagating min/max: jnp.maximum/jnp.minimum semantics, which the
// reference scan relies on (fmaxf would swallow a NaN).
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float jsign(float x) {
  if (x != x) return x;
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}
