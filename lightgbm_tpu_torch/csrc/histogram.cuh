// The shared body of K2 (segment_histogram.cu) and K5
// (fused_root_histogram.cu): the (sum g, sum h, count) histogram of one
// arena segment, accumulated per block in shared memory.
//
// A fixed grid-stride grid (the segment's start and count live on the
// device, so the host never learns a child's size); a block with no row of
// the segment returns at once.  Each working block keeps a [f_chunk, B, 3]
// sub-histogram in dynamic shared memory, accumulates its rows with shared
// atomics, then adds its non-zero entries into the zeroed global [G, B, 3]
// output with global atomics.  gridDim.y splits the features when the
// sub-histogram would exceed one block's shared memory.
//
// Payload P and accumulator A: f32 g/h summed in f32 (the order of the
// atomics varies run to run, so sums agree with the plain version to f32
// reassociation), or int8 codes summed in int32 (integer atomics are
// order-independent, so the result is exact).  FUSED (K5) reads the codes
// from a [2, ld] input in segment order and stores each one to its arena
// column on the way.
#pragma once

#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 512;
constexpr int HIST_MAX_SMEM = 200 * 1024;

template <typename P> struct HistAcc;
template <> struct HistAcc<float> { using T = float; };
template <> struct HistAcc<int8_t> { using T = int; };

template <typename P, bool FUSED>
__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const uint8_t* __restrict__ bins,   // [G, cap]
                 const P* __restrict__ payload,      // [2, ld]
                 long long ld,
                 P* __restrict__ arena_payload,      // FUSED: [2, cap]
                 const int* __restrict__ seg,        // start, cnt
                 typename HistAcc<P>::T* __restrict__ out,   // [G, B, 3]
                 int G, int B, long long cap, int f_chunk) {
  using A = typename HistAcc<P>::T;
  const long long start = seg[0];
  const long long cnt = seg[1];
  if ((long long)blockIdx.x * blockDim.x >= cnt) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);   // [f_chunk, B, 3]
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, G - f0);
  const int entries = nf * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) sh[i] = A(0);
  __syncthreads();

  const bool store = FUSED && blockIdx.y == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cnt;
       i += stride) {
    const long long col = start + i;
    const long long src = FUSED ? i : col;
    const P pg = payload[src];
    const P ph = payload[ld + src];
    if (store) {
      arena_payload[col] = pg;
      arena_payload[cap + col] = ph;
    }
    const A g = A(pg);
    const A h = A(ph);
    const uint8_t* bc = bins + (long long)f0 * cap + col;
    for (int f = 0; f < nf; ++f) {
      const int bin = bc[(long long)f * cap];
      A* e = sh + (f * B + bin) * 3;
      atomicAdd(e, g);
      atomicAdd(e + 1, h);
      atomicAdd(e + 2, A(1));
    }
  }
  __syncthreads();

  A* o = out + (size_t)f0 * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const A v = sh[i];
    if (v != A(0)) atomicAdd(o + i, v);
  }
}

template <typename P, bool FUSED>
int launch_histogram(const uint8_t* bins, const P* payload, long long ld,
                     P* arena_payload, const int* seg,
                     typename HistAcc<P>::T* out, int G, int B, long long cap,
                     int grid_x, cudaStream_t stream) {
  using A = typename HistAcc<P>::T;
  if (G < 1 || B < 1 || B > 256 || grid_x < 1) return (int)cudaErrorInvalidValue;
  int f_chunk = HIST_MAX_SMEM / (B * 3 * (int)sizeof(A));
  if (f_chunk > G) f_chunk = G;
  const int smem = f_chunk * B * 3 * (int)sizeof(A);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel<P, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (G + f_chunk - 1) / f_chunk);
  histogram_kernel<P, FUSED><<<grid, HIST_THREADS, smem, stream>>>(
      bins, payload, ld, arena_payload, seg, out, G, B, cap, f_chunk);
  return (int)cudaGetLastError();
}

}  // namespace
