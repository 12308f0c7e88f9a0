// The body of the (sum g, sum h, count) histogram kernel K5
// (fused_root_histogram.cu), accumulated per block in shared memory.  K2
// (segment_histogram.cu), K7 (leaf_histogram.cu) and K3's pred mode
// (partition.cuh) take only HistAcc and the shared-memory budget from here;
// K5 is to move onto K2's body (ROADMAP queue 2).
//
// A fixed grid-stride grid walks the rows of a "row source" (the segment's
// start and count, or the leaf to histogram, live on the device, so the
// host never learns a child's size); a block with no row of the pass
// returns at once.  Each working block keeps a [f_chunk, B, 3]
// sub-histogram in dynamic shared memory, accumulates its rows with shared
// atomics, then adds its non-zero entries into the zeroed global [G, B, 3]
// output with global atomics.  gridDim.y splits the features when the
// sub-histogram would exceed one block's shared memory.
//
// A row source is a struct with `Acc`, the accumulator type, and `bind()`,
// which reads the launch's device scalars once per block and returns an
// object with
//   count():                    the number of rows the pass walks;
//   load(i, f0, g, h, bc):      row i's payload and a pointer to its bin of
//                               feature f0, or false when row i does not
//                               belong to the histogram;
//   bin(bc, f):                 the bin of feature f0 + f from that pointer.
// SegmentRows below reads K5's codes in segment order and arena columns
// (bins as [G, cap] planes).
//
// The row sources read their inputs through the read-only path (__ldg):
// their pointers are struct members, which carry no __restrict__.
//
// Payload P and accumulator A: f32 g/h summed in f32 (the order of the
// atomics varies run to run, so sums agree with the plain version to f32
// reassociation), or int8 codes summed in int32 (integer atomics are
// order-independent, so the result is exact).
#pragma once

#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 512;
constexpr int HIST_MAX_SMEM = 200 * 1024;

template <typename P> struct HistAcc;
template <> struct HistAcc<float> { using T = float; };
template <> struct HistAcc<int8_t> { using T = int; };

// K5: columns [seg[0], seg[0] + seg[1]) of an arena whose bins are
// [G, cap] planes.  It reads the payload in segment order from a [2, ld]
// input and stores each value to its arena column on the way; the blocks
// of every feature chunk store the same value, so no branch on the chunk
// is needed.
template <typename P>
struct SegmentRows {
  using Acc = typename HistAcc<P>::T;
  const uint8_t* bins;   // [G, cap]
  const P* payload;      // [2, ld], segment order
  long long ld;
  P* arena_payload;      // [2, cap]
  const int* seg;        // start, cnt
  long long cap;

  struct Bound {
    const uint8_t* bins;
    const P* payload;
    long long ld;
    P* arena_payload;
    long long cap, start, cnt;

    __device__ __forceinline__ long long count() const { return cnt; }
    __device__ __forceinline__ bool load(long long i, int f0, Acc& g, Acc& h,
                                         const uint8_t*& bc) const {
      const long long col = start + i;
      const P pg = __ldg(payload + i);
      const P ph = __ldg(payload + ld + i);
      arena_payload[col] = pg;
      arena_payload[cap + col] = ph;
      g = Acc(pg);
      h = Acc(ph);
      bc = bins + (long long)f0 * cap + col;
      return true;
    }
    __device__ __forceinline__ int bin(const uint8_t* bc, int f) const {
      return __ldg(bc + (long long)f * cap);
    }
  };
  __device__ __forceinline__ Bound bind() const {
    return Bound{bins, payload, ld, arena_payload, cap, seg[0], seg[1]};
  }
};

// One block's share of the pass: zero the sub-histogram of its feature
// chunk, accumulate its rows, flush the non-zero entries.
template <typename Rows>
__device__ __forceinline__ void histogram_pass(
    const Rows& rows, typename Rows::Acc* __restrict__ out, int G, int B,
    int f_chunk) {
  using A = typename Rows::Acc;
  const auto r = rows.bind();
  const long long cnt = r.count();
  if ((long long)blockIdx.x * blockDim.x >= cnt) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);   // [f_chunk, B, 3]
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, G - f0);
  const int entries = nf * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) sh[i] = A(0);
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cnt;
       i += stride) {
    A g, h;
    const uint8_t* bc;
    if (!r.load(i, f0, g, h, bc)) continue;
    for (int f = 0; f < nf; ++f) {
      A* e = sh + (f * B + r.bin(bc, f)) * 3;
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

template <typename Rows>
__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(Rows rows, typename Rows::Acc* __restrict__ out, int G, int B,
                 int f_chunk) {
  histogram_pass(rows, out, G, B, f_chunk);
}

// Launch `kernel` (histogram_kernel or a kernel of the same signature) over
// grid_x blocks and as many feature chunks as the shared memory needs.
template <typename Rows>
int launch_histogram(void (*kernel)(Rows, typename Rows::Acc*, int, int, int),
                     const Rows& rows, typename Rows::Acc* out, int G, int B,
                     int grid_x, cudaStream_t stream) {
  using A = typename Rows::Acc;
  if (G < 1 || B < 1 || B > 256 || grid_x < 1) return (int)cudaErrorInvalidValue;
  int f_chunk = HIST_MAX_SMEM / (B * 3 * (int)sizeof(A));
  if (f_chunk > G) f_chunk = G;
  const int smem = f_chunk * B * 3 * (int)sizeof(A);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (G + f_chunk - 1) / f_chunk);
  kernel<<<grid, HIST_THREADS, smem, stream>>>(rows, out, G, B, f_chunk);
  return (int)cudaGetLastError();
}

}  // namespace
