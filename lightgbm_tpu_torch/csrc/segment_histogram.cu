// K2: (sum g, sum h, count) histogram of one arena segment.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _seg_hist_kernel (launched
// by segment_histogram, pl.pallas_call at :1019), f32 mode.  The TPU kernel
// has no fast scatter, so it splits every payload into bf16 residue planes
// and histograms them with one-hot matrix products; on Hopper a
// shared-memory atomicAdd is the natural scatter and the arena keeps plain
// uint8 bins and f32 g/h.
//
// What bounds it on an H100: bytes.  Each row of the segment is read once,
// G bin bytes + 8 bytes of g/h (n*(G+8) bytes: 378 MB for the 10.5M-row
// Higgs root, 0.11 ms at 3.35 TB/s), against 3*G shared-memory atomics a
// row.  The atomics, not the bytes, are what this first version waits on.
//
// Design: a fixed grid-stride grid (the segment's start and count live on
// the device, so the host never learns a child's size); a block with no row
// of the segment returns at once.  Each working block keeps a
// [f_chunk, B, 3] f32 sub-histogram in dynamic shared memory, accumulates
// its rows with shared atomics, then adds its non-zero entries into the
// zeroed global [G, B, 3] output with global atomics.  gridDim.y splits the
// features when G*B*3 floats exceed one block's shared memory.  Atomic
// order varies run to run, so results agree with the plain version to f32
// reassociation.
#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 512;

__global__ void __launch_bounds__(HIST_THREADS)
segment_histogram_kernel(const uint8_t* __restrict__ bins,  // [G, cap]
                         const float* __restrict__ gh,      // [2, cap]
                         const int* __restrict__ seg,       // start, cnt
                         float* __restrict__ out,           // [G, B, 3]
                         int G, int B, long long cap, int f_chunk) {
  const long long start = seg[0];
  const long long cnt = seg[1];
  if ((long long)blockIdx.x * blockDim.x >= cnt) return;

  extern __shared__ float sh[];   // [f_chunk, B, 3]
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, G - f0);
  const int entries = nf * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cnt;
       i += stride) {
    const long long col = start + i;
    const float g = gh[col];
    const float h = gh[cap + col];
    const uint8_t* bc = bins + (long long)f0 * cap + col;
    for (int f = 0; f < nf; ++f) {
      const int bin = bc[(long long)f * cap];
      float* e = sh + (f * B + bin) * 3;
      atomicAdd(e, g);
      atomicAdd(e + 1, h);
      atomicAdd(e + 2, 1.f);
    }
  }
  __syncthreads();

  float* o = out + (size_t)f0 * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

}  // namespace

LGBT_API int lgbt_segment_histogram(const uint8_t* bins, const float* gh,
                                    const int* seg, float* out, int G, int B,
                                    long long cap, int grid_x,
                                    cudaStream_t stream) {
  if (G < 1 || B < 1 || B > 256 || grid_x < 1) return (int)cudaErrorInvalidValue;
  const int max_smem = 200 * 1024;
  int f_chunk = max_smem / (B * 3 * (int)sizeof(float));
  if (f_chunk > G) f_chunk = G;
  const int smem = f_chunk * B * 3 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      segment_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (G + f_chunk - 1) / f_chunk);
  segment_histogram_kernel<<<grid, HIST_THREADS, smem, stream>>>(
      bins, gh, seg, out, G, B, cap, f_chunk);
  return (int)cudaGetLastError();
}
