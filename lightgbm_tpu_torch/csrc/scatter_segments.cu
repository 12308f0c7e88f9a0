// K4: per-row leaf values (or leaf ids) from the finished tree's segments.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _compact_rows_kernel
// (launched by compact_segments, pl.pallas_call at :820) together with its
// consumer's sort by row id (lightgbm_tpu/ops/grow_partition.py:967-996).
// The TPU has no fast scatter, so the Pallas kernel streams (rowid, value)
// pairs into a dense block that XLA then sorts back into row order.  On
// Hopper a scatter by row id is cheap, so this kernel computes the
// composition directly: for each live leaf l < nl and each row of its
// segment, out[rid[start_l + i]] = vals[l].
//
// What bounds it on an H100: bytes.  4 bytes of row id read and 4 bytes of
// output written per row (n*8 bytes: 84 MB at 10.5M rows, 25 us at
// 3.35 TB/s).  The writes land at random rows, one 32-byte sector per
// 4-byte value, so the scattered writes are what it waits on.
//
// Design: grid (grid_x, L); block (x, l) walks leaf l's segment with a
// grid stride over x and returns at once when l >= nl.  Segments, values
// and nl are read on the device, so the launch needs no host sync.
#include "common.cuh"

namespace {

constexpr int SCATTER_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_segments_kernel(const int* __restrict__ rid,
                        const int* __restrict__ seg,   // [L, 2] start, cnt
                        const T* __restrict__ vals,    // [L]
                        const int* __restrict__ nl,    // [1]
                        T* __restrict__ out) {
  const int l = blockIdx.y;
  if (l >= *nl) return;
  const long long start = seg[2 * l];
  const long long cnt = seg[2 * l + 1];
  const T v = vals[l];
  const long long stride = (long long)gridDim.x * SCATTER_THREADS;
  for (long long i = (long long)blockIdx.x * SCATTER_THREADS + threadIdx.x;
       i < cnt; i += stride)
    out[rid[start + i]] = v;
}

template <typename T>
int launch(const int* rid, const int* seg, const T* vals, const int* nl, T* out,
           int L, int grid_x, cudaStream_t stream) {
  if (L < 1 || L > 65535 || grid_x < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(grid_x, L);
  scatter_segments_kernel<T><<<grid, SCATTER_THREADS, 0, stream>>>(rid, seg, vals,
                                                                  nl, out);
  return (int)cudaGetLastError();
}

}  // namespace

LGBT_API int lgbt_scatter_segments_f32(const int* rid, const int* seg,
                                       const float* vals, const int* nl,
                                       float* out, int L, int grid_x,
                                       cudaStream_t stream) {
  return launch<float>(rid, seg, vals, nl, out, L, grid_x, stream);
}

LGBT_API int lgbt_scatter_segments_i32(const int* rid, const int* seg,
                                       const int* vals, const int* nl, int* out,
                                       int L, int grid_x, cudaStream_t stream) {
  return launch<int>(rid, seg, vals, nl, out, L, grid_x, stream);
}
