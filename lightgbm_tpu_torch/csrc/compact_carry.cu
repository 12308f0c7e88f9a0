// K6: compact the finished tree's live leaf segments, every plane, into one
// dense block at dst0, in leaf-index order.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _compact_carry_kernel
// (launched by compact_carry, pl.pallas_call at :691).  It is the
// carried-arena tree boundary: the next tree roots at the compacted block,
// so the rows keep the order the last tree left them in (leaf by leaf,
// each leaf's rows in their stable partition order) and no row-order
// recovery is needed.  The TPU kernel streams tiles through a VMEM carry
// window because its DMA writes must be 256-column aligned; Hopper stores
// any column.
//
// What bounds it on an H100: bytes.  Each live row's planes (G bin bytes,
// the payload: 8 bytes of g/h or 2 of codes, a 4-byte row id) are read once
// and written once: 2*n*(G+6) bytes with codes, 0.21 ms for the 10.5M-row
// Higgs arena at 3.35 TB/s.  This version moves each plane a byte or a word
// per thread, so it is not at that bound.
//
// Design: two launches.  carry_offsets_kernel, one block, computes the
// exclusive scan of the live segments' counts into offs[] and the total
// into used[0]; carry_copy_kernel, grid (grid_x, L), has block (x, l) copy
// leaf l's rows to dst0 + offs[l] with a grid stride over x, returning at
// once when l >= nl.
// Counts, nl and the offsets stay on the device, so the host never syncs.
#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int COPY_THREADS = 256;

__global__ void __launch_bounds__(SCAN_THREADS)
carry_offsets_kernel(const int* __restrict__ seg, const int* __restrict__ nl,
                     int L, int* __restrict__ offs, int* __restrict__ used) {
  __shared__ int part[SCAN_THREADS];
  const int live = min(*nl, L);
  const int per = (live + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * per, live);
  const int hi = min(lo + per, live);
  int sum = 0;
  for (int l = lo; l < hi; ++l) sum += seg[2 * l + 1];
  part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < SCAN_THREADS; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
    used[0] = run;
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (int l = lo; l < hi; ++l) {
    offs[l] = run;
    run += seg[2 * l + 1];
  }
}

template <typename P>
__global__ void __launch_bounds__(COPY_THREADS)
carry_copy_kernel(ArenaT<P> a, const int* __restrict__ seg,
                  const int* __restrict__ nl, const int* __restrict__ offs,
                  long long dst0, int G) {
  const int l = blockIdx.y;
  if (l >= *nl) return;
  const long long start = seg[2 * l];
  const long long cnt = seg[2 * l + 1];
  const long long d0 = dst0 + offs[l];
  const long long stride = (long long)gridDim.x * COPY_THREADS;
  for (long long i = (long long)blockIdx.x * COPY_THREADS + threadIdx.x; i < cnt;
       i += stride)
    move_row(a, start + i, a, d0 + i, G);
}

template <typename P>
int launch(uint8_t* bins, P* gh, int* rid, long long cap, const int* seg,
           const int* nl, int L, int* offs, int* used, long long dst0, int G,
           int grid_x, cudaStream_t stream) {
  if (G < 1 || L < 1 || L > 65535 || grid_x < 1) return (int)cudaErrorInvalidValue;
  const ArenaT<P> a{bins, gh, rid, cap};
  carry_offsets_kernel<<<1, SCAN_THREADS, 0, stream>>>(seg, nl, L, offs, used);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, L);
  carry_copy_kernel<P><<<grid, COPY_THREADS, 0, stream>>>(a, seg, nl, offs,
                                                          dst0, G);
  return (int)cudaGetLastError();
}

}  // namespace

LGBT_API int lgbt_compact_carry(uint8_t* bins, float* gh, int* rid,
                                long long cap, const int* seg, const int* nl,
                                int L, int* offs, int* used, long long dst0,
                                int G, int grid_x, cudaStream_t stream) {
  return launch<float>(bins, gh, rid, cap, seg, nl, L, offs, used, dst0, G,
                       grid_x, stream);
}

LGBT_API int lgbt_compact_carry_i8(uint8_t* bins, int8_t* codes, int* rid,
                                   long long cap, const int* seg, const int* nl,
                                   int L, int* offs, int* used, long long dst0,
                                   int G, int grid_x, cudaStream_t stream) {
  return launch<int8_t>(bins, codes, rid, cap, seg, nl, L, offs, used, dst0, G,
                        grid_x, stream);
}
