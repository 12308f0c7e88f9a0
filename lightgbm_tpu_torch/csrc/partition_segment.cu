// K3: stable two-way partition of one arena segment (decision mode), for
// an arena of f32 g/h or of int8 codes.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _partition_kernel
// (launched by partition_segment, pl.pallas_call at :528) in its decision
// mode.  Rows of [start, start+cnt) whose bin on channel `chan` maps to
// goleft[bin] XOR xr == 1 form stream A (the larger child), the others
// stream B (the smaller child, written at the bump cursor dstB).  Both
// streams keep the parent's row order and every plane moves with its row.
//
// The TPU kernel writes stream A in place because its grid runs in order
// and writes provably lag reads; Hopper's blocks run in parallel, so that
// trick does not carry over.  Here:
//   1. count_kernel: each block counts the A rows of its contiguous chunk;
//   2. scatter_kernel: each block sums the counts of the blocks before it
//      (a one-block exclusive scan done redundantly per block, at most a
//      few thousand integers), then walks its chunk in 256-row tiles with a
//      ballot-based block scan and writes A rows to the scratch arena and
//      B rows straight to dstB; block 0 stores both counts in sc;
//   3. copy_back_kernel: copies the A rows from the scratch arena to dstA,
//      which may be the parent's own start.
// The segment and the decision are read from the device vector sc, so the
// host launches a fixed grid and never learns a child's size.
//
// What bounds it on an H100: bytes.  Each row (G bin bytes, 8 bytes of g/h
// or 2 of codes, a 4-byte row id) is read once and written once:
// 2*n*(G+12) or 2*n*(G+6) bytes, 0.25 or 0.21 ms for the 10.5M-row Higgs
// root at 3.35 TB/s.  This version moves the
// stream-A rows twice (through the scratch arena), reads the decision
// channel twice, and writes single bytes per plane, so it is not at that
// bound; a decoupled look-back scan with in-place A writes is later work.
#include "common.cuh"

namespace {

constexpr int PART_THREADS = 256;
constexpr int PART_WARPS = PART_THREADS / 32;

// sc layout, shared with ops/partition_kernel.py
enum { SC_START = 0, SC_CNT = 1, SC_DST_A = 2, SC_DST_B = 3, SC_CNT_B = 4,
       SC_CNT_A = 5, SC_CHAN = 6, SC_XR = 7 };

// Rows per block: whole 256-row tiles, the segment spread over the grid.
__device__ __forceinline__ long long chunk_rows(long long cnt, int nblocks) {
  const long long tiles = (cnt + PART_THREADS - 1) / PART_THREADS;
  return (tiles + nblocks - 1) / nblocks * PART_THREADS;
}

__device__ __forceinline__ int goes_a(const uint8_t* chan, long long col,
                                      const uint8_t* goleft, int xr) {
  return (goleft[chan[col]] != 0) ^ xr;
}

// Sum of v over the block; every thread gets the total.
__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int k = 0; k < PART_WARPS; ++k) s += red[k];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(PART_THREADS)
count_kernel(const uint8_t* __restrict__ bins, long long cap,
             const int* __restrict__ sc,
             const uint8_t* __restrict__ goleft, int* __restrict__ block_a) {
  __shared__ int red[PART_WARPS];
  const long long start = sc[SC_START];
  const long long cnt = sc[SC_CNT];
  const int xr = sc[SC_XR];
  const uint8_t* chan = bins + (long long)sc[SC_CHAN] * cap;
  const long long chunk = chunk_rows(cnt, gridDim.x);
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, cnt);
  int local = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += PART_THREADS)
    local += goes_a(chan, start + i, goleft, xr);
  const int total = block_sum(local, red);
  if (threadIdx.x == 0) block_a[blockIdx.x] = total;
}

template <typename P>
__global__ void __launch_bounds__(PART_THREADS)
scatter_kernel(ArenaT<P> a, ArenaT<P> scratch, int* __restrict__ sc,
               const uint8_t* __restrict__ goleft,
               const int* __restrict__ block_a, int G) {
  __shared__ int red[PART_WARPS];
  __shared__ int warp_off[PART_WARPS + 1];
  const long long start = sc[SC_START];
  const long long cnt = sc[SC_CNT];
  const long long dst_b = sc[SC_DST_B];
  const int xr = sc[SC_XR];
  const uint8_t* chan = a.bins + (long long)sc[SC_CHAN] * a.cap;
  const long long chunk = chunk_rows(cnt, gridDim.x);
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, cnt);

  int before = 0, all = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += PART_THREADS) {
    const int v = block_a[j];
    all += v;
    if (j < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[SC_CNT_A] = all;
    sc[SC_CNT_B] = (int)(cnt - all);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long run_a = before;        // A rows written by earlier tiles/blocks
  long long run_b = lo - before;   // B rows likewise
  for (long long base = lo; base < hi; base += PART_THREADS) {
    const long long i = base + threadIdx.x;
    const bool valid = i < hi;
    const int is_a = valid ? goes_a(chan, start + i, goleft, xr) : 0;
    const unsigned m = __ballot_sync(0xffffffffu, is_a);
    const int pre = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) red[warp] = __popc(m);
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int k = 0; k < PART_WARPS; ++k) {
        warp_off[k] = s;
        s += red[k];
      }
      warp_off[PART_WARPS] = s;
    }
    __syncthreads();
    const int a_before = warp_off[warp] + pre;   // A rows before i in the tile
    if (valid) {
      if (is_a)
        move_row(a, start + i, scratch, run_a + a_before, G);
      else
        move_row(a, start + i, a, dst_b + run_b + (threadIdx.x - a_before), G);
    }
    const int tile_a = warp_off[PART_WARPS];
    const long long tile_n = min((long long)PART_THREADS, hi - base);
    run_a += tile_a;
    run_b += tile_n - tile_a;
    __syncthreads();
  }
}

template <typename P>
__global__ void __launch_bounds__(PART_THREADS)
copy_back_kernel(ArenaT<P> scratch, ArenaT<P> a, const int* __restrict__ sc, int G) {
  const long long n_a = sc[SC_CNT_A];
  const long long dst_a = sc[SC_DST_A];
  const long long stride = (long long)gridDim.x * PART_THREADS;
  for (long long i = (long long)blockIdx.x * PART_THREADS + threadIdx.x; i < n_a;
       i += stride)
    move_row(scratch, i, a, dst_a + i, G);
}

template <typename P>
int launch(uint8_t* bins, P* gh, int* rid, long long cap, uint8_t* sbins,
           P* sgh, int* srid, long long scap, int* sc, const uint8_t* goleft,
           int* block_a, int nblocks, int G, cudaStream_t stream) {
  if (G < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const ArenaT<P> a{bins, gh, rid, cap};
  const ArenaT<P> s{sbins, sgh, srid, scap};
  count_kernel<<<nblocks, PART_THREADS, 0, stream>>>(bins, cap, sc, goleft,
                                                     block_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<P><<<nblocks, PART_THREADS, 0, stream>>>(a, s, sc, goleft,
                                                          block_a, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  copy_back_kernel<P><<<nblocks, PART_THREADS, 0, stream>>>(s, a, sc, G);
  return (int)cudaGetLastError();
}

}  // namespace

LGBT_API int lgbt_partition_segment(uint8_t* bins, float* gh, int* rid,
                                    long long cap, uint8_t* sbins, float* sgh,
                                    int* srid, long long scap, int* sc,
                                    const uint8_t* goleft, int* block_a,
                                    int nblocks, int G, cudaStream_t stream) {
  return launch<float>(bins, gh, rid, cap, sbins, sgh, srid, scap, sc, goleft,
                       block_a, nblocks, G, stream);
}

LGBT_API int lgbt_partition_segment_i8(uint8_t* bins, int8_t* codes, int* rid,
                                       long long cap, uint8_t* sbins,
                                       int8_t* scodes, int* srid,
                                       long long scap, int* sc,
                                       const uint8_t* goleft, int* block_a,
                                       int nblocks, int G,
                                       cudaStream_t stream) {
  return launch<int8_t>(bins, codes, rid, cap, sbins, scodes, srid, scap, sc,
                        goleft, block_a, nblocks, G, stream);
}
