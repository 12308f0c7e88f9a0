// The body of K3 (partition_segment.cu), shared with K8, its stage
// ablation (partition_ablate.cu).  partition_segment.cu describes the
// kernels; K8's stages are template instances of scatter_kernel that
// partition_segment.cu never instantiates.
#pragma once

#include "histogram.cuh"

namespace {

constexpr int PART_THREADS = 256;
constexpr int PART_WARPS = PART_THREADS / 32;

// sc layout, shared with ops/partition_kernel.py
enum { SC_START = 0, SC_CNT = 1, SC_DST_A = 2, SC_DST_B = 3, SC_CNT_B = 4,
       SC_CNT_A = 5, SC_CHAN = 6, SC_XR = 7 };

// The cumulative stages of scatter_kernel (K8, partition_ablate.cu).
enum { STAGE_READ = 0, STAGE_DECIDE = 1, STAGE_SCAN = 2, STAGE_MOVE = 3 };

// Rows per block: whole 256-row tiles, the segment spread over the grid.
__device__ __forceinline__ long long chunk_rows(long long cnt, int nblocks) {
  const long long tiles = (cnt + PART_THREADS - 1) / PART_THREADS;
  return (tiles + nblocks - 1) / nblocks * PART_THREADS;
}

// Decision mode: stream A is (goleft[bin of channel sc[CHAN]] != 0) XOR
// sc[XR].  bind() reads the per-launch scalars once per block.
struct DecisionRoute {
  const uint8_t* bins;
  long long cap;
  const uint8_t* goleft;

  struct Bound {
    const uint8_t* chan;
    const uint8_t* goleft;
    int xr;
    __device__ __forceinline__ int operator()(long long col) const {
      return (goleft[chan[col]] != 0) ^ xr;
    }
  };
  __device__ __forceinline__ Bound bind(const int* sc) const {
    return Bound{bins + (long long)sc[SC_CHAN] * cap, goleft, sc[SC_XR]};
  }
};

// Pred mode: stream A is pred[col] != 0 (0 past the predicate's length).
struct PredRoute {
  const uint8_t* pred;
  long long len;

  __device__ __forceinline__ PredRoute bind(const int*) const { return *this; }
  __device__ __forceinline__ int operator()(long long col) const {
    return col < len && pred[col] != 0;
  }
};

// The histogram output of a HIST launch.
template <typename P>
struct HistSink {
  typename HistAcc<P>::T* out;   // [G, B, 3], zeroed by the caller
  int B;
  int f_chunk;                   // features per shared-memory pass
  int stream;                    // 0: stream A's rows, 1: stream B's
};

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

// Add column col's g/h and count into the sub-histogram of features
// [f0, f0 + nf).
template <typename P, typename A>
__device__ __forceinline__ void accumulate_row(const ArenaT<P>& a,
                                               long long col, A* sh, int f0,
                                               int nf, int B) {
  const A g = A(a.gh[col]);
  const A h = A(a.gh[a.cap + col]);
  const uint8_t* bc = a.bins + (long long)f0 * a.cap + col;
  for (int f = 0; f < nf; ++f) {
    A* e = sh + (f * B + bc[(long long)f * a.cap]) * 3;
    atomicAdd(e, g);
    atomicAdd(e + 1, h);
    atomicAdd(e + 2, A(1));
  }
}

template <typename A>
__device__ __forceinline__ void zero_hist(A* sh, int entries) {
  for (int i = threadIdx.x; i < entries; i += blockDim.x) sh[i] = A(0);
}

template <typename A>
__device__ __forceinline__ void flush_hist(const A* sh, A* out, int f0, int nf,
                                           int B) {
  A* o = out + (size_t)f0 * B * 3;
  for (int i = threadIdx.x; i < nf * B * 3; i += blockDim.x) {
    const A v = sh[i];
    if (v != A(0)) atomicAdd(o + i, v);
  }
}

template <typename Route>
__global__ void __launch_bounds__(PART_THREADS)
count_kernel(const int* __restrict__ sc, Route route,
             int* __restrict__ block_a) {
  __shared__ int red[PART_WARPS];
  const long long start = sc[SC_START];
  const long long cnt = sc[SC_CNT];
  const auto goes_a = route.bind(sc);
  const long long chunk = chunk_rows(cnt, gridDim.x);
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, cnt);
  int local = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += PART_THREADS)
    local += goes_a(start + i);
  const int total = block_sum(local, red);
  if (threadIdx.x == 0) block_a[blockIdx.x] = total;
}

// One row's planes summed as bits: what K8's early stages read, so that
// no load is dead.
__device__ __forceinline__ unsigned bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned bits_of(int8_t v) { return (uint8_t)v; }

template <typename P>
__device__ __forceinline__ unsigned plane_sum(const ArenaT<P>& a, long long col,
                                              int G) {
  unsigned s = 0;
  for (int c = 0; c < G; ++c) s += a.bins[c * a.cap + col];
  return s + bits_of(a.gh[col]) + bits_of(a.gh[a.cap + col]) +
         (unsigned)a.rid[col];
}

// The block's checksum into the scratch row-id plane, which K8's early
// stages never write otherwise.
template <typename P>
__device__ __forceinline__ void store_checksum(unsigned chk, int* red,
                                               const ArenaT<P>& scratch) {
  const int total = block_sum((int)chk, red);
  if (threadIdx.x == 0 && blockIdx.x < scratch.cap)
    scratch.rid[blockIdx.x] = total;
}

// STAGE: K3 is STAGE_MOVE, the default.  K8 (partition_ablate.cu) compiles
// the kernel stripped to its cumulative stages: STAGE_READ reads every
// plane of its rows, STAGE_DECIDE adds the router, STAGE_SCAN adds the
// block-offset scan and the ballot block scan (each row's destination
// computed and summed); all three leave a checksum instead of moving rows.
template <typename P, typename Route, bool HIST, int STAGE = STAGE_MOVE>
__global__ void __launch_bounds__(PART_THREADS)
scatter_kernel(ArenaT<P> a, ArenaT<P> scratch, int* __restrict__ sc,
               Route route, const int* __restrict__ block_a, int G,
               HistSink<P> hs) {
  using A = typename HistAcc<P>::T;
  __shared__ int red[PART_WARPS];
  __shared__ int warp_off[PART_WARPS + 1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);   // HIST: [f_chunk, B, 3]
  const long long start = sc[SC_START];
  const long long cnt = sc[SC_CNT];
  const long long dst_b = sc[SC_DST_B];
  const auto goes_a = route.bind(sc);
  const long long chunk = chunk_rows(cnt, gridDim.x);
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, cnt);
  const int hist_a = HIST ? (hs.stream == 0) : 0;   // histogram stream A?
  const int nf0 = HIST ? min(hs.f_chunk, G) : 0;
  if (HIST) zero_hist(sh, nf0 * hs.B * 3);
  if constexpr (STAGE < STAGE_SCAN) {
    unsigned chk = 0;
    for (long long i = lo + threadIdx.x; i < hi; i += PART_THREADS) {
      chk += plane_sum(a, start + i, G);
      if constexpr (STAGE == STAGE_DECIDE) chk += goes_a(start + i);
    }
    store_checksum(chk, red, scratch);
    return;
  }
  [[maybe_unused]] unsigned chk = 0;

  int before = 0, all = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += PART_THREADS) {
    const int v = block_a[j];
    all += v;
    if (j < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, red);   // its __syncthreads order the zeroing
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
    const int is_a = valid ? goes_a(start + i) : 0;
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
      if constexpr (STAGE == STAGE_SCAN) {
        chk += plane_sum(a, start + i, G) + is_a +
               (unsigned)(is_a ? run_a + a_before
                               : dst_b + run_b + (threadIdx.x - a_before));
      } else {
        if (is_a)
          move_row(a, start + i, scratch, run_a + a_before, G);
        else
          move_row(a, start + i, a, dst_b + run_b + (threadIdx.x - a_before),
                   G);
        if (HIST && is_a == hist_a)
          accumulate_row(a, start + i, sh, 0, nf0, hs.B);
      }
    }
    const int tile_a = warp_off[PART_WARPS];
    const long long tile_n = min((long long)PART_THREADS, hi - base);
    run_a += tile_a;
    run_b += tile_n - tile_a;
    __syncthreads();
  }
  if constexpr (STAGE == STAGE_SCAN) {
    store_checksum(chk, red, scratch);
    return;
  }

  if (HIST) {
    flush_hist(sh, hs.out, 0, nf0, hs.B);
    // features past the first chunk: one more walk of the block's rows per
    // chunk, from the source columns, which this kernel never overwrites
    for (int f0 = nf0; f0 < G; f0 += hs.f_chunk) {
      const int nf = min(hs.f_chunk, G - f0);
      __syncthreads();
      zero_hist(sh, nf * hs.B * 3);
      __syncthreads();
      for (long long i = lo + threadIdx.x; i < hi; i += PART_THREADS)
        if (goes_a(start + i) == hist_a)
          accumulate_row(a, start + i, sh, f0, nf, hs.B);
      __syncthreads();
      flush_hist(sh, hs.out, f0, nf, hs.B);
    }
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

template <typename P, typename Route, bool HIST>
int launch(const ArenaT<P>& a, const ArenaT<P>& s, int* sc, Route route,
           int* block_a, int nblocks, int G, HistSink<P> hs,
           cudaStream_t stream) {
  using A = typename HistAcc<P>::T;
  if (G < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err;
  if constexpr (HIST) {
    if (hs.out == nullptr || hs.B < 1 || hs.B > 256 || (hs.stream & ~1))
      return (int)cudaErrorInvalidValue;
    hs.f_chunk = HIST_MAX_SMEM / (hs.B * 3 * (int)sizeof(A));
    if (hs.f_chunk > G) hs.f_chunk = G;
    smem = hs.f_chunk * hs.B * 3 * (int)sizeof(A);
    err = cudaFuncSetAttribute(scatter_kernel<P, Route, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  count_kernel<Route><<<nblocks, PART_THREADS, 0, stream>>>(sc, route, block_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<P, Route, HIST><<<nblocks, PART_THREADS, smem, stream>>>(
      a, s, sc, route, block_a, G, hs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  copy_back_kernel<P><<<nblocks, PART_THREADS, 0, stream>>>(s, a, sc, G);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_decision(uint8_t* bins, P* gh, int* rid, long long cap,
                    uint8_t* sbins, P* sgh, int* srid, long long scap, int* sc,
                    const uint8_t* goleft, int* block_a, int nblocks, int G,
                    cudaStream_t stream) {
  const ArenaT<P> a{bins, gh, rid, cap};
  const ArenaT<P> s{sbins, sgh, srid, scap};
  return launch<P, DecisionRoute, false>(a, s, sc,
                                         DecisionRoute{bins, cap, goleft},
                                         block_a, nblocks, G, HistSink<P>{},
                                         stream);
}

template <typename P>
int launch_pred(uint8_t* bins, P* gh, int* rid, long long cap, uint8_t* sbins,
                P* sgh, int* srid, long long scap, int* sc,
                const uint8_t* pred, long long pred_len, int* block_a,
                int nblocks, int G, typename HistAcc<P>::T* hist, int B,
                int hist_stream, cudaStream_t stream) {
  const ArenaT<P> a{bins, gh, rid, cap};
  const ArenaT<P> s{sbins, sgh, srid, scap};
  const PredRoute route{pred, pred_len};
  if (hist == nullptr)
    return launch<P, PredRoute, false>(a, s, sc, route, block_a, nblocks, G,
                                       HistSink<P>{}, stream);
  return launch<P, PredRoute, true>(a, s, sc, route, block_a, nblocks, G,
                                    HistSink<P>{hist, B, 0, hist_stream},
                                    stream);
}

}  // namespace
