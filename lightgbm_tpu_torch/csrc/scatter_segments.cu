// K4: per-row leaf values (or leaf ids) from the finished tree's segments,
// set into a row-ordered output or added to it.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _compact_rows_kernel
// (launched by compact_segments, pl.pallas_call at :820) together with its
// consumer's sort by row id (lightgbm_tpu/ops/grow_partition.py:967-996).
// The TPU has no fast scatter, so the Pallas kernel streams (rowid, value)
// pairs into a dense block that XLA then sorts back into row order.  On
// Hopper a scatter by row id is cheap, so this kernel computes the
// composition directly, for each live leaf l < nl and each row i of its
// segment, r = rid[start_l + i]:
// - set: out[r] = vals[l] (f32 leaf values, or int32 leaf ids);
// - add (f32): out[r] = out[r] + vals[l] * s, rounded as two f32
//   operations (__fmul_rn, then an add rounded as __fadd_rn): the fused
//   paths' score update `score += delta * shrink`
//   (lightgbm_tpu/models/gbdt.py:777) folded into the scatter, bit for
//   bit.  s is read from device memory at launch, so a captured round
//   takes the learning rate of the moment it is replayed (a schedule
//   rewrites the scalar; no graph is captured anew).
//
// What bounds it on an H100: bytes by count (8n: 84 MB at 10.5M rows, 25 us
// at 3.35 TB/s; 12n in add mode, which also reads the score), but a row's
// access lands on a 32-byte L2 sector of its own (a leaf's rows lie about
// L rows apart), so the rate of scattered sector accesses is the limit.
// The design keeps it at one access a row: add mode adds in the L2 with
// a reduction instead of loading the score and storing it back, and both
// modes keep the output's lines in the L2 (evict_last), where the other
// rows of a sector find them.
//
// Design: one launch of a grid sized from the SM count, driven by the live
// rows, so the leaves' sizes do not matter (K6's schedule,
// compact_carry.cu, with warps in place of threads):
// - every block scans the live counts into a shared-memory prefix, so the
//   host never syncs;
// - the live rows, in leaf-index order, are cut into warp units of
//   32 * UNIT rows; warps take them warp-stride, lane l the rows
//   l + 32 k (k < UNIT) of its unit, so each of the warp's row id loads
//   reads consecutive columns;
// - a lane finds the leaf of its first row by a binary search of the
//   prefix (live_segments.cuh, K6's) and walks on to the leaf of each
//   later row, issuing all UNIT row id loads before its stores (or
//   reductions).
// A thread of its own UNIT consecutive rows, reading them as aligned
// 16-byte words as K6 reads its columns, measured no faster on even and
// carried leaves and 1.5x slower on a skewed tree, whose largest leaf's
// rows lie close enough for a warp's stores to share sectors.
#include "live_segments.cuh"

namespace {

constexpr int SCATTER_THREADS = 256;
constexpr int UNIT = 16;            // rows a lane takes from a warp unit
constexpr int PREFIX_CAP = 4096;    // prefix entries kept in shared memory

// The block-wide exclusive prefix of the live counts, as K6 scans it: a
// run of leaves a thread, warp scans by shuffles, the warps' totals.
// pre[l / K] is the offset of leaf l for every l % K == 0.  Returns the live
// rows; ends with the block synchronised.
template <int THREADS>
__device__ __forceinline__ long long scan_live(const int* __restrict__ seg,
                                               int live, int K, int* pre,
                                               int* warp_sum, int& total_sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (live + THREADS - 1) / THREADS;
  const int lo = min(tid * per, live), hi = min(lo + per, live);
  int sum = 0;
  for (int l = lo; l < hi; ++l) sum += seg[2 * l + 1];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  if (tid == THREADS - 1) total_sh = base + incl;
  int run = base + incl - sum;
  for (int l = lo; l < hi; ++l) {
    if (l % K == 0) pre[l / K] = run;
    run += seg[2 * l + 1];
  }
  __syncthreads();
  return total_sh;
}

// What a row of leaf m receives: the leaf's value (set), or the leaf's
// value times s, to be added (add).
template <typename T, bool ADD>
__device__ __forceinline__ T leaf_term(const T* __restrict__ vals, int m,
                                       float s) {
  if constexpr (ADD) return __fmul_rn(vals[m], s);
  else return vals[m];
}

// An L2 policy that keeps the output's lines (createpolicy, sm_80+): a
// 32-byte sector of it takes 8 rows, each a scattered access of its own.
__device__ __forceinline__ unsigned long long keep_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ void store_keep(float* a, float v,
                                           unsigned long long p) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(a), "f"(v), "l"(p) : "memory");
}
__device__ __forceinline__ void store_keep(int* a, int v,
                                           unsigned long long p) {
  asm volatile("st.global.L2::cache_hint.s32 [%0], %1, %2;"
               :: "l"(a), "r"(v), "l"(p) : "memory");
}
// *a += v in the L2 (a reduction: no load comes back to the thread).  It
// flushes subnormal inputs and results to zero, which changes no result
// of __fadd_rn(*a, v) when |v| >= 2^-101: a subnormal *a is then below
// half an ulp of v, and a sum of two such numbers is 0 or normal.
__device__ __forceinline__ void add_keep(float* a, float v,
                                         unsigned long long p) {
  asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(a), "f"(v), "l"(p) : "memory");
}
constexpr float RED_MIN = 0x1p-101f;

// The lane's rows r[k] (k where valid) receive v[k]: set, or added (a
// term too small for the reduction by a load, __fadd_rn and a store).
template <typename T, bool ADD>
__device__ __forceinline__ void put_rows(T* __restrict__ out, const int* r,
                                         const T* v, unsigned valid) {
  const unsigned long long pol = keep_policy();
#pragma unroll
  for (int k = 0; k < UNIT; ++k) {
    if (!((valid >> k) & 1u)) continue;
    if constexpr (ADD) {
      if (fabsf(v[k]) >= RED_MIN) add_keep(out + r[k], v[k], pol);
      else out[r[k]] = __fadd_rn(out[r[k]], v[k]);
    } else {
      store_keep(out + r[k], v[k], pol);
    }
  }
}

// Lane j0 % 32 of its warp unit: live rows j0 + 32 k (k < UNIT) of
// `total`.
template <typename T, bool ADD>
__device__ __forceinline__ void scatter_lane(
    const int* __restrict__ rid, const int* __restrict__ seg,
    const T* __restrict__ vals, float s, int live, const int* pre, int ng,
    int K, long long total, long long j0, T* __restrict__ out) {
  if (j0 >= total) return;
  int m;
  long long off, cnt;
  find_leaf(seg, live, pre, ng, K, j0, m, off, cnt);
  long long base = seg[2 * m] - off;    // row j of leaf m at column base + j
  int r[UNIT];
  T v[UNIT];
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < UNIT; ++k) {
    const long long j = j0 + 32 * k;
    r[k] = 0;
    v[k] = T(0);
    if (j >= total) continue;
    if (j >= off + cnt) {
      do {
        off += cnt;
        cnt = live_count(seg, ++m, live);
      } while (j >= off + cnt);
      base = seg[2 * m] - off;
    }
    r[k] = rid[base + j];
    v[k] = leaf_term<T, ADD>(vals, m, s);
    valid |= 1u << k;
  }
  put_rows<T, ADD>(out, r, v, valid);
}

template <typename T, bool ADD>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_segments_kernel(const int* __restrict__ rid,
                        const int* __restrict__ seg,   // [L, 2] start, cnt
                        const T* __restrict__ vals,    // [L]
                        const int* __restrict__ nl,    // [1]
                        int L,
                        const float* __restrict__ shrink,  // [1], add only
                        T* __restrict__ out) {
  __shared__ int pre[PREFIX_CAP];
  __shared__ int warp_sum[SCATTER_THREADS / 32];
  __shared__ int total_sh;
  const int live = max(0, min(*nl, L));
  const int K = max(1, (live + PREFIX_CAP - 1) / PREFIX_CAP);
  const long long total =
      scan_live<SCATTER_THREADS>(seg, live, K, pre, warp_sum, total_sh);
  if (total == 0) return;
  float s = 0.f;
  if constexpr (ADD) s = __ldg(shrink);
  const int ng = (live + K - 1) / K;
  const long long nw = (total + 32 * UNIT - 1) / (32 * UNIT);
  const long long warp =
      ((long long)blockIdx.x * SCATTER_THREADS + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * SCATTER_THREADS) >> 5;
  for (long long w = warp; w < nw; w += warps)
    scatter_lane<T, ADD>(rid, seg, vals, s, live, pre, ng, K, total,
                         w * 32 * UNIT + (threadIdx.x & 31), out);
}

template <typename T, bool ADD>
int launch(const int* rid, const int* seg, const T* vals, const int* nl,
           const float* s, T* out, int L, cudaStream_t stream) {
  if (L < 1 || L > 65535) return (int)cudaErrorInvalidValue;
  // blocks: as many as the SMs hold at once, per device (set once)
  static int grid_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int grid = dev < 64 ? grid_of[dev] : 0;
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_segments_kernel<T, ADD>, SCATTER_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) grid_of[dev] = grid;
  }
  scatter_segments_kernel<T, ADD><<<grid, SCATTER_THREADS, 0, stream>>>(
      rid, seg, vals, nl, L, s, out);
  return (int)cudaGetLastError();
}

}  // namespace

LGBT_API int lgbt_scatter_segments_f32(const int* rid, const int* seg,
                                       const float* vals, const int* nl,
                                       float* out, int L,
                                       cudaStream_t stream) {
  return launch<float, false>(rid, seg, vals, nl, nullptr, out, L, stream);
}

LGBT_API int lgbt_scatter_segments_i32(const int* rid, const int* seg,
                                       const int* vals, const int* nl,
                                       int* out, int L, cudaStream_t stream) {
  return launch<int, false>(rid, seg, vals, nl, nullptr, out, L, stream);
}

LGBT_API int lgbt_scatter_segments_add(const int* rid, const int* seg,
                                       const float* vals, const int* nl,
                                       const float* s, float* out, int L,
                                       cudaStream_t stream) {
  return launch<float, true>(rid, seg, vals, nl, s, out, L, stream);
}
