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
// Higgs arena at 3.35 TB/s (0.25 ms with f32 g/h).  A copy a byte a thread
// waits on load/store instructions instead (32 bytes a warp instruction).
//
// Design: one launch of a grid sized from the SM count, driven by the
// destination, so the leaves' sizes do not matter.
// - Every block computes the exclusive prefix of the live counts itself,
//   block-wide, into shared memory: the offset of every K-th leaf, K = 1
//   up to PREFIX_CAP live leaves (K grows past that, so any L the wrapper
//   takes fits).  Block 0 also writes offs[] and used[0].
// - The destination [dst0, dst0 + used) is cut into units of 16 columns
//   aligned on the planes (plane bases are 16-byte aligned and cap is a
//   multiple of 16).  Threads take units grid-stride.  A unit is one
//   aligned 16-byte word of each byte plane (bins; int8 codes) and four of
//   each 4-byte plane (f32 g/h, row ids).
// - A thread finds the leaf of its unit's first column by a binary search
//   of the prefix in shared memory (then a walk of at most K-1 counts).
//   When the unit's 16 columns lie in that leaf and inside the block, it
//   reads each plane's 16 source columns, which start at any column, as
//   the aligned 16-byte words that hold them (the second only when the
//   start is not aligned) and joins them with funnel shifts; it loads a
//   batch of planes before it stores them, so each thread keeps several
//   loads in flight.
// - A unit that spans a leaf boundary, or holds the block's first or last
//   column, finds the source of each of its columns first, then gathers a
//   batch of planes' values with all their loads in flight before it
//   stores them: one 16-byte store a plane inside the block, a store a
//   column at its edges, so no column outside the block is written.  (A
//   copy a column and a plane at a time there would wait on one load
//   after another, hundreds in a row, and a few such threads would set
//   the kernel's time.)
// Source words read past a leaf's columns are dropped by the shift; they
// are never written back.  Counts, nl and the offsets stay on the device,
// so the host never syncs.
#include "common.cuh"

namespace {

constexpr int CARRY_THREADS = 256;
constexpr int UNIT = 16;            // destination columns a unit
constexpr int PREFIX_CAP = 4096;    // prefix entries kept in shared memory
constexpr int BATCH = 4;            // byte planes loaded before their stores

// Bytes sh (0..15) to sh + 15 of the 32 bytes x:y, by word selects and
// funnel shifts.
__device__ __forceinline__ uint4 shift_bytes(const uint4& x, const uint4& y,
                                             int sh) {
  unsigned w0 = x.x, w1 = x.y, w2 = x.z, w3 = x.w, w4 = y.x, w5 = y.y;
  const unsigned w6 = y.z, w7 = y.w;
  if (sh & 8) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7; }
  if (sh & 4) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }
  const int r = (sh & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, r), __funnelshift_r(w1, w2, r),
                    __funnelshift_r(w2, w3, r), __funnelshift_r(w3, w4, r));
}

// Words q (0..3) to q + 3 of the 8 words x:y.
__device__ __forceinline__ uint4 shift_words(const uint4& x, const uint4& y,
                                             int q) {
  unsigned w0 = x.x, w1 = x.y, w2 = x.z, w3 = x.w, w4 = y.x, w5 = y.y;
  if (q & 2) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = y.z; }
  if (q & 1) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; }
  return make_uint4(w0, w1, w2, w3);
}

// The 16 bytes of a byte plane from column s (any alignment).
__device__ __forceinline__ uint4 load_bytes(const uint8_t* plane,
                                            long long s) {
  const int sh = (int)(s & 15);
  const uint4* p = reinterpret_cast<const uint4*>(plane + (s - sh));
  const uint4 x = p[0];
  if (sh == 0) return x;
  return shift_bytes(x, p[1], sh);
}

// Columns s to s + 15 of a 4-byte plane into the unit at d (16 aligned).
__device__ __forceinline__ void copy_words(const unsigned* src, unsigned* dst,
                                           long long s, long long d) {
  const int q = (int)(s & 3);
  const uint4* p = reinterpret_cast<const uint4*>(src + (s - q));
  uint4 v[5];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = p[i];
  v[4] = q ? p[4] : make_uint4(0, 0, 0, 0);
  uint4* o = reinterpret_cast<uint4*>(dst + d);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = q ? shift_words(v[i], v[i + 1], q) : v[i];
}

// The payload's planes of a unit: f32 g/h as 4-byte planes, codes as byte
// planes.
__device__ __forceinline__ void copy_payload(float* gh, long long cap,
                                             long long s, long long d) {
  unsigned* w = reinterpret_cast<unsigned*>(gh);
  copy_words(w, w, s, d);
  copy_words(w + cap, w + cap, s, d);
}
__device__ __forceinline__ void copy_payload(int8_t* codes, long long cap,
                                             long long s, long long d) {
  uint8_t* b = reinterpret_cast<uint8_t*>(codes);
  const uint4 g = load_bytes(b, s), h = load_bytes(b + cap, s);
  *reinterpret_cast<uint4*>(b + d) = g;
  *reinterpret_cast<uint4*>(b + cap + d) = h;
}

// The bytes of columns src[k] of a byte plane, k < UNIT where valid, as
// the 16 bytes of a unit (0 elsewhere).
__device__ __forceinline__ uint4 gather_bytes(const uint8_t* plane,
                                              const int* src,
                                              unsigned valid) {
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < UNIT; ++k)
    if ((valid >> k) & 1u) w[k / 4] |= (unsigned)plane[src[k]] << (8 * (k % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A unit's 16 bytes into a byte plane at d: one 16-byte store when the
// whole unit is written, else the valid columns one at a time.
__device__ __forceinline__ void put_bytes(uint8_t* plane, long long d,
                                          const uint4& v, unsigned valid,
                                          bool whole) {
  if (whole) {
    *reinterpret_cast<uint4*>(plane + d) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < UNIT; ++k)
    if ((valid >> k) & 1u) plane[d + k] = (uint8_t)(w[k / 4] >> (8 * (k % 4)));
}

// Columns src[k] of a 4-byte plane into the unit at d, gathered before they
// are stored.
__device__ __forceinline__ void gather_words(unsigned* plane, long long d,
                                             const int* src, unsigned valid,
                                             bool whole) {
  unsigned w[UNIT];
#pragma unroll
  for (int k = 0; k < UNIT; ++k) w[k] = ((valid >> k) & 1u) ? plane[src[k]] : 0u;
  if (whole) {
    uint4* o = reinterpret_cast<uint4*>(plane + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < UNIT; ++k)
    if ((valid >> k) & 1u) plane[d + k] = w[k];
}

__device__ __forceinline__ void gather_payload(float* gh, long long cap,
                                               long long d, const int* src,
                                               unsigned valid, bool whole) {
  unsigned* w = reinterpret_cast<unsigned*>(gh);
  gather_words(w, d, src, valid, whole);
  gather_words(w + cap, d, src, valid, whole);
}
__device__ __forceinline__ void gather_payload(int8_t* codes, long long cap,
                                               long long d, const int* src,
                                               unsigned valid, bool whole) {
  uint8_t* b = reinterpret_cast<uint8_t*>(codes);
  const uint4 g = gather_bytes(b, src, valid), h = gather_bytes(b + cap, src, valid);
  put_bytes(b, d, g, valid, whole);
  put_bytes(b + cap, d, h, valid, whole);
}

__device__ __forceinline__ int live_count(const int* seg, int l, int live) {
  return l < live ? seg[2 * l + 1] : 0;
}

// The leaf holding destination column j (0 <= j < the rows written): the
// last prefix group whose offset is <= j, then its leaves in turn.  Sets
// m, its offset and its count.
__device__ __forceinline__ void find_leaf(const int* __restrict__ seg,
                                          int live, const int* pre, int ng,
                                          int K, long long j, int& m,
                                          long long& off, long long& cnt) {
  int lo = 0, hi = ng;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= j) lo = mid; else hi = mid;
  }
  m = lo * K;
  off = pre[lo];
  cnt = live_count(seg, m, live);
  while (j >= off + cnt) {
    off += cnt;
    cnt = live_count(seg, ++m, live);
  }
}

// Destination unit [D, D + UNIT) of the block [dst0, end), every plane.
template <typename P>
__device__ __forceinline__ void copy_unit(const ArenaT<P>& a,
                                          const int* __restrict__ seg,
                                          int live, const int* pre, int ng,
                                          int K, long long dst0, long long end,
                                          long long D, int G) {
  const long long d_lo = D > dst0 ? D : dst0;
  const long long d_hi = D + UNIT < end ? D + UNIT : end;
  const long long j = d_lo - dst0;
  int m;
  long long off, cnt;
  find_leaf(seg, live, pre, ng, K, j, m, off, cnt);
  const long long s = seg[2 * m] + (j - off);
  if (d_lo == D && d_hi == D + UNIT && j + UNIT <= off + cnt) {
    // the whole unit from one leaf: aligned 16-byte stores
    int c = 0;
    for (; c + BATCH <= G; c += BATCH) {
      uint4 v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        v[k] = load_bytes(a.bins + (c + k) * a.cap, s);
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        *reinterpret_cast<uint4*>(a.bins + (c + k) * a.cap + D) = v[k];
    }
    for (; c < G; ++c) {
      const uint4 v = load_bytes(a.bins + c * a.cap, s);
      *reinterpret_cast<uint4*>(a.bins + c * a.cap + D) = v;
    }
    copy_payload(a.gh, a.cap, s, D);
    copy_words(reinterpret_cast<const unsigned*>(a.rid),
               reinterpret_cast<unsigned*>(a.rid), s, D);
    return;
  }
  // across leaf boundaries or at the block's edge: the unit's source
  // columns first, then each plane's values gathered (all loads of a batch
  // of planes in flight before its stores) and stored, whole or by column
  int src[UNIT];
  unsigned valid = 0;
  long long sc = s;
#pragma unroll
  for (int k = 0; k < UNIT; ++k) {
    const long long d = D + k;
    src[k] = 0;
    if (d < d_lo || d >= d_hi) continue;
    const long long jd = d - dst0;
    if (jd >= off + cnt) {
      do {
        off += cnt;
        cnt = live_count(seg, ++m, live);
      } while (jd >= off + cnt);
      sc = seg[2 * m] + (jd - off);
    }
    src[k] = (int)sc++;
    valid |= 1u << k;
  }
  const bool whole = d_lo == D && d_hi == D + UNIT;
  int c = 0;
  for (; c + BATCH <= G; c += BATCH) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      v[k] = gather_bytes(a.bins + (c + k) * a.cap, src, valid);
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      put_bytes(a.bins + (c + k) * a.cap, D, v[k], valid, whole);
  }
  for (; c < G; ++c)
    put_bytes(a.bins + c * a.cap, D,
              gather_bytes(a.bins + c * a.cap, src, valid), valid, whole);
  gather_payload(a.gh, a.cap, D, src, valid, whole);
  gather_words(reinterpret_cast<unsigned*>(a.rid), D, src, valid, whole);
}

template <typename P>
__global__ void __launch_bounds__(CARRY_THREADS)
compact_carry_kernel(ArenaT<P> a, const int* __restrict__ seg,
                     const int* __restrict__ nl, int L, int* __restrict__ offs,
                     int* __restrict__ used, long long dst0, int G) {
  __shared__ int pre[PREFIX_CAP];
  __shared__ int warp_sum[CARRY_THREADS / 32];
  __shared__ int total_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = max(0, min(*nl, L));
  const int K = max(1, (live + PREFIX_CAP - 1) / PREFIX_CAP);

  // ---- the prefix: a run of leaves a thread, a block-wide scan ----------
  const int per = (live + CARRY_THREADS - 1) / CARRY_THREADS;
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
  if (tid == CARRY_THREADS - 1) total_sh = base + incl;
  int run = base + incl - sum;
  for (int l = lo; l < hi; ++l) {
    if (l % K == 0) pre[l / K] = run;
    if (blockIdx.x == 0) offs[l] = run;
    run += seg[2 * l + 1];
  }
  __syncthreads();
  const long long total = total_sh;
  if (blockIdx.x == 0 && tid == 0) used[0] = (int)total;
  if (total == 0) return;
  const int ng = (live + K - 1) / K;

  // ---- the units, grid-stride -------------------------------------------
  const long long end = dst0 + total;
  const long long u0 = dst0 / UNIT, nu = (end + UNIT - 1) / UNIT - u0;
  for (long long u = (long long)blockIdx.x * CARRY_THREADS + tid; u < nu;
       u += (long long)gridDim.x * CARRY_THREADS)
    copy_unit(a, seg, live, pre, ng, K, dst0, end, (u0 + u) * UNIT, G);
}

template <typename P>
int launch(uint8_t* bins, P* gh, int* rid, long long cap, const int* seg,
           const int* nl, int L, int* offs, int* used, long long dst0, int G,
           cudaStream_t stream) {
  // 16-byte words of every plane: 16-byte aligned bases, cap a multiple of
  // 16 columns (the arena's: a multiple of 2048); int32 source columns
  if (G < 1 || L < 1 || L > 65535 || dst0 < 0 || cap % UNIT != 0 ||
      cap > 0x7fffffffLL ||
      (((uintptr_t)bins | (uintptr_t)gh | (uintptr_t)rid) & 15) != 0)
    return (int)cudaErrorInvalidValue;
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
        &per_sm, compact_carry_kernel<P>, CARRY_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) grid_of[dev] = grid;
  }
  const ArenaT<P> a{bins, gh, rid, cap};
  compact_carry_kernel<P><<<grid, CARRY_THREADS, 0, stream>>>(
      a, seg, nl, L, offs, used, dst0, G);
  return (int)cudaGetLastError();
}

}  // namespace

LGBT_API int lgbt_compact_carry(uint8_t* bins, float* gh, int* rid,
                                long long cap, const int* seg, const int* nl,
                                int L, int* offs, int* used, long long dst0,
                                int G, cudaStream_t stream) {
  return launch<float>(bins, gh, rid, cap, seg, nl, L, offs, used, dst0, G,
                       stream);
}

LGBT_API int lgbt_compact_carry_i8(uint8_t* bins, int8_t* codes, int* rid,
                                   long long cap, const int* seg, const int* nl,
                                   int L, int* offs, int* used, long long dst0,
                                   int G, cudaStream_t stream) {
  return launch<int8_t>(bins, codes, rid, cap, seg, nl, L, offs, used, dst0, G,
                        stream);
}
