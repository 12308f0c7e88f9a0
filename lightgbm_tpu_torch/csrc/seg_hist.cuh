// The body of the segment histograms K2 (segment_histogram.cu) and K5
// (fused_root_histogram.cu): the (sum g, sum h, count) histogram of arena
// columns [seg[0], seg[0] + seg[1]), whose bins are [G, cap] planes.  The
// two differ only in where a column's payload comes from, a "payload
// source":
// - ArenaPayload<P> (K2): the arena's own [2, cap] planes, f32 g/h or int8
//   codes, read at the column;
// - FreshCodes (K5): a [2, ld] int8 input in segment order, read at the
//   segment row and stored to the arena's code planes at the column on the
//   way, so the codes are written and histogrammed in one pass.
// A source has `Payload` (its element type), `Acc` (the accumulator type)
// and load(col, i, cap, in, g, h): the payload of column col, segment row
// i, of an arena of cap columns, or 0 where `in` is false.  The kernels
// wrap seg_hist_body in their own __global__ functions and launchers; the
// choices and their measurements are in segment_histogram.cu's header and
// PERF.md.
#pragma once

#include <type_traits>

#include "histogram.cuh"

namespace {

constexpr int SEG_THREADS = 512;
constexpr int WARPS = SEG_THREADS / 32;
constexpr int CHUNK = 32;                 // columns a warp takes at once
constexpr int SPAN_ROWS = 512;            // rows a block takes at a time
constexpr int SPAN_CHUNKS = SPAN_ROWS / CHUNK;
constexpr int SLAB = 32;                  // features a slab interleaves
constexpr int BIN_WORDS = 3 * SLAB;       // g, h, count of a slab's bin
constexpr int TILE = 32 * SLAB;           // words of 32 output words j
constexpr unsigned FULL = 0xffffffffu;
static_assert(SPAN_ROWS % CHUNK == 0, "a span is whole chunks");

// int8 segments of at most SMALL_ROWS rows take small_pass
constexpr long long SMALL_ROWS = 1 << 20;

// K2's payload: the arena's [2, cap] planes at the column.
template <typename P>
struct ArenaPayload {
  using Payload = P;
  using Acc = typename HistAcc<P>::T;
  const P* gh;

  __device__ __forceinline__ void load(long long col, long long,
                                       long long cap, bool in, Acc& g,
                                       Acc& h) const {
    g = in ? Acc(__ldg(gh + col)) : Acc(0);
    h = in ? Acc(__ldg(gh + cap + col)) : Acc(0);
  }
};

// K5's payload: [2, ld] int8 codes in segment order, stored to the arena's
// code planes at the column as they are read.  The blocks of every feature
// chunk store the same codes, so no branch on the chunk is needed.
struct FreshCodes {
  using Payload = int8_t;
  using Acc = int;
  const int8_t* codes;   // [2, ld], segment order
  long long ld;
  int8_t* arena;         // [2, cap], the arena's code planes

  __device__ __forceinline__ void load(long long col, long long i,
                                       long long cap, bool in, int& g,
                                       int& h) const {
    g = 0;
    h = 0;
    if (in) {
      const int8_t cg = __ldg(codes + i), ch = __ldg(codes + ld + i);
      arena[col] = cg;
      arena[cap + col] = ch;
      g = cg;
      h = ch;
    }
  }
};

// Words of one slab: the 3 B output words j = 3 b + k of its 32 features,
// j rounded up to whole tiles.
__host__ __device__ constexpr int slab_words(int B) {
  return (3 * B + 31) / 32 * TILE;
}

// One row's bin of one feature, into a slab: the lane's g, h and count
// words lie 32 words apart, all in the lane's bank.  f32 g/h add by
// compare-and-swap loops (no f32 add to shared memory exists in SASS), the
// int32 count and the int8 mode's int32 sums by native adds.
__device__ __forceinline__ void row_add(float* e, float g, float h) {
  atomicAdd(e, g);
  atomicAdd(e + SLAB, h);
  atomicAdd(reinterpret_cast<int*>(e + 2 * SLAB), 1);
}
__device__ __forceinline__ void row_add(int* e, int g, int h) {
  atomicAdd(e, g);
  atomicAdd(e + SLAB, h);
  atomicAdd(e + 2 * SLAB, 1);
}

// A word of the sub-histogram in the output type: the f32 count word holds
// an int32 (exact below 2^24 rows).
__device__ __forceinline__ float out_value(float v, bool count) {
  return count ? (float)__float_as_int(v) : v;
}
__device__ __forceinline__ int out_value(int v, bool) { return v; }

// Word q (0..7) of a lane's two 16-byte loads, by selects (a dynamic index
// into the vectors would put them in local memory).
__device__ __forceinline__ unsigned word_at(const uint4& a, const uint4& b,
                                            int q) {
  const unsigned a0 = (q & 1) ? a.y : a.x, a1 = (q & 1) ? a.w : a.z;
  const unsigned b0 = (q & 1) ? b.y : b.x, b1 = (q & 1) ? b.w : b.z;
  const unsigned wa = (q & 2) ? a1 : a0, wb = (q & 2) ? b1 : b0;
  return (q & 4) ? wb : wa;
}

// Add the block's slabs into out [G, B, 3] with global atomics, coalesced.
// Slab s holds output word j = 3 b + k of its feature f at word 32 j + f,
// so 32 consecutive words j of the slab's features form one 1024-word
// tile.  Each warp takes whole tiles: it reads a tile lane by feature
// (conflict-free), writes it back transposed with a rotation (word 32 f +
// (i + f) % 32 for word j0 + i of feature f, conflict-free both ways), and
// adds it to out lane by word j, 32 consecutive words of a feature at a
// time.  The tiles are disjoint, so the warps need no barrier among them.
template <typename A>
__device__ void flush(A* sh, A* __restrict__ out, int f0, int nf, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = B * 3;                      // output words a feature
  const int per_slab = (rows + 31) / 32;
  const int ntiles = (nf + SLAB - 1) / SLAB * per_slab;
  for (int ti = warp; ti < ntiles; ti += WARPS) {
    const int s = ti / per_slab, j0 = ti % per_slab * 32;
    A* t = sh + (size_t)s * slab_words(B) + j0 * SLAB;
    A v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = out_value(t[i * SLAB + lane], (j0 + i) % 3 == 2);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) t[lane * 32 + ((i + lane) & 31)] = v[i];
    __syncwarp();
#pragma unroll
    for (int f = 0; f < 32; ++f) v[f] = t[f * 32 + ((lane + f) & 31)];
    const int nfs = min(SLAB, nf - s * SLAB);
    const int j = j0 + lane;
    A* o = out + (size_t)(f0 + s * SLAB) * rows + j;
#pragma unroll
    for (int f = 0; f < 32; ++f)
      if (f < nfs && j < rows && v[f] != A(0)) atomicAdd(o + (size_t)f * rows, v[f]);
    __syncwarp();
  }
}

// A small int8 segment, a row a thread (rows b * SEG_THREADS + t, then a
// grid further, ...) over the features of the block's chunk, into
// [nf, B, 3] in output order; the flush adds consecutive words.
template <typename Src>
__device__ __forceinline__ void small_pass(
    const uint8_t* __restrict__ bins, const Src& src,
    int* sh, int* __restrict__ out, long long start, long long cnt,
    long long cap, int f0, int nf, int B) {
  const int words = nf * B * 3;
  for (int i = threadIdx.x; i < (words + 3) / 4; i += SEG_THREADS)
    reinterpret_cast<uint4*>(sh)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (long long i = (long long)blockIdx.x * SEG_THREADS + threadIdx.x;
       i < cnt; i += (long long)gridDim.x * SEG_THREADS) {
    const long long col = start + i;
    int g, h;
    src.load(col, i, cap, true, g, h);
    const uint8_t* bc = bins + (long long)f0 * cap + col;
    for (int f = 0; f < nf; ++f) {
      int* e = sh + (f * B + __ldg(bc + (long long)f * cap)) * 3;
      atomicAdd(e, g);
      atomicAdd(e + 1, h);
      atomicAdd(e + 2, 1);
    }
  }
  __syncthreads();
  int* o = out + (size_t)f0 * B * 3;
  for (int i = threadIdx.x; i < words; i += SEG_THREADS) {
    const int v = sh[i];
    if (v != 0) atomicAdd(o + i, v);
  }
}

// One block of a segment histogram launch: grid (grid_x, feature chunks)
// of SEG_THREADS threads, f_chunk features a chunk, the slabs of a chunk
// in dynamic shared memory.
template <typename Src>
__device__ __forceinline__ void seg_hist_body(
    const uint8_t* __restrict__ bins,   // [G, cap]
    const Src src,                      // by value: K2's SASS as before
    const int* __restrict__ seg,        // start, cnt
    typename Src::Acc* __restrict__ out,   // [G, B, 3]
    int G, int B, long long cap, int f_chunk) {
  using A = typename Src::Acc;
  const long long start = seg[0], cnt = seg[1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, G - f0);
  if constexpr (std::is_same<typename Src::Payload, int8_t>::value) {
    if (cnt <= SMALL_ROWS) {
      if ((long long)blockIdx.x * SEG_THREADS < cnt)
        small_pass(bins, src, sh, out, start, cnt, cap, f0, nf, B);
      return;
    }
  }
  const long long c0 = start / CHUNK;      // the chunk holding the start
  const long long nch = cnt > 0 ? (start + cnt + CHUNK - 1) / CHUNK - c0 : 0;
  if ((long long)blockIdx.x * SPAN_CHUNKS >= nch) return;

  // [nslab, 3 B rounded up to 32, SLAB]
  const int words = (nf + SLAB - 1) / SLAB * slab_words(B);
  for (int i = threadIdx.x; i < words / 4; i += SEG_THREADS)   // 16 bytes
    reinterpret_cast<uint4*>(sh)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long span = (long long)blockIdx.x * SPAN_CHUNKS; span < nch;
       span += (long long)gridDim.x * SPAN_CHUNKS) {
    const long long hi = min(span + SPAN_CHUNKS, nch);
    for (long long c = span + warp; c < hi; c += WARPS) {
      const long long col0 = (c0 + c) * CHUNK;
      const long long col = col0 + lane;
      const bool in = col >= start && col < start + cnt;
      const unsigned valid = __ballot_sync(FULL, in);
      A g, h;
      src.load(col, col - start, cap, in, g, h);
      for (int fb = 0; fb < nf; fb += SLAB) {
        const bool on = fb + lane < nf;
        uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
        if (on) {
          const uint4* p = reinterpret_cast<const uint4*>(
              bins + (long long)(f0 + fb + lane) * cap + col0);
          w0 = __ldg(p);
          w1 = __ldg(p + 1);
        }
        A* hs = sh + (size_t)(fb / SLAB) * slab_words(B) + lane;
#pragma unroll 1
        for (int q = 0; q < CHUNK / 4; ++q) {
          unsigned w = word_at(w0, w1, q);
#pragma unroll
          for (int k = 0; k < 4; ++k, w >>= 8) {
            const int r = 4 * q + k;
            const A gk = __shfl_sync(FULL, g, r);
            const A hk = __shfl_sync(FULL, h, r);
            if (((valid >> r) & 1u) && on)
              row_add(hs + (int)(w & 255u) * BIN_WORDS, gk, hk);
          }
        }
      }
    }
  }
  __syncthreads();
  flush(sh, out, f0, nf, B);
}

// The launch shape of a segment histogram kernel: f_chunk features a
// block (whole slabs, as many as HIST_MAX_SMEM holds) and their bytes of
// dynamic shared memory.  The kernel's limit is raised to the largest size
// asked for so far, per device (set once, not a launch): smem_set holds
// those sizes.  Returns a cudaError_t.
template <typename A, typename Kernel>
int seg_hist_shape(Kernel kernel, int* smem_set, int G, int B, int* f_chunk,
                   int* smem) {
  const int slab_bytes = slab_words(B) * (int)sizeof(A);
  int fc = HIST_MAX_SMEM / slab_bytes * SLAB;
  if (fc > G) fc = G;
  const int bytes = (fc + SLAB - 1) / SLAB * slab_bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = bytes;
  }
  *f_chunk = fc;
  *smem = bytes;
  return 0;
}

// The arguments every segment histogram launch needs: 16-byte loads of
// 32-column chunks, so planes of a multiple of 32 columns on a 16-byte
// aligned bin matrix (the arena's are).
__host__ inline bool seg_hist_args_ok(const uint8_t* bins, int G, int B,
                                      long long cap, int grid_x) {
  return G >= 1 && B >= 1 && B <= 256 && grid_x >= 1 && cap % CHUNK == 0 &&
         ((uintptr_t)bins & 15) == 0;
}

}  // namespace
