// K2: (sum g, sum h, count) histogram of one arena segment.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _seg_hist_kernel (launched
// by segment_histogram, pl.pallas_call at :1019), in its f32 mode and its
// quantized mode.  The TPU kernel has no fast scatter, so it splits every
// payload into bf16 residue planes (or carries the int8 codes as bf16) and
// histograms them with one-hot matrix products; on Hopper a shared-memory
// atomicAdd is the natural scatter and the arena keeps plain uint8 bins
// beside f32 g/h or int8 codes.
//
// What bounds it on an H100: bytes.  Each row of the segment is read once,
// G bin bytes plus 8 bytes of g/h (f32) or 2 bytes of codes (int8): 378 MB
// or 315 MB for the 10.5M-row Higgs root, 0.11 or 0.094 ms at 3.35 TB/s,
// against G shared-memory updates a row, which are what it waits on: the
// number of shared atomic instructions a row (about four cycles each on
// an SM), and on small segments a block's fixed cost (zero, flush).  An
// f32 shared atomicAdd is a compare-and-swap loop on Hopper (no native f32
// add to shared memory in SASS, nor a 64-bit integer one); an int32 add is
// native.
//
// Design (the choices and their measurements: PERF.md, K2):
// - Lanes are features, warps are rows.  A warp takes a chunk of 32 arena
//   columns; lane f loads the chunk's 32 bins of feature f with two 16-byte
//   loads (one 32-byte sector of its plane) and lane k the chunk's g/h of
//   column k, which reach every lane by shuffles.  Features past 32 take
//   further passes over the chunk.
// - Slabs: the block's sub-histogram interleaves 32 features, output word
//   j = 3 b + k of feature f at word 32 j + f, so lane f's atomics always
//   hit bank f: an atomic instruction of a warp is one conflict-free
//   wavefront, and no two of its lanes share an address (a
//   compare-and-swap retries only when another warp updates the same
//   feature and bin at the same moment).
// - Small int8 segments (up to SMALL_ROWS rows, a uniform choice from the
//   device count) take the first K2's loop instead: a thread a row over
//   the features into a [nf, B, 3] sub-histogram in output order, whose
//   flush is a coalesced read with no transpose.  Its shared atomics meet
//   in banks, but int32 adds are native, and below about a million rows
//   the cheaper flush wins (PERF.md); f32 adds are compare-and-swap loops
//   that the banks' collisions make retry, so f32 always takes the slabs.
// - The count is an int32 word, a native shared add, and the flush
//   converts it to the f32 output (exact below 2^24 rows).
// - Chunks are 32-column blocks of the planes from the one holding the
//   segment's start, so every 16-byte load is aligned; columns of the first
//   and last chunk outside the segment are masked (the whole chunk lies in
//   the plane, whose length is a multiple of 32).
// - Blocks sized from the segment's count on the device: block b takes
//   spans of SPAN_ROWS rows (b, b + grid, ...) and works only while
//   b * SPAN_ROWS < the chunked count, so a 40k-row child wakes 79 blocks
//   and a cnt = 0 segment none.  The grid is fixed at launch and nothing
//   is read back to the host.
// - The flush is coalesced: every warp transposes whole 32 x 32 tiles of
//   the slabs in place (a rotation keeps both directions conflict-free)
//   and adds 32 consecutive output words of a feature at a time with
//   global atomics.
// - gridDim.y splits the features, whole slabs at a time, when the
//   sub-histogram would exceed one block's shared memory.
// The int8 mode accumulates int32, so the card's result equals the plain
// version exactly; the f32 mode agrees with it to f32 reassociation.
// K5 (fused_root_histogram.cu) keeps histogram.cuh's histogram_pass.
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
__device__ __forceinline__ void small_pass(
    const uint8_t* __restrict__ bins, const int8_t* __restrict__ codes,
    int* sh, int* __restrict__ out, long long start, long long cnt,
    long long cap, int f0, int nf, int B) {
  const int words = nf * B * 3;
  for (int i = threadIdx.x; i < (words + 3) / 4; i += SEG_THREADS)
    reinterpret_cast<uint4*>(sh)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (long long i = (long long)blockIdx.x * SEG_THREADS + threadIdx.x;
       i < cnt; i += (long long)gridDim.x * SEG_THREADS) {
    const long long col = start + i;
    const int g = __ldg(codes + col), h = __ldg(codes + cap + col);
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

template <typename P>
__global__ void __launch_bounds__(SEG_THREADS, 1024 / SEG_THREADS)
seg_hist_kernel(const uint8_t* __restrict__ bins,   // [G, cap]
                const P* __restrict__ gh,           // [2, cap]
                const int* __restrict__ seg,        // start, cnt
                typename HistAcc<P>::T* __restrict__ out,   // [G, B, 3]
                int G, int B, long long cap, int f_chunk) {
  using A = typename HistAcc<P>::T;
  const long long start = seg[0], cnt = seg[1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, G - f0);
  if constexpr (std::is_same<P, int8_t>::value) {
    if (cnt <= SMALL_ROWS) {
      if ((long long)blockIdx.x * SEG_THREADS < cnt)
        small_pass(bins, gh, sh, out, start, cnt, cap, f0, nf, B);
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
      const A g = in ? A(__ldg(gh + col)) : A(0);
      const A h = in ? A(__ldg(gh + cap + col)) : A(0);
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

template <typename P>
int launch_seg_hist(const uint8_t* bins, const P* gh, const int* seg,
                    typename HistAcc<P>::T* out, int G, int B, long long cap,
                    int grid_x, cudaStream_t stream) {
  using A = typename HistAcc<P>::T;
  // 16-byte loads of 32-column chunks: planes of a multiple of 32 columns
  // on a 16-byte aligned bin matrix (the arena's are)
  if (G < 1 || B < 1 || B > 256 || grid_x < 1 || cap % CHUNK != 0 ||
      ((uintptr_t)bins & 15) != 0)
    return (int)cudaErrorInvalidValue;
  // whole slabs a feature chunk
  const int slab_bytes = slab_words(B) * (int)sizeof(A);
  int f_chunk = HIST_MAX_SMEM / slab_bytes * SLAB;
  if (f_chunk > G) f_chunk = G;
  const int smem = (f_chunk + SLAB - 1) / SLAB * slab_bytes;
  // the largest size allowed so far, per device (set once, not a launch)
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        seg_hist_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  const dim3 grid(grid_x, (G + f_chunk - 1) / f_chunk);
  seg_hist_kernel<P><<<grid, SEG_THREADS, smem, stream>>>(
      bins, gh, seg, out, G, B, cap, f_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

LGBT_API int lgbt_segment_histogram(const uint8_t* bins, const float* gh,
                                    const int* seg, float* out, int G, int B,
                                    long long cap, int grid_x,
                                    cudaStream_t stream) {
  return launch_seg_hist<float>(bins, gh, seg, out, G, B, cap, grid_x,
                                stream);
}

LGBT_API int lgbt_segment_histogram_i8(const uint8_t* bins, const int8_t* codes,
                                       const int* seg, int* out, int G, int B,
                                       long long cap, int grid_x,
                                       cudaStream_t stream) {
  return launch_seg_hist<int8_t>(bins, codes, seg, out, G, B, cap, grid_x,
                                 stream);
}
