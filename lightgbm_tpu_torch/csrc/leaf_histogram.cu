// K7: (sum g, sum h, count) histogram of the rows of one leaf, over the
// label engine's row-major bins.
//
// Replaces: lightgbm_tpu/ops/histogram_pallas.py _hist_kernel (:92,
// launched by leaf_histogram, pl.pallas_call at :156) and _hist_kernel_q
// (:112, launched by leaf_histogram_quantized at :211).  The TPU kernels
// have no fast scatter: they factor each bin over a radix pair and
// contract one-hot planes on the MXU, with the leaf_ids == leaf mask fused
// into the payload, over all n rows.  On Hopper a shared-memory atomicAdd
// is the scatter, so this kernel computes the function and drops the
// radix layout.
//
// What bounds it on an H100: bytes.  Every row's leaf id is read (4 bytes,
// or 1 in int8 mode); only the m rows of the leaf read their F bin bytes
// and their payload (8 bytes of f32 g/h, or 2 of int8 codes); the [F, B, 3]
// histogram is written once: 4n + m(F+8) + 12FB bytes, or n + m(F+2) +
// 12FB.  For the 10.5M-row Higgs root (m = n, F = 28, B = 255) that is
// 0.125 ms (f32) or 0.097 ms (int8) at 3.35 TB/s; for a 40k-row child it
// is the leaf-id stream, 0.013 or 0.0035 ms.
//
// Design: two kernels after a 4-byte cudaMemsetAsync of the list's count,
// all on the caller's stream; the leaf is a device int32 scalar, so the
// label engine's best leaf never visits the host.
//   1. select (leaf_select_kernel): streams the leaf ids with 16-byte
//      loads (four int32 ids, or sixteen uint8 ids), four (two) loads in
//      flight a thread, and appends the matching row indices to a device row list
//      (int32 [n], the caller's workspace), one atomicAdd a warp for all
//      its matches of an iteration (none when the warp has none).  A warp
//      gathers its matches in shared memory in row order and stores them
//      to consecutive words: the accumulate pass then reads neighbouring
//      rows together (rows 16 apart made its int8 root pass 45% slower)
//      and the stores are coalesced (a lane storing its own run made the
//      select slow).  The order of the warps' runs is free: int32 sums are
//      exact and f32 sums agree to reassociation.  The ids before the first 16-byte boundary and after
//      the last one are matched one at a time.
//   2. accumulate (leaf_accumulate_kernel): reads only the m listed rows;
//      block b works only while b*R < m (R = rows a block takes at a time),
//      so a 40,568-row leaf wakes 80 blocks and leaf -2 (the grower's `done`
//      leaf, which no row holds) none: the zeroed output stays zero.  Each
//      working block zeroes a [f_chunk, B, 3] sub-histogram in shared
//      memory, adds its rows with shared atomics (smem_hist.cuh: an int32
//      count word), and adds its non-zero words into the output with
//      global atomics.  A row's F bins are read as 4-byte words when F is
//      a multiple of 4 (the feature chunk then is one too; the bin matrix
//      must be 4-byte aligned, as a tensor's own storage is), else as
//      bytes.
//      gridDim.y splits the features when the sub-histogram would exceed
//      one block's shared memory.
// f32 g/h are summed in f32 (equal to the plain version up to
// reassociation), int8 codes in int32 (exact).  In int8 mode the ids are
// uint8 and 255 is never a leaf.
//
// Wider forms, for the label engine's general grower: bins uint16 (a
// column of more than 256 bins, max_bin up to 1024 here, as K1 takes), and
// an f64 payload summed in f64 (tpu_double_precision).  The accumulate
// kernel is a template on both; a row's bins are then read a feature at a
// time (the 4-byte loads stay the uint8 form's), and the feature chunk is
// sized from B and the accumulator's width: at B = 1024 a feature of f64
// takes 24 KB of shared memory, so a block holds 8.  The uint8/f32 and
// int8 forms are the same code as before.  What bounds the wider forms is
// bytes too: 4n + m(2F+8) + 12FB (uint16) and 4n + m(F+16) + 24FB (f64).
#include "smem_hist.cuh"

namespace {

constexpr int SELECT_THREADS = 256;
constexpr int SELECT_UNROLL = 4;   // 16-byte loads in flight a thread
                                   // (half with uint8 ids: 16 ids a load)
constexpr int SELECT_BLOCKS_PER_SM = 8;

// Element e of a 16-byte vector of ids, as an int.
template <typename L>
__device__ __forceinline__ int id_at(const uint4& v, int e);
template <>
__device__ __forceinline__ int id_at<int>(const uint4& v, int e) {
  const unsigned w = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  return (int)w;
}
template <>
__device__ __forceinline__ int id_at<uint8_t>(const uint4& v, int e) {
  const int k = e >> 2;
  const unsigned w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  return (int)((w >> (8 * (e & 3))) & 255u);
}

template <typename L>
__global__ void __launch_bounds__(SELECT_THREADS)
leaf_select_kernel(const L* __restrict__ ids, const int* __restrict__ leaf,
                   long long n, int* __restrict__ rows,
                   int* __restrict__ count) {
  constexpr int VE = 16 / (int)sizeof(L);
  constexpr int U = sizeof(L) == 1 ? SELECT_UNROLL / 2 : SELECT_UNROLL;
  constexpr int CHUNK = 32 * U * VE;           // ids a warp takes at once
  __shared__ int staged[SELECT_THREADS / 32][CHUNK];
  int* wb = staged[threadIdx.x >> 5];
  const int lf = *leaf;
  // the aligned body [head, head + nvec * VE), vector by vector
  long long head = (long long)((16 - ((uintptr_t)ids & 15)) & 15) /
                   (long long)sizeof(L);
  if (head > n) head = n;
  const long long nvec = (n - head) / VE;
  const long long tail0 = head + nvec * VE;
  const uint4* vec = reinterpret_cast<const uint4*>(ids + head);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (SELECT_THREADS / 32);
  const long long wid = (long long)blockIdx.x * (SELECT_THREADS / 32) +
                        (threadIdx.x >> 5);
  for (long long base = wid * 32 * U; base < nvec; base += warps * 32 * U) {
    uint4 v[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = base + lane + 32 * u;
      ok[u] = k < nvec;
      if (ok[u]) v[u] = __ldg(vec + k);
    }
    // the warp's matches into its shared buffer in row order (vector u,
    // then lane, then id): the accumulate pass then reads neighbouring rows
    // together
    int total = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int c = 0;
#pragma unroll
      for (int e = 0; e < VE; ++e) c += ok[u] && id_at<L>(v[u], e) == lf;
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      int at = total + incl - c;
      const long long row0 = head + (base + lane + 32 * u) * VE;
#pragma unroll
      for (int e = 0; e < VE; ++e)
        if (ok[u] && id_at<L>(v[u], e) == lf) wb[at++] = (int)(row0 + e);
      total += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (total == 0) continue;
    __syncwarp();
    int pos = 0;
    if (lane == 0) pos = atomicAdd(count, total);
    pos = __shfl_sync(0xffffffffu, pos, 0);
    for (int j = lane; j < total; j += 32) rows[pos + j] = wb[j];
    __syncwarp();                                // the buffer is reused
  }
  // the unaligned head and tail, fewer than VE ids each
  if (blockIdx.x == 0 && threadIdx.x < 2 * VE) {
    const bool in_head = threadIdx.x < VE;
    const long long i = in_head ? threadIdx.x : tail0 + threadIdx.x - VE;
    if ((in_head ? i < head : i < n) && (int)ids[i] == lf)
      rows[atomicAdd(count, 1)] = (int)i;
  }
}

template <typename P, typename Bn>
__global__ void __launch_bounds__(HIST_THREADS)
leaf_accumulate_kernel(const Bn* __restrict__ bins,
                       const P* __restrict__ g, const P* __restrict__ h,
                       const int* __restrict__ rows,
                       const int* __restrict__ count,
                       typename HistAcc<P>::T* __restrict__ out, int F, int B,
                       int f_chunk, int R, bool quads) {
  using A = typename HistAcc<P>::T;
  const long long m = *count;
  if ((long long)blockIdx.x * R >= m) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);   // [f_chunk, B, 3]
  const int f0 = blockIdx.y * f_chunk;
  const int nf = min(f_chunk, F - f0);
  const int words = nf * B * 3;
  hist_zero(sh, words);
  __syncthreads();
  for (long long base = (long long)blockIdx.x * R; base < m;
       base += (long long)gridDim.x * R) {
    const long long hi = min(base + R, m);
    for (long long i = base + threadIdx.x; i < hi; i += blockDim.x) {
      const long long r = __ldg(rows + i);
      const A gv = A(__ldg(g + r));
      const A hv = A(__ldg(h + r));
      const Bn* b = bins + r * F + f0;
      if (sizeof(Bn) == 1 && quads) {
        const unsigned* bw = reinterpret_cast<const unsigned*>(b);
        for (int q = 0; q < nf / 4; ++q) {
          const unsigned w = __ldg(bw + q);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            hist_add(sh + ((4 * q + k) * B + ((w >> (8 * k)) & 255u)) * 3, gv,
                     hv);
        }
      } else {
        for (int f = 0; f < nf; ++f)
          hist_add(sh + (f * B + __ldg(b + f)) * 3, gv, hv);
      }
    }
  }
  __syncthreads();
  hist_flush(sh, out + (size_t)f0 * B * 3, words);
}

template <typename P, typename L, typename Bn = uint8_t>
int launch_leaf(const Bn* bins, const P* g, const P* h, const L* leaf_ids,
                const int* leaf, long long n, typename HistAcc<P>::T* out,
                int F, int B, int* rows, int* count, int grid_x, int R,
                cudaStream_t stream) {
  using A = typename HistAcc<P>::T;
  // uint8 bins take B <= 256 (their values); uint16 bins up to 1024
  if (n < 0 || F < 1 || B < 1 || B > (sizeof(Bn) == 1 ? 256 : 1024) ||
      grid_x < 1 || R < 1 || rows == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  static int select_blocks = 0;
  if (select_blocks == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    select_blocks = sms * SELECT_BLOCKS_PER_SM;
  }
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  leaf_select_kernel<L><<<select_blocks, SELECT_THREADS, 0, stream>>>(
      leaf_ids, leaf, n, rows, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 4-byte bin loads: F a multiple of 4 on a 4-byte aligned matrix, and
  // then every feature chunk a multiple of 4 too
  const bool quads =
      sizeof(Bn) == 1 && (F & 3) == 0 && ((uintptr_t)bins & 3) == 0;
  int f_chunk = HIST_MAX_SMEM / (B * 3 * (int)sizeof(A));
  if (quads) f_chunk &= ~3;
  if (f_chunk > F) f_chunk = F;
  const int smem = f_chunk * B * 3 * (int)sizeof(A);
  err = cudaFuncSetAttribute(leaf_accumulate_kernel<P, Bn>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_x, (F + f_chunk - 1) / f_chunk);
  leaf_accumulate_kernel<P, Bn><<<grid, HIST_THREADS, smem, stream>>>(
      bins, g, h, rows, count, out, F, B, f_chunk, R, quads);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 g/h, int32 leaf ids (-1 out of the bag); out [F, B, 3] f32, zeroed;
// rows int32 [n] and count int32 [1]: the row list's workspace.
LGBT_API int lgbt_leaf_histogram(const uint8_t* bins, const float* grad,
                                 const float* hess, const int* leaf_ids,
                                 const int* leaf, long long n, float* out,
                                 int F, int B, int* rows, int* count,
                                 int grid_x, int R, cudaStream_t stream) {
  return launch_leaf<float, int>(bins, grad, hess, leaf_ids, leaf, n, out, F,
                                 B, rows, count, grid_x, R, stream);
}

// int8 g/h codes, uint8 leaf ids; out [F, B, 3] int32 code sums, zeroed.
LGBT_API int lgbt_leaf_histogram_i8(const uint8_t* bins, const int8_t* g_code,
                                    const int8_t* h_code,
                                    const uint8_t* leaf_ids, const int* leaf,
                                    long long n, int* out, int F, int B,
                                    int* rows, int* count, int grid_x, int R,
                                    cudaStream_t stream) {
  return launch_leaf<int8_t, uint8_t>(bins, g_code, h_code, leaf_ids, leaf, n,
                                      out, F, B, rows, count, grid_x, R,
                                      stream);
}

// The label engine's wider forms (int32 leaf ids, out zeroed):
// uint16 bins with f32 g/h (out f32), uint8 bins with f64 g/h (out f64),
// and uint16 bins with f64 g/h.
LGBT_API int lgbt_leaf_histogram_u16(const uint16_t* bins, const float* grad,
                                     const float* hess, const int* leaf_ids,
                                     const int* leaf, long long n, float* out,
                                     int F, int B, int* rows, int* count,
                                     int grid_x, int R, cudaStream_t stream) {
  return launch_leaf<float, int, uint16_t>(bins, grad, hess, leaf_ids, leaf,
                                           n, out, F, B, rows, count, grid_x,
                                           R, stream);
}

LGBT_API int lgbt_leaf_histogram_f64(const uint8_t* bins, const double* grad,
                                     const double* hess, const int* leaf_ids,
                                     const int* leaf, long long n,
                                     double* out, int F, int B, int* rows,
                                     int* count, int grid_x, int R,
                                     cudaStream_t stream) {
  return launch_leaf<double, int, uint8_t>(bins, grad, hess, leaf_ids, leaf,
                                           n, out, F, B, rows, count, grid_x,
                                           R, stream);
}

LGBT_API int lgbt_leaf_histogram_u16_f64(
    const uint16_t* bins, const double* grad, const double* hess,
    const int* leaf_ids, const int* leaf, long long n, double* out, int F,
    int B, int* rows, int* count, int grid_x, int R, cudaStream_t stream) {
  return launch_leaf<double, int, uint16_t>(bins, grad, hess, leaf_ids, leaf,
                                            n, out, F, B, rows, count,
                                            grid_x, R, stream);
}
