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
// The body lives in seg_hist.cuh, which K5 (fused_root_histogram.cu) takes
// with another payload source.
#include "seg_hist.cuh"

namespace {

template <typename P>
__global__ void __launch_bounds__(SEG_THREADS, 1024 / SEG_THREADS)
seg_hist_kernel(const uint8_t* __restrict__ bins,   // [G, cap]
                const P* __restrict__ gh,           // [2, cap]
                const int* __restrict__ seg,        // start, cnt
                typename HistAcc<P>::T* __restrict__ out,   // [G, B, 3]
                int G, int B, long long cap, int f_chunk) {
  const ArenaPayload<P> src{gh};
  seg_hist_body(bins, src, seg, out, G, B, cap, f_chunk);
}

template <typename P>
int launch_seg_hist(const uint8_t* bins, const P* gh, const int* seg,
                    typename HistAcc<P>::T* out, int G, int B, long long cap,
                    int grid_x, cudaStream_t stream) {
  if (!seg_hist_args_ok(bins, G, B, cap, grid_x))
    return (int)cudaErrorInvalidValue;
  static int smem_set[64] = {};
  int f_chunk = 0, smem = 0;
  const int err = seg_hist_shape<typename HistAcc<P>::T>(
      seg_hist_kernel<P>, smem_set, G, B, &f_chunk, &smem);
  if (err != 0) return err;
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
