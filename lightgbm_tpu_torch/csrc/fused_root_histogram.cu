// K5: write a segment's quantized g/h codes into the arena and build its
// integer histogram, in one pass.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _fused_root_kernel
// (launched by fused_refresh_histogram, pl.pallas_call at :1168).  The
// grower calls it once per tree, on the root segment of a quantized tree:
// the root histogram covers every row whose codes the refresh writes, so
// the fusion saves the re-read of the codes and a launch.
//
// What bounds it on an H100: bytes.  Each row: G bin bytes and 2 code
// bytes read, 2 code bytes written (n*(G+4) bytes: 336 MB for the 10.5M-row
// Higgs root, 0.10 ms at 3.35 TB/s), against G shared-memory updates a row
// of three integer atomics each, which are what it waits on.
//
// Design: K2's int8 body (seg_hist.cuh: lanes as features, warps as
// 32-column chunks, two 16-byte bin loads a lane, 32-feature slabs whose
// atomics hit one bank a lane, the in-place transposed flush, blocks woken
// by the segment's count; segments of at most SMALL_ROWS rows a row a
// thread), with the FreshCodes payload source: the lane that loads column
// k's codes from the [2, ld] input in segment order also stores them to
// the arena's code planes at that column, and the codes reach the other
// lanes by the body's shuffles.  int32 accumulation: the result equals the
// plain version exactly.
#include "seg_hist.cuh"

namespace {

__global__ void __launch_bounds__(SEG_THREADS, 1024 / SEG_THREADS)
fused_root_kernel(const uint8_t* __restrict__ bins,   // [G, cap]
                  const int8_t* __restrict__ codes,   // [2, ld], segment order
                  long long ld,
                  int8_t* __restrict__ arena_codes,   // [2, cap]
                  const int* __restrict__ seg,        // start, cnt
                  int* __restrict__ out,              // [G, B, 3]
                  int G, int B, long long cap, int f_chunk) {
  const FreshCodes src{codes, ld, arena_codes};
  seg_hist_body(bins, src, seg, out, G, B, cap, f_chunk);
}

}  // namespace

LGBT_API int lgbt_fused_root_histogram(const uint8_t* bins, int8_t* arena_codes,
                                       const int8_t* codes, long long ncodes,
                                       const int* seg, int* out, int G, int B,
                                       long long cap, int grid_x,
                                       cudaStream_t stream) {
  if (!seg_hist_args_ok(bins, G, B, cap, grid_x))
    return (int)cudaErrorInvalidValue;
  static int smem_set[64] = {};
  int f_chunk = 0, smem = 0;
  const int err = seg_hist_shape<int>(fused_root_kernel, smem_set, G, B,
                                      &f_chunk, &smem);
  if (err != 0) return err;
  const dim3 grid(grid_x, (G + f_chunk - 1) / f_chunk);
  fused_root_kernel<<<grid, SEG_THREADS, smem, stream>>>(
      bins, codes, ncodes, arena_codes, seg, out, G, B, cap, f_chunk);
  return (int)cudaGetLastError();
}
