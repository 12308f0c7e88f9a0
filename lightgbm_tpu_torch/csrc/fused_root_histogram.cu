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
// Higgs root, 0.10 ms at 3.35 TB/s), against 3*G shared-memory integer
// atomics a row, which are what this first version waits on.
//
// Design: histogram.cuh's int8 loop, reading the codes from the
// [2, ncodes] input in segment order instead of the arena, and storing each
// to its arena column.  int32 accumulation: the result equals the plain
// version exactly.
#include "histogram.cuh"

LGBT_API int lgbt_fused_root_histogram(const uint8_t* bins, int8_t* arena_codes,
                                       const int8_t* codes, long long ncodes,
                                       const int* seg, int* out, int G, int B,
                                       long long cap, int grid_x,
                                       cudaStream_t stream) {
  const SegmentRows<int8_t> rows{bins, codes, ncodes, arena_codes, seg, cap};
  return launch_histogram(histogram_kernel<SegmentRows<int8_t>>, rows,
                          out, G, B, grid_x, stream);
}
