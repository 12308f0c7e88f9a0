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
// against 3*G shared-memory atomics a row.  The atomics, not the bytes, are
// what this first version waits on.
//
// Design: histogram.cuh.  The int8 mode accumulates int32, so the card's
// result equals the plain version exactly; the f32 mode agrees with it to
// f32 reassociation.
#include "histogram.cuh"

LGBT_API int lgbt_segment_histogram(const uint8_t* bins, const float* gh,
                                    const int* seg, float* out, int G, int B,
                                    long long cap, int grid_x,
                                    cudaStream_t stream) {
  const SegmentRows<float, false> rows{bins, gh, cap, nullptr, seg, cap};
  return launch_histogram(histogram_kernel<SegmentRows<float, false>>, rows,
                          out, G, B, grid_x, stream);
}

LGBT_API int lgbt_segment_histogram_i8(const uint8_t* bins, const int8_t* codes,
                                       const int* seg, int* out, int G, int B,
                                       long long cap, int grid_x,
                                       cudaStream_t stream) {
  const SegmentRows<int8_t, false> rows{bins, codes, cap, nullptr, seg, cap};
  return launch_histogram(histogram_kernel<SegmentRows<int8_t, false>>, rows,
                          out, G, B, grid_x, stream);
}
