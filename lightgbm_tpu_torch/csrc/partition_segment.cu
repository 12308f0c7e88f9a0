// K3: stable two-way partition of one arena segment, for an arena of f32
// g/h or of int8 codes, in two modes:
//   decision mode: rows whose bin on channel `chan` maps to goleft[bin] XOR
//     xr == 1 form stream A (the larger child), the others stream B (the
//     smaller child, written at the bump cursor dstB);
//   pred mode: rows whose column holds pred[col] != 0 form stream A (the
//     bagged root: in-bag rows), the others stream B (out-of-bag rows);
//     columns at or past the predicate's length read as 0, as the JAX
//     kernel reads its zero-padded [1, cap] predicate.  With a histogram
//     output, pred mode also builds the [G, B, 3] (sum g, sum h, count)
//     histogram of one stream (hist_stream 0: A, 1: B) in the same pass.
// Both streams keep the parent's row order and every plane moves with its
// row.
//
// Replaces: lightgbm_tpu/ops/partition_pallas.py _partition_kernel
// (launched by partition_segment, pl.pallas_call at :528): decision mode
// (mode=1), pred mode (mode=0, :229, :270-283, :374-376) and the fused
// hist_stream histogram (:248-259, :380-386, :505-525), which the grower
// runs once per bagged tree on the root (grow_partition.py:269-285).
//
// The TPU kernel writes stream A in place because its grid runs in order
// and writes provably lag reads; Hopper's blocks run in parallel, so that
// trick does not carry over.  Here:
//   1. count_kernel: each block counts the A rows of its contiguous chunk;
//   2. scatter_kernel: each block sums the counts of the blocks before it
//      (a one-block exclusive scan done redundantly per block, at most a
//      few thousand integers), then walks its chunk in 256-row tiles with a
//      ballot-based block scan and writes A rows to the scratch arena and
//      B rows straight to dstB; block 0 stores both counts in sc;
//   3. copy_back_kernel: copies the A rows from the scratch arena to dstA,
//      which may be the parent's own start.
// The segment and the decision are read from the device vector sc, so the
// host launches a fixed grid and never learns a child's size.  One body
// serves both modes: the kernels are templated on the router (a go-left
// mask over a channel, or the predicate) and on HIST.
//
// The histogram (HIST): scatter_kernel already reads every plane of every
// row, so each block adds the chosen stream's rows into a [f_chunk, B, 3]
// sub-histogram in dynamic shared memory with histogram.cuh's accumulator
// (int32 atomics for codes: exact; f32 atomics for g/h: equal to the plain
// version up to reassociation), then adds its non-zero entries into the
// zeroed global [G, B, 3] output with global atomics.  f_chunk is the
// number of features whose [B, 3] rows fit in HIST_MAX_SMEM (200 KB): at
// B=255 that is 66 features, so the Higgs width (G=28, 85.7 KB) is one
// chunk.  A wider G is not refused: after the moving pass, the block walks
// its rows again once per further chunk of f_chunk features (the source
// rows are still in place: stream A went to the scratch arena, stream B
// past the segment), so each row's decision is re-read and its bins of
// that chunk accumulated.
//
// What bounds it on an H100: bytes.  Each row (G bin bytes, 8 bytes of g/h
// or 2 of codes, a 4-byte row id) is read once and written once, and pred
// mode reads one predicate byte: 2*n*(G+12)+n or 2*n*(G+6)+n bytes, 0.25
// or 0.22 ms for the 10.5M-row Higgs root at 3.35 TB/s.  This version
// moves the stream-A rows twice (through the scratch arena), writes single
// bytes per plane, and with HIST adds 3*G shared-memory atomics per
// histogrammed row and a flush of each block's sub-histogram, so it is not
// at that bound; pred mode runs 264 blocks (two a Hopper SM holds with an
// 85.7 KB sub-histogram each), which bounds the flush to 264 times [G,B,3]
// global atomics.
#include "partition.cuh"

LGBT_API int lgbt_partition_segment(uint8_t* bins, float* gh, int* rid,
                                    long long cap, uint8_t* sbins, float* sgh,
                                    int* srid, long long scap, int* sc,
                                    const uint8_t* goleft, int* block_a,
                                    int nblocks, int G, cudaStream_t stream) {
  return launch_decision<float>(bins, gh, rid, cap, sbins, sgh, srid, scap, sc,
                                goleft, block_a, nblocks, G, stream);
}

LGBT_API int lgbt_partition_segment_i8(uint8_t* bins, int8_t* codes, int* rid,
                                       long long cap, uint8_t* sbins,
                                       int8_t* scodes, int* srid,
                                       long long scap, int* sc,
                                       const uint8_t* goleft, int* block_a,
                                       int nblocks, int G,
                                       cudaStream_t stream) {
  return launch_decision<int8_t>(bins, codes, rid, cap, sbins, scodes, srid,
                                 scap, sc, goleft, block_a, nblocks, G,
                                 stream);
}

// Pred mode; hist == nullptr: no histogram, else the [G, B, 3] f32
// histogram of stream hist_stream (0: A, 1: B) is added into hist.
LGBT_API int lgbt_partition_segment_pred(uint8_t* bins, float* gh, int* rid,
                                         long long cap, uint8_t* sbins,
                                         float* sgh, int* srid, long long scap,
                                         int* sc, const uint8_t* pred,
                                         long long pred_len, int* block_a,
                                         int nblocks, int G, float* hist,
                                         int B, int hist_stream,
                                         cudaStream_t stream) {
  return launch_pred<float>(bins, gh, rid, cap, sbins, sgh, srid, scap, sc,
                            pred, pred_len, block_a, nblocks, G, hist, B,
                            hist_stream, stream);
}

// The same for an arena of int8 codes; the histogram is int32 code sums.
LGBT_API int lgbt_partition_segment_pred_i8(uint8_t* bins, int8_t* codes,
                                            int* rid, long long cap,
                                            uint8_t* sbins, int8_t* scodes,
                                            int* srid, long long scap, int* sc,
                                            const uint8_t* pred,
                                            long long pred_len, int* block_a,
                                            int nblocks, int G, int* hist,
                                            int B, int hist_stream,
                                            cudaStream_t stream) {
  return launch_pred<int8_t>(bins, codes, rid, cap, sbins, scodes, srid, scap,
                             sc, pred, pred_len, block_a, nblocks, G, hist, B,
                             hist_stream, stream);
}
