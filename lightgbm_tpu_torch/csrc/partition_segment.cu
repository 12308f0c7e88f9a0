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
// Design (partition.cuh's partition_kernel): one launch a partition, on a
// persistent grid.  Each block claims tiles of T rows with an atomic
// ticket, so tile t's predecessors were claimed, by running blocks, before
// it.  A block keeps a ring of two tiles in shared memory: while it
// finishes one, the next one's copies are in flight.  For each tile it
//   1. issues 16-byte cp.async copies of every plane of the tile's rows
//      into a slot of the ring, in two groups: the key plane (the
//      decision's channel; the G bin planes are [G, cap], so each plane's
//      tile is contiguous) and then all the others; the segment's
//      misalignment is kept as a shift;
//   2. once the key plane is in, decides each row (or reads the
//      predicate), block-scans the flags into the tile's A count and the
//      output permutation (A rows first, then B rows, each in row order),
//      and publishes the count in the tile's status word; this happens
//      before the block finishes the tile before it, so the tiles after it
//      can look back past it early;
//   3. once the whole tile is in, sets its staged flag, looks back over the
//      predecessors' status words for its A prefix (decoupled look-back:
//      one warp reads 32 words at a time, up to the nearest inclusive
//      prefix) and publishes its inclusive prefix; with HIST the block adds
//      the chosen stream's staged rows to the histogram;
//   4. waits until every tile of the segment whose columns its A run
//      covers is staged, then writes, for every plane, its A rows as one
//      run at dstA + prefixA and its B rows as one run at dstB + (t*T -
//      prefixA): threads store consecutive addresses, four columns aligned
//      to 4 at a time (a 4-byte word of a bin or int8 plane, 16 bytes of an
//      f32 or row-id plane), the run's unaligned head and tail a column at
//      a time.
// The last tile writes both counts to sc.  The ticket, the status words
// and the staged flags (`state`, int32 [1 + 2 * tiles]) are reset on the
// stream with cudaMemsetAsync before the launch.  The segment and the
// decision are read from the device vector sc, so the host launches a
// fixed grid and never learns a child's size.
//
// Stream A in place.  Stream A may be written over the segment itself
// (dstA == start, every split but the root's) or anywhere before it or
// disjoint from it: dstA <= start, or [dstA, dstA + cnt) disjoint from the
// segment; stream B must not overlap the segment.  Then tile t writes its
// A rows only inside [start, start + (t+1)T), since its A prefix is at
// most t*T: onto columns of tile t itself, which it has staged, or of
// tiles before it, whose staged flags it waits for (usually long set: at
// an even split tile t writes over tile t/2).  A tile sets its flag only
// after its whole tile is in shared memory (cp.async.wait_group 0, then a
// __syncthreads), with a release store that the waiting tile reads with an
// acquire load before its __syncthreads and its stores.  So every
// column tile t overwrites was already read: no scratch arena and no
// copy-back.  The waits cannot deadlock: a tile's flag waits only on its
// own copies and on the status words of tiles before it.  The 16-byte
// copies may read a few columns past the tile's rows, which a running
// tile may be writing; those bytes are never used.
//
// Tile sizes, against 227 KB of shared memory a block: a staged row costs
// G + 12 bytes with f32 g/h (G bins, 8 bytes of payload, a 4-byte row id)
// or G + 6 with codes, plus 2 bytes of permutation.  T = 1024 rows at 256
// threads (4 rows a thread) while the ring of two tiles leaves two blocks
// an SM (87 KB f32 at G=28, 73 KB int8), else 512 rows; on the H100, 256
// threads beat 512, and a 512-row ring at five blocks an SM (PERF.md).
// Pred mode with the histogram keeps one 512-row tile (22 KB at G=28),
// at 512 threads, beside the [G, B, 3] sub-histogram (85.7 KB at B=255):
// two blocks, 1024 threads, an SM.
// Features past what fits (G > 62 at B=255) are summed with global atomics
// from the staged tile, in place or not.
//
// The histogram (HIST): int32 atomics for codes (exact); f32 atomics for
// g/h, with the count word an int32 (smem_hist.cuh), equal to the plain
// version up to reassociation.  Each block adds its non-zero words into the
// zeroed global [G, B, 3] output once, after its last tile.
//
// What bounds it on an H100: bytes.  Each row (G bin bytes, 8 bytes of g/h
// or 2 of codes, a 4-byte row id) is read once and written once, and pred
// mode reads one predicate byte: 2*n*(G+12)+n or 2*n*(G+6)+n bytes, 0.25
// or 0.22 ms for the 10.5M-row Higgs root at 3.35 TB/s.  With HIST the 3*G
// shared-memory atomics of every histogrammed row add work that the bytes
// do not count.
#include "partition.cuh"

LGBT_API int lgbt_partition_segment(uint8_t* bins, float* gh, int* rid,
                                    long long cap, int* sc,
                                    const uint8_t* goleft, unsigned* state,
                                    long long state_len, long long max_rows,
                                    int G, cudaStream_t stream) {
  return launch_decision<float>(bins, gh, rid, cap, sc, goleft, state,
                                state_len, max_rows, G, stream);
}

LGBT_API int lgbt_partition_segment_i8(uint8_t* bins, int8_t* codes, int* rid,
                                       long long cap, int* sc,
                                       const uint8_t* goleft, unsigned* state,
                                       long long state_len,
                                       long long max_rows, int G,
                                       cudaStream_t stream) {
  return launch_decision<int8_t>(bins, codes, rid, cap, sc, goleft, state,
                                 state_len, max_rows, G, stream);
}

// Pred mode; hist == nullptr: no histogram, else the [G, B, 3] f32
// histogram of stream hist_stream (0: A, 1: B) is added into hist.
LGBT_API int lgbt_partition_segment_pred(uint8_t* bins, float* gh, int* rid,
                                         long long cap, int* sc,
                                         const uint8_t* pred,
                                         long long pred_len, unsigned* state,
                                         long long state_len,
                                         long long max_rows, int G,
                                         float* hist, int B, int hist_stream,
                                         cudaStream_t stream) {
  return launch_pred<float>(bins, gh, rid, cap, sc, pred, pred_len, state,
                            state_len, max_rows, G, hist, B, hist_stream,
                            stream);
}

// The same for an arena of int8 codes; the histogram is int32 code sums.
LGBT_API int lgbt_partition_segment_pred_i8(uint8_t* bins, int8_t* codes,
                                            int* rid, long long cap, int* sc,
                                            const uint8_t* pred,
                                            long long pred_len,
                                            unsigned* state,
                                            long long state_len,
                                            long long max_rows, int G,
                                            int* hist, int B, int hist_stream,
                                            cudaStream_t stream) {
  return launch_pred<int8_t>(bins, codes, rid, cap, sc, pred, pred_len, state,
                             state_len, max_rows, G, hist, B, hist_stream,
                             stream);
}
