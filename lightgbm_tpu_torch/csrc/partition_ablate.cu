// K8: the stage ablation of K3 (decision mode), for the f32 and the int8
// arena.
//
// Replaces: tools/kernel_ablate.py _kernel (:27, launched by run_stage,
// pl.pallas_call at :199), which compiles the TPU partition kernel stripped
// to a cumulative stage and times each, so that a redesign can see what
// each stage costs.  Here the stages are template instances of K3's own
// partition_kernel (partition.cuh), each one launch on K3's persistent
// grid with K3's ticket, cumulative:
//   0 read:     each tile's planes staged in shared memory (16-byte
//               cp.async copies), their words summed;
//   1 decide:   + each row's decision and the block scan of the flags;
//   2 lookback: + the status words and the decoupled look-back, the
//               staged flags and the wait for those the A run covers,
//               each row's destination column summed; the counts written
//               to sc;
//   3 stage:    + the output permutation in shared memory and the gather
//               of every output word from the staged tile, summed;
//   4 full:     + the coalesced stores: K3 itself.
// Stages 0-3 move no row and leave one checksum a tile in chk (uint32
// [tiles]), what ops/partition_kernel.partition_ablate_plain computes.
// The TPU stages `pbuild` and `matmul` exist because a TPU has no scatter
// (they build and apply one-hot permutation matrices); on Hopper their
// work is the stage and store stages.
//
// K3's production instances (partition_segment.cu) take the default stage;
// the stage instances exist only in this library.
//
// What bounds it: as K3, bytes: each row's planes read once and written
// once, 2n(G + 12) bytes f32, 2n(G + 6) int8.
#include "partition.cuh"

namespace {

template <typename P, int STAGE>
int launch_stage(const ArenaT<P>& a, int* sc, const uint8_t* goleft,
                 unsigned* state, long long state_len, long long max_rows,
                 int G, unsigned* chk, cudaStream_t stream) {
  if (STAGE < STAGE_STORE && chk == nullptr) return (int)cudaErrorInvalidValue;
  return launch_partition<P, DecisionRoute, false, PART_THREADS, STAGE>(
      a, sc, DecisionRoute{goleft}, state, state_len, max_rows, G,
      HistSink<P>{}, chk, stream);
}

template <typename P>
int launch_ablate(int stage, uint8_t* bins, P* gh, int* rid, long long cap,
                  int* sc, const uint8_t* goleft, unsigned* state,
                  long long state_len, long long max_rows, int G,
                  unsigned* chk, cudaStream_t stream) {
  const ArenaT<P> a{bins, gh, rid, cap};
  switch (stage) {
    case 0:
      return launch_stage<P, STAGE_READ>(a, sc, goleft, state, state_len,
                                         max_rows, G, chk, stream);
    case 1:
      return launch_stage<P, STAGE_DECIDE>(a, sc, goleft, state, state_len,
                                           max_rows, G, chk, stream);
    case 2:
      return launch_stage<P, STAGE_LOOKBACK>(a, sc, goleft, state, state_len,
                                             max_rows, G, chk, stream);
    case 3:
      return launch_stage<P, STAGE_GATHER>(a, sc, goleft, state, state_len,
                                           max_rows, G, chk, stream);
    case 4:
      return launch_stage<P, STAGE_STORE>(a, sc, goleft, state, state_len,
                                          max_rows, G, chk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

LGBT_API int lgbt_partition_ablate(int stage, uint8_t* bins, float* gh,
                                   int* rid, long long cap, int* sc,
                                   const uint8_t* goleft, unsigned* state,
                                   long long state_len, long long max_rows,
                                   int G, unsigned* chk, cudaStream_t stream) {
  return launch_ablate<float>(stage, bins, gh, rid, cap, sc, goleft, state,
                              state_len, max_rows, G, chk, stream);
}

LGBT_API int lgbt_partition_ablate_i8(int stage, uint8_t* bins, int8_t* codes,
                                      int* rid, long long cap, int* sc,
                                      const uint8_t* goleft, unsigned* state,
                                      long long state_len, long long max_rows,
                                      int G, unsigned* chk,
                                      cudaStream_t stream) {
  return launch_ablate<int8_t>(stage, bins, codes, rid, cap, sc, goleft,
                               state, state_len, max_rows, G, chk, stream);
}
