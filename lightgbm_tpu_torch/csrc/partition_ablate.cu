// K8: the stage ablation of K3 (decision mode), for the f32 and the int8
// arena.
//
// Replaces: tools/kernel_ablate.py _kernel (:27, launched by run_stage,
// pl.pallas_call at :199), which compiles the TPU partition kernel stripped
// to a cumulative stage and times each, so that a redesign can see what
// each stage costs.  Here the stages are template instances of K3's own
// scatter_kernel (partition.cuh), cumulative:
//   0 read:    scatter_kernel<STAGE_READ> reads every plane of each row of
//              its chunk and leaves a checksum (no count pass);
//   1 decide:  + the router: count_kernel, and scatter_kernel<STAGE_DECIDE>
//              adds each row's decision to the checksum;
//   2 scan:    + scatter_kernel<STAGE_SCAN>: the block-offset scan over the
//              block counts and the ballot block scan per 256-row tile,
//              each row's destination summed into the checksum;
//   3 scatter: + the stores of stream A to the scratch arena and of stream
//              B to dstB: count_kernel and K3's own scatter_kernel;
//   4 full:    + copy_back_kernel: K3 itself (partition.cuh's launch).
// The TPU stages `pbuild` and `matmul` exist because a TPU has no scatter
// (they build and apply one-hot permutation matrices); on Hopper their work
// is the scatter stage.  The checksums land in the scratch row-id plane,
// which stages 0-2 never write otherwise.
//
// K3's production instances (partition_segment.cu) take the default stage
// and compile to the kernels they were before this file existed; the stage
// instances exist only in this library.
//
// What bounds it: as K3, bytes: each row's planes read once and written
// once, 2n(G + 12) bytes f32, 2n(G + 6) int8.
#include "partition.cuh"

namespace {

template <typename P, int STAGE>
int launch_stage(const ArenaT<P>& a, const ArenaT<P>& s, int* sc,
                 const DecisionRoute& route, int* block_a, int nblocks, int G,
                 cudaStream_t stream) {
  if (STAGE != STAGE_READ) {
    count_kernel<DecisionRoute><<<nblocks, PART_THREADS, 0, stream>>>(
        sc, route, block_a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scatter_kernel<P, DecisionRoute, false, STAGE>
      <<<nblocks, PART_THREADS, 0, stream>>>(a, s, sc, route, block_a, G,
                                             HistSink<P>{});
  return (int)cudaGetLastError();
}

template <typename P>
int launch_ablate(int stage, uint8_t* bins, P* gh, int* rid, long long cap,
                  uint8_t* sbins, P* sgh, int* srid, long long scap, int* sc,
                  const uint8_t* goleft, int* block_a, int nblocks, int G,
                  cudaStream_t stream) {
  if (G < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const ArenaT<P> a{bins, gh, rid, cap};
  const ArenaT<P> s{sbins, sgh, srid, scap};
  const DecisionRoute route{bins, cap, goleft};
  switch (stage) {
    case 0:
      return launch_stage<P, STAGE_READ>(a, s, sc, route, block_a, nblocks, G,
                                         stream);
    case 1:
      return launch_stage<P, STAGE_DECIDE>(a, s, sc, route, block_a, nblocks,
                                           G, stream);
    case 2:
      return launch_stage<P, STAGE_SCAN>(a, s, sc, route, block_a, nblocks, G,
                                         stream);
    case 3:
      return launch_stage<P, STAGE_MOVE>(a, s, sc, route, block_a, nblocks, G,
                                         stream);
    case 4:
      return launch<P, DecisionRoute, false>(a, s, sc, route, block_a, nblocks,
                                             G, HistSink<P>{}, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

LGBT_API int lgbt_partition_ablate(int stage, uint8_t* bins, float* gh,
                                   int* rid, long long cap, uint8_t* sbins,
                                   float* sgh, int* srid, long long scap,
                                   int* sc, const uint8_t* goleft,
                                   int* block_a, int nblocks, int G,
                                   cudaStream_t stream) {
  return launch_ablate<float>(stage, bins, gh, rid, cap, sbins, sgh, srid,
                              scap, sc, goleft, block_a, nblocks, G, stream);
}

LGBT_API int lgbt_partition_ablate_i8(int stage, uint8_t* bins, int8_t* codes,
                                      int* rid, long long cap, uint8_t* sbins,
                                      int8_t* scodes, int* srid, long long scap,
                                      int* sc, const uint8_t* goleft,
                                      int* block_a, int nblocks, int G,
                                      cudaStream_t stream) {
  return launch_ablate<int8_t>(stage, bins, codes, rid, cap, sbins, scodes,
                               srid, scap, sc, goleft, block_a, nblocks, G,
                               stream);
}
