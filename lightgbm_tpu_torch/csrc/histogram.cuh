// What the port's histogram kernels share: the accumulator type of a
// payload and the shared-memory budget of one block.  K2 and K5
// (seg_hist.cuh), K7 (leaf_histogram.cu, smem_hist.cuh) and K3's pred mode
// (partition.cuh) each accumulate a block's sub-histogram in shared memory
// and add it to a zeroed global [G, B, 3] output with global atomics.
//
// Payload P and accumulator A: f32 g/h summed in f32 (the order of the
// atomics varies run to run, so sums agree with the plain version to f32
// reassociation), f64 g/h summed in f64 (K7 only, the label engine's f64
// path; agreement to f64 reassociation), or int8 codes summed in int32
// (integer atomics are order-independent, so the result is exact).
#pragma once

#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 512;
constexpr int HIST_MAX_SMEM = 200 * 1024;

template <typename P> struct HistAcc;
template <> struct HistAcc<float> { using T = float; };
template <> struct HistAcc<double> { using T = double; };
template <> struct HistAcc<int8_t> { using T = int; };

}  // namespace
