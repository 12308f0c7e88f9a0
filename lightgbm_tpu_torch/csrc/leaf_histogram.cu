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
// Design: histogram.cuh's body with a row source that reads the leaf id of
// row i and, only for a row of the leaf, its payload and its F bins as
// byte loads from the row (F = 28 is not a multiple of 4, so no wider
// load is assumed).  The leaf is a device int32 scalar read once per
// block, so the label engine's best leaf never visits the host.  Accumulates
// f32 g/h in f32 (equal to the plain version up to reassociation) or int8
// codes in int32 (exact).  The leaf-id stream is read whole even for a
// small child: a compacted row list, warp pre-aggregation, TMA or wgmma are
// left to a later version.
#include "histogram.cuh"

namespace {

// The rows of leaf *leaf in a row-major [n, F] bin matrix.  P is the
// payload type (float g/h or int8 codes), L the leaf-id type (int32, -1
// out of the bag; or uint8, where 255 is never a leaf).
template <typename P, typename L>
struct LeafRows {
  using Acc = typename HistAcc<P>::T;
  const uint8_t* bins;   // [n, F]
  const P* g;            // [n]
  const P* h;            // [n]
  const L* leaf_ids;     // [n]
  const int* leaf;       // device scalar
  long long n;
  int F;

  struct Bound {
    const uint8_t* bins;
    const P* g;
    const P* h;
    const L* leaf_ids;
    long long n;
    int F;
    int leaf;

    __device__ __forceinline__ long long count() const { return n; }
    __device__ __forceinline__ bool load(long long i, int f0, Acc& gv, Acc& hv,
                                         const uint8_t*& bc) const {
      if ((int)__ldg(leaf_ids + i) != leaf) return false;
      gv = Acc(__ldg(g + i));
      hv = Acc(__ldg(h + i));
      bc = bins + i * F + f0;
      return true;
    }
    __device__ __forceinline__ int bin(const uint8_t* bc, int f) const {
      return __ldg(bc + f);
    }
  };
  __device__ __forceinline__ Bound bind() const {
    return Bound{bins, g, h, leaf_ids, n, F, *leaf};
  }
};

template <typename P, typename L>
__global__ void __launch_bounds__(HIST_THREADS)
leaf_histogram_kernel(LeafRows<P, L> rows,
                      typename HistAcc<P>::T* __restrict__ out, int G, int B,
                      int f_chunk) {
  histogram_pass(rows, out, G, B, f_chunk);
}

template <typename P, typename L>
int launch_leaf(const uint8_t* bins, const P* g, const P* h, const L* leaf_ids,
                const int* leaf, long long n, typename HistAcc<P>::T* out,
                int F, int B, int grid_x, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const LeafRows<P, L> rows{bins, g, h, leaf_ids, leaf, n, F};
  return launch_histogram(leaf_histogram_kernel<P, L>, rows, out, F, B, grid_x,
                          stream);
}

}  // namespace

// f32 g/h, int32 leaf ids (-1 out of the bag); out [F, B, 3] f32, zeroed.
LGBT_API int lgbt_leaf_histogram(const uint8_t* bins, const float* grad,
                                 const float* hess, const int* leaf_ids,
                                 const int* leaf, long long n, float* out,
                                 int F, int B, int grid_x,
                                 cudaStream_t stream) {
  return launch_leaf<float, int>(bins, grad, hess, leaf_ids, leaf, n, out, F,
                                 B, grid_x, stream);
}

// int8 g/h codes, uint8 leaf ids; out [F, B, 3] int32 code sums, zeroed.
LGBT_API int lgbt_leaf_histogram_i8(const uint8_t* bins, const int8_t* g_code,
                                    const int8_t* h_code,
                                    const uint8_t* leaf_ids, const int* leaf,
                                    long long n, int* out, int F, int B,
                                    int grid_x, cudaStream_t stream) {
  return launch_leaf<int8_t, uint8_t>(bins, g_code, h_code, leaf_ids, leaf, n,
                                      out, F, B, grid_x, stream);
}
