// KP1: the raw-value ensemble walk of device prediction.
//
// Port-only: the JAX package predicts on the device with no Pallas kernel
// (lightgbm_tpu/ops/predict.py DeviceEnsemble, `_chunk_scores` :322-364),
// by a signature matmul laid out for the TPU's matrix unit: a dense
// [rows, T*N] decision tensor, a bf16 [T, L, N] path-signature tensor and
// one einsum per chunk, with thresholds compared in double-single f32.  On
// an H100 that is 2 rows T L N operations (about 6.7e13 for 1M rows of a
// 500-tree, 255-leaf model), while a walk reads about depth x T nodes a
// row from tables that stay in L1 and L2.  So this kernel walks, and
// compares and sums in f64 as the host walk does (models/tree.py
// Tree.predict_leaf_index), which it equals bit for bit.
//
// One thread a row walks the trees t < T in order.  A node decides as
// NumericalDecision / CategoricalDecision (tree.h:211-293, Tree.
// predict_leaf_index and _categorical_go_left):
// - numerical: a NaN is 0 unless the missing type is NaN; |v| <= 1e-35 is
//   "zero"; a missing value (zero with missing type Zero, NaN with
//   missing type NaN) goes to the default side; otherwise v <= threshold,
//   in f64;
// - categorical: the value truncated toward zero (static_cast<int>) is a
//   member of the node's bitset; NaN, negative ids and ids past the
//   bitset's words are non-members.
// Modes:
// - sum: out[c * ld + row] adds leaf values of the trees t with t % k == c
//   in tree order, one f64 add a tree (no multiply, so nothing to fuse);
//   k = 1 keeps the sum in a register;
// - sum with early stop (k = 1): before tree t, for t a positive multiple
//   of freq, the row stops once 2|sum| < margin fails (the host loop of
//   lightgbm_tpu/models/gbdt.py:1721-1747, NaN included);
// - leaf: leaf[row * T + t], int32.
//
// What bounds it on an H100: bytes.  X is read once (8 F bytes a row) and
// the output written once; the tables (21 bytes a node, 8 a leaf) are read
// by every row but stay in the caches.  A simple kernel comes first: the
// tables are read through the read-only cache (__ldg), nothing is staged
// in shared memory, and a row's features are read where its walk needs
// them.  Staging trees in shared memory and a warp a row block are later
// work (ROADMAP queue 2).
#include "common.cuh"

namespace {

constexpr int PREDICT_THREADS = 256;
constexpr double K_ZERO = 1e-35;
enum : int { MODE_SUM = 0, MODE_SUM_EARLY_STOP = 1, MODE_LEAF = 2 };

struct Ensemble {
  const int* node_off;       // [T+1] first node of each tree
  const int* leaf_off;       // [T+1] first leaf of each tree
  const int* cat_off;        // [T+1] first cat boundary of each tree
  const int* feature;        // [N] raw feature index
  const double* threshold;   // [N] threshold, or the cat_idx of a cat node
  const int8_t* decision;    // [N] decision_type bits
  const int* left;           // [N] left child (~leaf for a leaf)
  const int* right;          // [N] right child
  const double* leaf_value;  // [L]
  const int* cat_bound;      // [C] word offsets into cat_words
  const uint32_t* cat_words; // [W] bitset words
};

// The numerical test of node i with decision bits dec.
__device__ __forceinline__ bool go_left_num(const Ensemble& e, int i, int dec,
                                            double v) {
  const int mt = (dec >> 2) & 3;
  if (v != v && mt != 2) v = 0.0;
  const bool missing = (mt == 1 && fabs(v) <= K_ZERO) || (mt == 2 && v != v);
  if (missing) return (dec & 2) != 0;
  return v <= __ldg(e.threshold + i);
}

// The categorical test of node i of tree t.
__device__ __forceinline__ bool go_left_cat(const Ensemble& e, int t, int i,
                                            double v) {
  if (v != v) return false;
  const long long iv = (long long)v;      // toward zero, saturating
  if (iv < 0) return false;
  const int ci = (int)__ldg(e.threshold + i);
  const int b = __ldg(e.cat_off + t) + ci;
  const long long lo = __ldg(e.cat_bound + b);
  const long long hi = __ldg(e.cat_bound + b + 1);
  const long long word = lo + iv / 32;
  if (word >= hi) return false;
  return (__ldg(e.cat_words + word) >> (unsigned)(iv % 32)) & 1u;
}

// The leaf of tree t that row x reaches.  A walk takes at most the tree's
// node count of steps; the bound only guards a malformed table.
__device__ __forceinline__ int leaf_of(const Ensemble& e, const double* x,
                                       int t) {
  const int base = __ldg(e.node_off + t);
  const int nodes = __ldg(e.node_off + t + 1) - base;
  int node = nodes > 0 ? 0 : -1;
  for (int step = 0; node >= 0 && step < nodes; ++step) {
    const int i = base + node;
    const double v = x[__ldg(e.feature + i)];
    const int dec = __ldg(e.decision + i);
    const bool left = (dec & 1) ? go_left_cat(e, t, i, v)
                                : go_left_num(e, i, dec, v);
    node = left ? __ldg(e.left + i) : __ldg(e.right + i);
  }
  return node < 0 ? ~node : 0;
}

__global__ void __launch_bounds__(PREDICT_THREADS)
predict_ensemble_kernel(Ensemble e, const double* __restrict__ X,
                        long long n, int F, int T, int k, int mode, int freq,
                        double margin, double* __restrict__ out,
                        long long ld, int* __restrict__ leaf) {
  const long long row = (long long)blockIdx.x * PREDICT_THREADS + threadIdx.x;
  if (row >= n) return;
  const double* x = X + row * F;
  if (mode == MODE_LEAF) {
    int* dst = leaf + row * T;
    for (int t = 0; t < T; ++t) dst[t] = leaf_of(e, x, t);
    return;
  }
  if (k == 1) {
    double acc = 0.0;
    for (int t = 0; t < T; ++t) {
      if (mode == MODE_SUM_EARLY_STOP && t > 0 && t % freq == 0 &&
          !(2.0 * fabs(acc) < margin))
        break;
      const int l = leaf_of(e, x, t);
      acc = __dadd_rn(acc, __ldg(e.leaf_value + __ldg(e.leaf_off + t) + l));
    }
    out[row] = acc;
    return;
  }
  for (int c = 0; c < k; ++c) out[c * ld + row] = 0.0;
  for (int t = 0; t < T; ++t) {
    const int l = leaf_of(e, x, t);
    double* o = out + (t % k) * ld + row;
    *o = __dadd_rn(*o, __ldg(e.leaf_value + __ldg(e.leaf_off + t) + l));
  }
}

}  // namespace

// X [n, F] f64 row-major; T the trees walked (t < T); out [k, ld] f64 at
// its first row (sum modes) or leaf [n, T] int32 (leaf mode).
LGBT_API int lgbt_predict_ensemble(
    const int* node_off, const int* leaf_off, const int* cat_off,
    const int* feature, const double* threshold, const int8_t* decision,
    const int* left, const int* right, const double* leaf_value,
    const int* cat_bound, const uint32_t* cat_words, const double* X,
    long long n, int F, int T, int k, int mode, int freq, double margin,
    double* out, long long ld, int* leaf, cudaStream_t stream) {
  if (n <= 0 || T < 0 || k < 1 || mode < MODE_SUM || mode > MODE_LEAF ||
      (mode == MODE_SUM_EARLY_STOP && (k != 1 || freq < 1)))
    return (int)cudaErrorInvalidValue;
  Ensemble e{node_off, leaf_off,  cat_off, feature,   threshold, decision,
             left,     right,     leaf_value, cat_bound, cat_words};
  const long long blocks = (n + PREDICT_THREADS - 1) / PREDICT_THREADS;
  predict_ensemble_kernel<<<(unsigned)blocks, PREDICT_THREADS, 0, stream>>>(
      e, X, n, F, T, k, mode, freq, margin, out, ld, leaf);
  return (int)cudaGetLastError();
}
