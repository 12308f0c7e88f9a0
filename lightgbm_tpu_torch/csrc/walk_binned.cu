// KP2: one tree walked over the bins, with the score update fused.
//
// Port-only: the JAX package walks a device tree over the binned rows with
// plain jnp (lightgbm_tpu/ops/grow.py predict_leaf_inner :856-901, a
// while_loop of gathers until every row rests at a leaf), for the
// out-of-bag rows' score update of a bagged round (models/gbdt.py
// :1095-1111) and each validation set's score (`_add_tree_score`,
// :2233-2243).  Its plain version here is ops/grow.predict_leaf_inner.
//
// One thread a row walks from the root until it reaches a leaf, so no
// depth is needed and the round that launches it reads nothing on the
// host.  A node decides as DecisionInner (tree.h:289-296): the row's bin
// of the node's inner feature is missing when the missing type is Zero and
// it is the feature's default bin, or NaN and it is the feature's last
// bin; a missing bin goes to the default side, any other bin left when
// bin <= threshold_bin.  A categorical node (CategoricalDecision,
// tree.h:259-273) sends the row left when its bin's bit is set in the
// node's set over bins, whatever the missing type: `cat_stride` bytes a
// node, 32 (256 bins) for uint8 bins and ceil(B / 8) for wider ones.  With EFB bundles the bins are group columns: the node's feature
// reads its group's column, and a value outside the feature's [lo, hi)
// range decodes to the feature's default bin, any other to value - shift
// (lightgbm_tpu/ops/grow.py:95-106).  Both are template flags, uniform
// across a launch, so a numerical tree over one column a feature runs the
// same code as before they existed.  A tree of one leaf puts every row in
// leaf 0.
// Modes:
// - leaf: leaf[row] = the row's leaf;
// - masked add: rows with leaf_ids[row] >= 0 (a bagged round's rows in
//   the bag, K4's set-mode leaf ids) add lv[leaf_ids[row]], the others
//   (out of the bag, -1) walk and add lv[leaf]: score[row] + lv[...],
//   one f32 add, as `score += lv[where(ids >= 0, ids, walked)]`;
// - add: every row walks and adds (a validation set's score).
// lv holds the values to add, already shrunk by the caller.
//
// The label engine's general grower widens it: bins uint16 (columns of
// more than 256 bins) and an f64 score with f64 leaf values
// (tpu_double_precision), template flags as CAT and BUNDLE are, so the
// uint8/f32 walk is the same code as before; an f64 add is one f64 add,
// score[row] + lv[...].
//
// What bounds it on an H100: bytes.  Each row's G bins are read once
// (a walk reads depth of them, but their 32-byte sectors are the row's),
// the score read and written once, the ids read once.  A simple kernel:
// the tree's tables are read through the read-only cache; staging them in
// shared memory is later work (ROADMAP queue 2).
#include "common.cuh"

namespace {

constexpr int WALK_THREADS = 256;
enum : int { MODE_LEAF = 0, MODE_MASKED_ADD = 1, MODE_ADD = 2 };

struct TreeT {
  const int* feature;          // [N] inner feature
  const int* threshold_bin;    // [N]
  const uint8_t* default_left; // [N] bool
  const int* missing_type;     // [N]
  const int* left;             // [N] left child (~leaf for a leaf)
  const int* right;            // [N] right child
  const int* num_leaves;       // 0-d, on the device
  int nodes;                   // N, the node slots
  const uint8_t* is_cat;       // [N] bool (categorical trees)
  const uint8_t* cat_bits;     // [N, cat_stride] bin bit sets, bit b of
                               // byte b/8
  int cat_stride;              // bytes of a node's bin set
};

struct BundleT {               // EFB maps, [F] each (bundled datasets)
  const int* col;              // the feature's group column
  const int* lo;               // its group-bin range [lo, hi)
  const int* hi;
  const int* shift;            // group bin = feature bin + shift
};

template <bool CAT, bool BUNDLE, typename Bn>
__device__ __forceinline__ int walk(const TreeT& t, const BundleT& e,
                                    const Bn* b,
                                    const int* __restrict__ num_bins,
                                    const int* __restrict__ default_bins,
                                    int num_leaves) {
  int node = num_leaves > 1 ? 0 : -1;
  // a tree of nl leaves has nl - 1 <= nodes internal nodes on any path
  for (int step = 0; node >= 0 && step < t.nodes; ++step) {
    const int f = __ldg(t.feature + node);
    int bin;
    if constexpr (BUNDLE) {
      const int v = b[__ldg(e.col + f)];
      bin = (v >= __ldg(e.lo + f) && v < __ldg(e.hi + f))
                ? v - __ldg(e.shift + f)
                : __ldg(default_bins + f);
    } else {
      bin = b[f];
    }
    bool left;
    if (CAT && __ldg(t.is_cat + node) != 0) {
      left = (unsigned)bin < 8u * (unsigned)t.cat_stride &&
             ((__ldg(t.cat_bits + (long long)node * t.cat_stride +
                     (bin >> 3)) >>
               (bin & 7)) & 1) != 0;
    } else {
      const int mt = __ldg(t.missing_type + node);
      const bool missing = (mt == 1 && bin == __ldg(default_bins + f)) ||
                           (mt == 2 && bin == __ldg(num_bins + f) - 1);
      left = missing ? __ldg(t.default_left + node) != 0
                     : bin <= __ldg(t.threshold_bin + node);
    }
    node = left ? __ldg(t.left + node) : __ldg(t.right + node);
  }
  return node < 0 ? ~node : 0;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <bool CAT, bool BUNDLE, typename Bn, typename S>
__global__ void __launch_bounds__(WALK_THREADS)
walk_binned_kernel(TreeT t, BundleT e, const Bn* __restrict__ bins,
                   long long n, int G, const int* __restrict__ num_bins,
                   const int* __restrict__ default_bins, int mode,
                   const S* __restrict__ lv,
                   const int* __restrict__ leaf_ids, int* __restrict__ leaf,
                   S* __restrict__ score) {
  const long long row = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (row >= n) return;
  int l = mode == MODE_MASKED_ADD ? leaf_ids[row] : -1;
  if (l < 0)
    l = walk<CAT, BUNDLE, Bn>(t, e, bins + row * G, num_bins, default_bins,
                              __ldg(t.num_leaves));
  if (mode == MODE_LEAF) {
    leaf[row] = l;
    return;
  }
  score[row] = add_rn(score[row], __ldg(lv + l));
}

template <typename Bn, typename S>
int launch_walk(const TreeT& t, const BundleT& e, const Bn* bins,
                long long n, int G, const int* num_bins,
                const int* default_bins, int mode, const S* lv,
                const int* leaf_ids, int* leaf, S* score,
                cudaStream_t stream) {
  const bool cat = t.is_cat != nullptr;
  const bool bundle = e.col != nullptr;
  const unsigned blocks =
      (unsigned)((n + WALK_THREADS - 1) / WALK_THREADS);
#define LGBT_WALK(C, B)                                                  \
  walk_binned_kernel<C, B, Bn, S><<<blocks, WALK_THREADS, 0, stream>>>(  \
      t, e, bins, n, G, num_bins, default_bins, mode, lv, leaf_ids, leaf, \
      score)
  if (cat && bundle)
    LGBT_WALK(true, true);
  else if (cat)
    LGBT_WALK(true, false);
  else if (bundle)
    LGBT_WALK(false, true);
  else
    LGBT_WALK(false, false);
#undef LGBT_WALK
  return (int)cudaGetLastError();
}

}  // namespace

// bins [n, G] row-major, uint8 (bin_bytes 1) or uint16 (2); the tree's
// node arrays [nodes]; num_bins, default_bins [F]; is_cat [nodes] and
// cat_bits [nodes, cat_stride] (or null: no categorical node); col, lo,
// hi, shift [F] (or null: one column a feature); leaf [n] int32 (leaf
// mode); lv [L], score [n] f32 (score_bytes 4) or f64 (8), leaf_ids [n]
// int32 (masked add).
LGBT_API int lgbt_walk_binned(
    const int* feature, const int* threshold_bin, const uint8_t* default_left,
    const int* missing_type, const int* left, const int* right,
    const int* num_leaves, int nodes, const uint8_t* is_cat,
    const uint8_t* cat_bits, int cat_stride, const int* col, const int* lo,
    const int* hi, const int* shift, const void* bins, int bin_bytes,
    long long n, int G, const int* num_bins, const int* default_bins,
    int mode, const void* lv, const int* leaf_ids, int* leaf, void* score,
    int score_bytes, cudaStream_t stream) {
  if (n <= 0 || nodes < 1 || mode < MODE_LEAF || mode > MODE_ADD ||
      (bin_bytes != 1 && bin_bytes != 2) ||
      (score_bytes != 4 && score_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const bool cat = is_cat != nullptr;
  const bool bundle = col != nullptr;
  if (cat != (cat_bits != nullptr) || (cat && cat_stride < 1) ||
      bundle != (lo != nullptr && hi != nullptr && shift != nullptr))
    return (int)cudaErrorInvalidValue;
  TreeT t{feature, threshold_bin, default_left, missing_type, left, right,
          num_leaves, nodes, is_cat, cat_bits, cat_stride};
  BundleT e{col, lo, hi, shift};
#define LGBT_LAUNCH(Bn, S)                                                 \
  launch_walk<Bn, S>(t, e, static_cast<const Bn*>(bins), n, G, num_bins,   \
                     default_bins, mode, static_cast<const S*>(lv),        \
                     leaf_ids, leaf, static_cast<S*>(score), stream)
  if (bin_bytes == 1)
    return score_bytes == 4 ? LGBT_LAUNCH(uint8_t, float)
                            : LGBT_LAUNCH(uint8_t, double);
  return score_bytes == 4 ? LGBT_LAUNCH(uint16_t, float)
                          : LGBT_LAUNCH(uint16_t, double);
#undef LGBT_LAUNCH
}
