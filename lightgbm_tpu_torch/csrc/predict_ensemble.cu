// KP1: the raw-value ensemble walk of device prediction.
//
// Port-only: the JAX package predicts on the device with no Pallas kernel
// (lightgbm_tpu/ops/predict.py DeviceEnsemble, `_chunk_scores` :322-364),
// by a signature matmul laid out for the TPU's matrix unit: a dense
// [rows, T*N] decision tensor, a bf16 [T, L, N] path-signature tensor and
// one einsum per chunk, with thresholds compared in double-single f32.  On
// an H100 that is 2 rows T L N operations (about 6.7e13 for 1M rows of a
// 500-tree, 255-leaf model), while a walk visits about depth x T nodes a
// row.  So this kernel walks, and compares and sums in f64 as the host
// walk does (models/tree.py Tree.predict_leaf_index), which it equals bit
// for bit.
//
// A node decides as NumericalDecision / CategoricalDecision (tree.h:
// 211-293, Tree.predict_leaf_index and _categorical_go_left):
// - numerical: a NaN is 0 unless the missing type is NaN; |v| <= 1e-35 is
//   "zero"; a missing value (zero with missing type Zero, NaN with
//   missing type NaN) goes to the default side; otherwise v <= threshold,
//   in f64;
// - categorical: the value truncated toward zero (static_cast<int>) is a
//   member of the node's bitset; NaN, negative ids and ids past the
//   bitset's words are non-members.
// X is f32 or f64; an f32 value is widened to f64 where it is compared,
// which is exact, so both compare the values the host walk compares.
// Modes:
// - sum: out[c * ld + row] adds leaf values of the trees t with t % k == c
//   in tree order, one f64 add a tree (no multiply, so nothing to fuse);
//   k = 1 keeps the sum in a register;
// - sum with early stop: before the first tree t = it * k of iteration
//   it > 0, it a multiple of period = ceil(freq / k) iterations, the row
//   stops once its margin < margin fails (the host loop of
//   lightgbm_tpu/models/gbdt.py:1721-1747, whose counter advances k an
//   iteration and resets at each test; NaN included): the margin is
//   2|sum| for k = 1, and for k > 1 the row's largest class sum less its
//   second largest (a tie gives 0), read back from out, which the row's
//   thread alone writes;
// - leaf: leaf[row * T + t], int32.
//
// The tables (ops/predict.py build_tables): every tree in preorder, one
// 16-byte item a node or leaf: {f64 threshold or leaf value; int32 meta;
// int32 right child}.  An internal node's meta holds its raw feature
// (bits 0-23) and decision bits (24-31), a leaf's its leaf id with bit 31
// set; the left child of an internal node is the next item.  Trees come
// in groups of consecutive trees; the caller sizes the groups and passes
// stage_items, the items of the largest group a stage holds, which fixes
// a stage's shared memory (a ring of two such stages must fit a block).
//
// What bounds it on an H100: not bytes (X read once, the output written
// once, the tables once: 0.07 ms for 1M f64 rows of a 500-tree model),
// but the walk: about 3,400-6,000 node visits a row, each a dependent
// chain of a node load, a feature load and an f64 compare.  The first
// version read both through L1 and L2, one thread a row; its rows' X
// outgrew L1 at 1M rows, and every visit fetched its node again.  The
// design:
// - X read once: a block takes a tile of W * RPT rows (W walking threads,
//   TILE_THREADS, or fewer where n rows would leave SMs without a tile:
//   tile_walkers) and stores their features, in X's own width,
//   transposed into shared
//   memory ([feature][row], so the lanes of a warp read distinct banks
//   whatever feature each reads); a model reading more features than fit
//   reads X through L1 instead (template XS);
// - trees in shared memory by groups: a producer warp copies group g into
//   stage g % stages of a ring (TMA bulk copies completing on the stage's
//   mbarrier); each walking warp waits for its group's stage and releases
//   it when done, so no block barrier makes a group wait for the deepest
//   walk of the tile, and warps drift apart by up to the ring; a group
//   too large for a stage is walked from global memory in the same loop;
// - latency hidden by independent walks: each thread interleaves
//   RPT rows x TPS trees (4 walks), whose node and feature loads overlap;
//   the leaf values are added afterwards, per row in tree order;
// - small batches (predict_small): when n rows cannot fill the card, one
//   thread walks one (tree, row) pair from global memory and stores the
//   leaf value in [T, n]; a second kernel sums each row's values in tree
//   order (early stop as above), so a one-row request walks its trees in
//   parallel instead of one thread's thousands of dependent steps.
// Measured on an H100 (PERF.md, KP1): about 0.005 ns a visit card-wide
// (2.1e11 visits/s, about one visit a cycle and SM) at 1M rows, 2.3x the
// first version; what remains is the shared-memory wavefronts of the
// node loads, whose lanes scatter over a tree's items and conflict on
// its banks.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int TILE_THREADS = 512;     // the most walking threads a block
constexpr int BLOCK_THREADS = TILE_THREADS + 32; // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int SMALL_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;      // an H100 block's shared memory
constexpr double K_ZERO = 1e-35;
constexpr int FEATURE_MASK = 0xFFFFFF;         // an item's meta: feature
constexpr int CATEGORICAL_BIT = 1 << 24;       // decision bit 0, categorical
enum : int { MODE_SUM = 0, MODE_SUM_EARLY_STOP = 1, MODE_LEAF = 2 };

struct Ensemble {
  const int4* items;         // [I] preorder items of every tree
  const int* tree_off;       // [T+1] first item of each tree
  const int* group_off;      // [G+1] first tree of each group
  const int* cat_off;        // [T+1] first cat boundary of each tree
  const int* cat_bound;      // [C] word offsets into cat_words
  const uint32_t* cat_words; // [W] bitset words
};

__device__ __forceinline__ double item_value(const int4& w) {
  return __hiloint2double(w.y, w.x);
}

// The categorical test of tree t's node w (its threshold the bitset's
// index) for value v.
__device__ __forceinline__ bool go_left_cat(const Ensemble& e, int t,
                                            const int4& w, double v) {
  if (v != v) return false;
  const long long iv = (long long)v;      // toward zero, saturating
  if (iv < 0) return false;
  const int b = __ldg(e.cat_off + t) + (int)item_value(w);
  const long long lo = __ldg(e.cat_bound + b);
  const long long hi = __ldg(e.cat_bound + b + 1);
  const long long word = lo + iv / 32;
  if (word >= hi) return false;
  return (__ldg(e.cat_words + word) >> (unsigned)(iv % 32)) & 1u;
}

// Node w of tree t sends value v left.
__device__ __forceinline__ bool go_left(const Ensemble& e, int t,
                                        const int4& w, double v) {
  const int dec = (unsigned)w.z >> 24;
  if (dec & 1) return go_left_cat(e, t, w, v);
  const int mt = (dec >> 2) & 3;
  if (v != v && mt != 2) v = 0.0;
  const bool missing = (mt == 1 && fabs(v) <= K_ZERO) || (mt == 2 && v != v);
  if (missing) return (dec & 2) != 0;
  return v <= item_value(w);
}

// An item from a stage in shared memory (SH) or from global memory.
template <bool SH>
__device__ __forceinline__ int4 load_item(const int4* p) {
  return SH ? *p : __ldg(p);
}

// The stage ring's barriers (mbarrier objects in shared memory, by their
// shared-window address) and its bulk copies (TMA).
__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global src to shared dst, completing on
// bar's transaction count.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A tile: RPT rows a thread, TPS trees at once (RPT * TPS = 4 walks
// interleaved); f32 rows take half the shared memory, so a thread holds
// twice as many, and both take 8 bytes a feature and walking thread.
template <typename XT>
struct Tile {
  static constexpr int RPT = sizeof(XT) == 4 ? 2 : 1;
  static constexpr int TPS = 4 / RPT;
};

struct Args {
  Ensemble e;
  const void* X;
  long long n;
  int F, F_need, T, k, mode, freq, stage_items;
  double margin;
  double* out;
  long long ld;
  int* leaf;
  int period;                // early stop: iterations between tests
};

// Early stop: whether the row's margin is tested before tree t.
__device__ __forceinline__ bool stop_test(const Args& a, int t) {
  return t > 0 && t % a.k == 0 && (t / a.k) % a.period == 0;
}

// Early stop: whether the row walks on, its margin below a.margin; acc is
// its sum for k = 1, for k > 1 its sums are out[c * ld + row].
__device__ __forceinline__ bool walks_on(const Args& a, double acc,
                                         long long row) {
  if (a.k == 1) return 2.0 * fabs(acc) < a.margin;
  double top1 = a.out[row], top2 = a.out[a.ld + row];
  if (top2 > top1) {
    top2 = top1;
    top1 = a.out[a.ld + row];
  }
  for (int c = 2; c < a.k; ++c) {
    const double v = a.out[c * a.ld + row];
    if (v > top1) {
      top2 = top1;
      top1 = v;
    } else if (v > top2) {
      top2 = v;
    }
  }
  return top1 - top2 < a.margin;
}

// The walks of trees t0 .. t0+TPS-1 (those below te) for the RPT rows of
// this thread, tree t0+i's items at src + off[i] (a stage in shared memory
// if SH, else global memory), the features of the tile's R rows at xs (if
// XS): each walk ends at its leaf, whose item goes
// to w[j][i].  Rows that are out of range or stopped (live[j] false) walk
// nothing.  A step of every walk runs in three phases, so the loads of the
// RPT * TPS walks overlap: the features, then the decisions, then the next
// items; a walk at its leaf loads nothing (its loads would only add
// shared-memory wavefronts).  A value that is
// neither NaN nor zero decides by v <= threshold under every missing
// type; NaN, "zero" and categorical nodes take the full decision, in one
// branch for all walks.
template <typename XT, bool XS, bool SH, int RPT, int TPS>
__device__ __forceinline__ void walk_chains(
    const Args& a, const int4* src, const int (&off)[TPS], int t0, int te,
    const XT* xs, int R, const XT* const (&xrow)[RPT],
    const int (&lrow)[RPT], const bool (&live)[RPT], int4 (&w)[RPT][TPS]) {
  int node[RPT][TPS];
  bool any = false;
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int i = 0; i < TPS; ++i) {
      node[j][i] = 0;
      w[j][i] = live[j] && t0 + i < te ? load_item<SH>(src + off[i])
                                       : make_int4(0, 0, -1, 0);
      any |= w[j][i].z >= 0;
    }
  while (any) {
    double v[RPT][TPS];
    bool go[RPT][TPS], full[RPT][TPS];
    bool slow = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int i = 0; i < TPS; ++i) {
        v[j][i] = 0.0;
        if (w[j][i].z >= 0) {
          const int f = w[j][i].z & FEATURE_MASK;
          v[j][i] = XS ? (double)xs[f * R + lrow[j]]
                       : (double)__ldg(xrow[j] + f);
        }
      }
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int i = 0; i < TPS; ++i) {
        go[j][i] = v[j][i] <= item_value(w[j][i]);
        full[j][i] = w[j][i].z >= 0 && (!(fabs(v[j][i]) > K_ZERO) ||
                                        (w[j][i].z & CATEGORICAL_BIT));
        slow |= full[j][i];
      }
    if (slow) {
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int i = 0; i < TPS; ++i)
          if (full[j][i]) go[j][i] = go_left(a.e, t0 + i, w[j][i], v[j][i]);
    }
    any = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int i = 0; i < TPS; ++i) {
        if (w[j][i].z >= 0) {
          node[j][i] = go[j][i] ? node[j][i] + 1 : w[j][i].w;
          w[j][i] = load_item<SH>(src + off[i] + node[j][i]);
        }
      }
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int i = 0; i < TPS; ++i) any |= w[j][i].z >= 0;
  }
}

// FULL: tiles of TILE_THREADS walking threads, whose row stride the
// compiler knows (the kernel of a runtime width alone ran 3% slower at 1M
// rows, where every tile is full).
template <typename XT, bool XS, bool FULL>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
predict_ensemble_kernel(Args a, int stages) {
  using TL = Tile<XT>;
  constexpr int RPT = TL::RPT, TPS = TL::TPS;
  const int W = FULL ? TILE_THREADS : (int)blockDim.x - 32;  // walkers
  const int R = W * RPT;                                     // rows
  extern __shared__ __align__(16) unsigned char smem[];
  // [full, empty] barriers of each stage, the stages, the X tile
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  int4* stage = reinterpret_cast<int4*>(smem + 16 * MAX_STAGES);
  XT* xs = reinterpret_cast<XT*>(stage + (size_t)stages * a.stage_items);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * R;
  const XT* X = static_cast<const XT*>(a.X);
  const Ensemble& e = a.e;
  int groups = 0;
  while (__ldg(e.group_off + groups) < a.T) ++groups;
  // a group's items (it is staged when they fit a stage)
  auto group_items = [&](int g) {
    return __ldg(e.tree_off + __ldg(e.group_off + g + 1)) -
           __ldg(e.tree_off + __ldg(e.group_off + g));
  };
  auto full = [&](int s) { return smem_addr(bars + 2 * s); };
  auto empty = [&](int s) { return smem_addr(bars + 2 * s + 1); };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), W / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // X read once: the tile's rows, transposed into shared memory
  if (XS && tid < W) {
    const int cells = R * a.F_need;
    for (int i = tid; i < cells; i += W) {
      const int r = i / a.F_need, f = i - r * a.F_need;
      xs[f * R + r] = r0 + r < a.n ? X[(r0 + r) * a.F + f] : XT(0);
    }
  }
  __syncthreads();

  if (tid >= W) {
    // the producer: group g into stage g % stages once the walkers have
    // released that stage's previous group
    if (tid == W) {
      for (int g = 0; g < groups; ++g) {
        const int s = g % stages, use = g / stages;
        if (use > 0) bar_wait(empty(s), (use - 1) & 1);
        const int items = group_items(g);
        if (items <= a.stage_items) {
          bar_arrive_tx(full(s), 16u * items);
          bulk_copy(smem_addr(stage + (size_t)s * a.stage_items),
                    e.items + __ldg(e.tree_off + __ldg(e.group_off + g)),
                    16u * items, full(s));
        } else {
          bar_arrive(full(s));        // walked from global memory
        }
      }
    }
    return;
  }

  int lrow[RPT];
  long long row[RPT];
  const XT* xrow[RPT];
  bool live[RPT];
  double acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    lrow[j] = tid + j * W;
    row[j] = r0 + lrow[j];
    live[j] = row[j] < a.n;
    xrow[j] = X + (live[j] ? row[j] : 0) * a.F;
    acc[j] = 0.0;
    if (live[j] && a.mode != MODE_LEAF && a.k > 1)
      for (int c = 0; c < a.k; ++c) a.out[c * a.ld + row[j]] = 0.0;
  }
  for (int g = 0; g < groups; ++g) {
    const int s = g % stages;
    bar_wait(full(s), (g / stages) & 1);
    const int tb = __ldg(e.group_off + g);
    const int te = min(__ldg(e.group_off + g + 1), a.T);
    const bool shared = group_items(g) <= a.stage_items;
    const int item0 = __ldg(e.tree_off + tb);
    const int4* src = shared ? stage + (size_t)s * a.stage_items : e.items;
    for (int t0 = tb; t0 < te; t0 += TPS) {
      int off[TPS];
#pragma unroll
      for (int i = 0; i < TPS; ++i)
        off[i] = __ldg(e.tree_off + min(t0 + i, te - 1)) -
                 (shared ? item0 : 0);
      int4 w[RPT][TPS];
      if (shared)
        walk_chains<XT, XS, true, RPT, TPS>(a, src, off, t0, te, xs, R,
                                            xrow, lrow, live, w);
      else
        walk_chains<XT, XS, false, RPT, TPS>(a, src, off, t0, te, xs, R,
                                             xrow, lrow, live, w);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (!live[j]) continue;
#pragma unroll
        for (int i = 0; i < TPS; ++i) {
          const int t = t0 + i;
          if (t >= te) break;
          if (a.mode == MODE_LEAF) {
            a.leaf[row[j] * a.T + t] = w[j][i].z & FEATURE_MASK;
            continue;
          }
          if (a.mode == MODE_SUM_EARLY_STOP && stop_test(a, t) &&
              !walks_on(a, acc[j], row[j])) {
            live[j] = false;
            break;
          }
          const double v = item_value(w[j][i]);
          if (a.k == 1) {
            acc[j] = __dadd_rn(acc[j], v);
          } else {
            double* o = a.out + (t % a.k) * a.ld + row[j];
            *o = __dadd_rn(*o, v);
          }
        }
      }
    }
    // this warp is done with the stage: the producer may refill it
    __syncwarp();
    if ((tid & 31) == 0) bar_arrive(empty(s));
  }
  if (a.mode != MODE_LEAF && a.k == 1) {
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (row[j] < a.n) a.out[row[j]] = acc[j];
  }
}

// The small-batch walk: thread (t, row) walks tree t for one row from
// global memory; sum modes store the leaf value at vals[t * n + row], leaf
// mode the leaf id at leaf[row * T + t].
template <typename XT>
__global__ void __launch_bounds__(SMALL_THREADS)
predict_small_kernel(Args a, double* __restrict__ vals) {
  const long long idx = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (idx >= (long long)a.T * a.n) return;
  const int t = (int)(idx / a.n);
  const long long row = idx - (long long)t * a.n;
  const XT* x = static_cast<const XT*>(a.X) + row * a.F;
  const int4* base = a.e.items + __ldg(a.e.tree_off + t);
  int node = 0;
  int4 w = __ldg(base);
  while (w.z >= 0) {
    const double v = (double)__ldg(x + (w.z & FEATURE_MASK));
    node = go_left(a.e, t, w, v) ? node + 1 : w.w;
    w = __ldg(base + node);
  }
  if (a.mode == MODE_LEAF)
    a.leaf[row * a.T + t] = w.z & FEATURE_MASK;
  else
    vals[idx] = item_value(w);
}

// The small batch's sums: thread (c, row) adds vals[t * n + row] over the
// trees t with t % k == c in tree order; with early stop, whose test reads
// every class's sum, thread row adds all k classes' in tree order.
__global__ void __launch_bounds__(SMALL_THREADS)
predict_small_sum_kernel(Args a, const double* __restrict__ vals) {
  const long long idx = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (a.mode == MODE_SUM_EARLY_STOP) {
    if (idx >= a.n) return;
    for (int c = 0; c < a.k; ++c) a.out[c * a.ld + idx] = 0.0;
    double acc = 0.0;
    for (int t = 0; t < a.T; ++t) {
      if (stop_test(a, t) && !walks_on(a, acc, idx)) break;
      const double v = vals[(long long)t * a.n + idx];
      if (a.k == 1) {
        acc = __dadd_rn(acc, v);
      } else {
        double* o = a.out + (t % a.k) * a.ld + idx;
        *o = __dadd_rn(*o, v);
      }
    }
    if (a.k == 1) a.out[idx] = acc;
    return;
  }
  if (idx >= (long long)a.k * a.n) return;
  const int c = (int)(idx / a.n);
  const long long row = idx - (long long)c * a.n;
  double acc = 0.0;
  for (int t = c; t < a.T; t += a.k)
    acc = __dadd_rn(acc, vals[(long long)t * a.n + row]);
  a.out[c * a.ld + row] = acc;
}

int check_args(const Args& a) {
  if (a.n <= 0 || a.T < 0 || a.k < 1 || a.F < 0 || a.F_need < 0 ||
      a.F_need > a.F || a.mode < MODE_SUM || a.mode > MODE_LEAF ||
      (a.mode == MODE_SUM_EARLY_STOP && a.freq < 1) ||
      a.stage_items < 0 ||
      16 * MAX_STAGES + 2 * 16 * (long long)a.stage_items > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The walking threads of a block over n rows of RPT a thread (-1 if the
// device is not read): TILE_THREADS, or the fewest multiple of 32 that
// still gives every SM a tile where full tiles would leave SMs idle (a
// block holds its SM alone).
int tile_walkers(long long n, int rpt) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      return -1;
  }
  const long long per_sm = (n + (long long)sms * rpt - 1) / sms / rpt;
  const long long warps = std::max<long long>(1, (per_sm + 31) / 32);
  return (int)std::min<long long>(TILE_THREADS, warps * 32);
}

template <typename XT, bool XS>
int launch_tiled(const Args& a, int walkers, int stages, size_t smem,
                 cudaStream_t stream) {
  auto kernel = walkers == TILE_THREADS
                    ? predict_ensemble_kernel<XT, XS, true>
                    : predict_ensemble_kernel<XT, XS, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const long long rows = (long long)walkers * Tile<XT>::RPT;
  kernel<<<(unsigned)((a.n + rows - 1) / rows), walkers + 32, smem,
           stream>>>(a, stages);
  return (int)cudaGetLastError();
}

// Tiles of tile_walkers threads; their X in shared memory when it leaves
// room for two stages, and as many stages as the rest holds (at most
// MAX_STAGES).
template <typename XT>
int tiled(const Args& a, cudaStream_t stream) {
  const int walkers = tile_walkers(a.n, Tile<XT>::RPT);
  if (walkers < 0) return (int)cudaErrorInvalidDevice;
  const size_t stage = 16 * (size_t)a.stage_items;
  const size_t head = 16 * MAX_STAGES;
  const size_t xtile =
      sizeof(XT) * (size_t)walkers * Tile<XT>::RPT * (size_t)a.F_need;
  const bool xs = head + xtile + 2 * stage <= (size_t)SMEM_LIMIT;
  const size_t room = SMEM_LIMIT - head - (xs ? xtile : 0);
  const int stages = stage == 0 ? 1
                                : (int)std::min<size_t>(MAX_STAGES,
                                                        room / stage);
  const size_t smem = head + (xs ? xtile : 0) + stages * stage;
  return xs ? launch_tiled<XT, true>(a, walkers, stages, smem, stream)
            : launch_tiled<XT, false>(a, walkers, stages, smem, stream);
}

template <typename XT>
int small(const Args& a, double* vals, cudaStream_t stream) {
  const long long pairs = (long long)a.T * a.n;
  if (pairs > 0) {
    predict_small_kernel<XT>
        <<<(unsigned)((pairs + SMALL_THREADS - 1) / SMALL_THREADS),
           SMALL_THREADS, 0, stream>>>(a, vals);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  if (a.mode == MODE_LEAF) return 0;
  const long long sums = (a.mode == MODE_SUM_EARLY_STOP ? 1 : a.k) * a.n;
  predict_small_sum_kernel<<<(unsigned)((sums + SMALL_THREADS - 1) /
                                        SMALL_THREADS),
                             SMALL_THREADS, 0, stream>>>(a, vals);
  return (int)cudaGetLastError();
}

}  // namespace

// X [n, F] f32 (x_f32 != 0) or f64, row-major; a node reads features
// below F_need; T the trees walked (t < T); out [k, ld] f64 at its first
// row (sum modes) or leaf [n, T] int32 (leaf mode).  stage_items: the
// items of the largest group that fits a stage (its trees are staged in
// shared memory; larger groups walk from global memory).
LGBT_API int lgbt_predict_ensemble(
    const int4* items, const int* tree_off, const int* group_off,
    const int* cat_off, const int* cat_bound, const uint32_t* cat_words,
    const void* X, int x_f32, long long n, int F, int F_need, int T, int k,
    int mode, int freq, double margin, int stage_items, double* out,
    long long ld, int* leaf, cudaStream_t stream) {
  Args a{Ensemble{items, tree_off, group_off, cat_off, cat_bound, cat_words},
         X, n, F, F_need, T, k, mode, freq, stage_items, margin, out, ld,
         leaf, k > 0 ? (freq + k - 1) / k : 1};
  const int bad = check_args(a);
  if (bad) return bad;
  return x_f32 ? tiled<float>(a, stream) : tiled<double>(a, stream);
}

// The small-batch walk of the same arguments: vals a [T, n] f64 scratch
// (sum modes; unused in leaf mode).
LGBT_API int lgbt_predict_ensemble_small(
    const int4* items, const int* tree_off, const int* group_off,
    const int* cat_off, const int* cat_bound, const uint32_t* cat_words,
    const void* X, int x_f32, long long n, int F, int F_need, int T, int k,
    int mode, int freq, double margin, int stage_items, double* out,
    long long ld, int* leaf, double* vals, cudaStream_t stream) {
  Args a{Ensemble{items, tree_off, group_off, cat_off, cat_bound, cat_words},
         X, n, F, F_need, T, k, mode, freq, stage_items, margin, out, ld,
         leaf, k > 0 ? (freq + k - 1) / k : 1};
  const int bad = check_args(a);
  if (bad) return bad;
  if (mode != MODE_LEAF && vals == nullptr)
    return (int)cudaErrorInvalidValue;
  return x_f32 ? small<float>(a, vals, stream)
               : small<double>(a, vals, stream);
}
