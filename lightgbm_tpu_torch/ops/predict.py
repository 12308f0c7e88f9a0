"""Device prediction over raw features: the ensemble's walk tables.

Port of lightgbm_tpu/ops/predict.py.  The JAX package rides the TPU's
matrix unit: a dense [rows, T*N] decision tensor, a bf16 [T, L, N]
path-signature tensor and one einsum per row chunk (`_chunk_scores`
:322-364), thresholds compared in double-single f32 and leaf values
summed in f32.  On an H100 that is 2 rows T L N operations where a walk
reads about depth x T nodes a row, so the port walks: KP1
(ops/predict_kernel.predict_ensemble, csrc/predict_ensemble.cu) walks
row tiles through groups of trees staged in shared memory, or, for a
small batch, one (tree, row) pair a thread followed by an ordered sum,
comparing and summing in f64.  Its sums equal the host walk (`out +=
tree.predict(X)` in models/tree.py) bit for bit, which the JAX design
could not.

The ensemble is held as walk tables, concatenated over the trees:
- per tree, in preorder, one 16-byte item a node or leaf at the [T+1]
  item offset: the f64 threshold (a categorical node's bitset index) or
  leaf value (the host tree's shrunk values with their bias), an int32
  meta (raw feature and decision bits, or the leaf id with the sign bit)
  and the int32 right child (the left child is the next item);
- the [G+1] first tree of each group KP1 stages together;
- for categorical nodes, at the [T+1] boundary offset: each tree's
  `cat_boundaries`, rebased onto the concatenated `cat_threshold` words
  (uint32, held as int32 bits).
No table grows as T L N, so every ensemble builds (`ok` is always True).

Tree t adds to class t % k, as JAX's final reshape does.  X reaches the
card in its own width (float32 stays float32, anything else is f64) in
row chunks of at most _CHUNK_BYTES through pinned staging, and the output
is fetched once, at the end.  On the CPU the tables and X stay there and
the plain version runs.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

# Copied from lightgbm_tpu/ops/predict.py:27-30.
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2
K_ZERO_THRESHOLD = 1e-35

# X bytes a chunk sends to the card
_CHUNK_BYTES = 1 << 26


# Copied from lightgbm_tpu/ops/predict.py:47-70.
def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def bucket_rows(n: int, max_bucket: int = 1 << 20) -> int:
    """Row-count bucket for executable reuse: the next power of two,
    capped so giant requests chunk through predict_sum instead of
    compiling a bespoke one-off executable."""
    return min(_next_pow2(max(n, 1)), _next_pow2(max_bucket))


def pow2_buckets(max_batch: int) -> List[int]:
    """All power-of-two bucket sizes up to (and including) max_batch —
    the default warmup set for serving."""
    out, b = [], 1
    top = _next_pow2(max(max_batch, 1))
    while b <= top:
        out.append(b)
        b *= 2
    return out


class EnsembleTables(NamedTuple):
    """The walk tables of an ensemble (torch tensors on one device)."""
    items: torch.Tensor        # int32 [max(I, 1), 4] preorder items
    tree_off: torch.Tensor     # int32 [T+1] first item of each tree
    group_off: torch.Tensor    # int32 [G+1] first tree of each group
    cat_off: torch.Tensor      # int32 [T+1]
    cat_bound: torch.Tensor    # int32 [max(C, 1)] absolute word offsets
    cat_words: torch.Tensor    # int32 [max(W, 1)] uint32 bitset words
    max_feature: int           # the largest raw feature a node reads, -1
    stage_items: int           # items of the largest group a stage holds


# An item is 16 bytes: the f64 threshold (a categorical node's bitset
# index) or leaf value, int32 meta, int32 right child (the left child of
# an internal node is the next item).  meta: raw feature | decision bits
# << 24 for an internal node, leaf id | LEAF_BIT for a leaf.
_ITEM_BYTES = 16
_LEAF_BIT = -(1 << 31)
_FEATURE_BITS = 24
# a group's items, the one stage capacity of KP1 (a group is staged in 48
# KB of shared memory; the kernel sizes its stages from the tables'
# stage_items and refuses a capacity whose ring of two does not fit); a
# tree of more items is a group of its own, walked from global memory
_STAGE_ITEMS = 3072
# a group of 4 trees or more holds a multiple of 4 (KP1 walks 4 at once)
_GROUP_QUANTUM = 4
# bytes a table entry of each kind holds: a tree's two offsets, a group's
# offset, a boundary, a word
_TREE_BYTES = 2 * 4
_GROUP_BYTES = 4
_BOUND_BYTES = 4
_WORD_BYTES = 4


def _tree_items(t) -> int:
    """Items of a tree in the walk tables: its nodes and its leaves."""
    return 2 * max(t.num_leaves, 1) - 1


def tree_groups(sizes: List[int], stage_items: int = None) -> List[int]:
    """The first tree of each group over trees of `sizes` items, and the
    tree count at the end ([G+1]): consecutive trees of at most
    stage_items items together, a group of 4 or more trees cut to a
    multiple of 4; a larger tree alone."""
    cap = _STAGE_ITEMS if stage_items is None else stage_items
    off = [0]
    t = 0
    while t < len(sizes):
        e, items = t, 0
        while e < len(sizes) and items + sizes[e] <= cap:
            items += sizes[e]
            e += 1
        if e == t:
            e = t + 1
        elif e - t >= _GROUP_QUANTUM and e < len(sizes):
            e = t + (e - t) // _GROUP_QUANTUM * _GROUP_QUANTUM
        off.append(e)
        t = e
    return off


def ensemble_layout(trees: List, num_classes: int) -> dict:
    """The sizes of the walk tables DeviceEnsemble builds for these trees,
    computed without touching the device: k, the trees T, the internal
    nodes N, the leaves L, the items I (N + L), the groups G, the
    categorical boundaries C and bitset words W.  `ok` is always True: no
    table grows as T L N, so every ensemble builds (the JAX layout's
    signature tensor could refuse one)."""
    N = sum(max(t.num_leaves - 1, 0) for t in trees)
    L = sum(max(t.num_leaves, 1) for t in trees)
    C = sum(len(t.cat_boundaries) for t in trees if t.num_cat > 0)
    W = sum(len(t.cat_threshold) for t in trees if t.num_cat > 0)
    G = len(tree_groups([_tree_items(t) for t in trees])) - 1
    return {"k": max(num_classes, 1), "T": len(trees), "N": N, "L": L,
            "I": N + L, "G": G, "C": C, "W": W, "ok": True}


def estimate_device_bytes(trees: List, num_classes: int) -> int:
    """Device bytes the DeviceEnsemble for `trees` holds, from the layout
    alone: equal to device_bytes() of the built ensemble, so a byte budget
    reserved before the build never drifts from the accounting after it
    (lightgbm_tpu/ops/predict.py:110)."""
    lay = ensemble_layout(trees, num_classes)
    return int(max(lay["I"], 1) * _ITEM_BYTES
               + (lay["T"] + 1) * _TREE_BYTES
               + (lay["G"] + 1) * _GROUP_BYTES
               + max(lay["C"], 1) * _BOUND_BYTES
               + max(lay["W"], 1) * _WORD_BYTES)


def _preorder(t) -> tuple:
    """A tree's items in preorder: (kind, index) with kind 0 an internal
    node and 1 a leaf, and each item's right child's position (0 for a
    leaf).  An internal node's left child is the item after it."""
    if t.num_leaves <= 1:
        return [(1, 0)], [0]
    order, right = [], []
    stack = [(0, -1)]            # (child, position of the node it is right of)
    while stack:
        c, parent = stack.pop()
        if parent >= 0:
            right[parent] = len(order)
        right.append(0)
        if c < 0:
            order.append((1, ~c))
            continue
        stack.append((int(t.right_child[c]), len(order)))
        stack.append((int(t.left_child[c]), -1))
        order.append((0, c))
    return order, right


def build_tables(trees: List, device) -> EnsembleTables:
    """The walk tables of `trees` on `device`."""
    lay = ensemble_layout(trees, 1)
    items = np.zeros((max(lay["I"], 1), 2), np.float64)
    lanes = items.view(np.int32)         # [I, 4]: meta and right in 2, 3
    tree_off = np.zeros(len(trees) + 1, np.int32)
    cat_off = np.zeros(len(trees) + 1, np.int32)
    bounds: List[int] = []
    words: List[int] = []
    max_feature = -1
    ia = 0
    for ti, t in enumerate(trees):
        order, right = _preorder(t)
        kind = np.array([k for k, _ in order], np.int64)
        idx = np.array([c for _, c in order], np.int64)
        node, leaf = idx[kind == 0], idx[kind == 1]
        rows = np.arange(ia, ia + len(order))
        feat = np.asarray(t.split_feature, np.int64)[node]
        if len(feat):
            if feat.max() >= 1 << _FEATURE_BITS:
                raise ValueError("feature %d past KP1's %d-bit field"
                                 % (feat.max(), _FEATURE_BITS))
            max_feature = max(max_feature, int(feat.max()))
        lv = (np.asarray(t.leaf_value, np.float64)[leaf] if t.num_leaves >= 1
              and len(t.leaf_value) else np.zeros(len(leaf)))
        dec = np.asarray(t.decision_type, np.int64)[node] & 0xFF
        items[rows[kind == 0], 0] = np.asarray(t.threshold, np.float64)[node]
        items[rows[kind == 1], 0] = lv
        lanes[rows[kind == 0], 2] = (feat | dec << _FEATURE_BITS).astype(
            np.uint32).view(np.int32)
        lanes[rows[kind == 1], 2] = (leaf + _LEAF_BIT).astype(np.int32)
        lanes[rows, 3] = np.asarray(right, np.int32)
        if t.num_cat > 0:
            bounds.extend(len(words) + int(b) for b in t.cat_boundaries)
            words.extend(int(w) for w in t.cat_threshold)
        ia += len(order)
        tree_off[ti + 1] = ia
        cat_off[ti + 1] = len(bounds)
    group_off = np.array(tree_groups([_tree_items(t) for t in trees]),
                         np.int32)
    stage_items = max([int(tree_off[b] - tree_off[a]) for a, b in
                       zip(group_off[:-1], group_off[1:])
                       if tree_off[b] - tree_off[a] <= _STAGE_ITEMS] or [0])
    cat_bound = np.array(bounds or [0], np.int32)
    cat_words = np.array(words or [0], np.uint32).view(np.int32)

    def dev(a):
        return torch.as_tensor(a, device=device)
    return EnsembleTables(dev(lanes), dev(tree_off), dev(group_off),
                          dev(cat_off), dev(cat_bound), dev(cat_words),
                          max_feature, stage_items)


# --------------------------------------------------------------------------- #
# KP1's plain version
# --------------------------------------------------------------------------- #
def _cat_left(tb: EnsembleTables, cat0: int, thr: torch.Tensor,
              v: torch.Tensor, is_cat: torch.Tensor) -> torch.Tensor:
    """CategoricalDecision (models/tree.py `_categorical_go_left`): the
    value truncated toward zero is a member of the bitset at index thr;
    NaN, negative ids and ids past the bitset are non-members."""
    nan = torch.isnan(v)
    iv = torch.where(is_cat & ~nan, v, 0.0).to(torch.int64)
    valid = is_cat & ~nan & (iv >= 0)
    iv = torch.where(valid, iv, 0)
    ci = torch.where(is_cat, thr, 0.0).to(torch.int64)
    b = (cat0 + ci).clamp(0, tb.cat_bound.shape[0] - 2)
    lo = tb.cat_bound[b].long()
    hi = tb.cat_bound[b + 1].long()
    word = lo + iv // 32
    in_bounds = word < hi
    bits = tb.cat_words[word.clamp(0, tb.cat_words.shape[0] - 1)].long()
    member = ((bits & 0xFFFFFFFF) >> (iv % 32)) & 1
    return valid & in_bounds & (member > 0)


def _tree_leaf_item(tb: EnsembleTables, offs: tuple, X: torch.Tensor,
                    t: int) -> torch.Tensor:
    """The item (int64 [m], into tb.items) of the leaf of tree t that each
    row of X [m, F] (f32 or f64, compared in f64) reaches, by the host
    walk's decisions (models/tree.py Tree.predict_leaf_index), all rows at
    once, level by level until every row rests at a leaf."""
    tree_off, cat_off = offs
    base = tree_off[t]
    lanes = tb.items
    value = lanes.view(torch.float64)[:, 0]
    item = torch.full((X.shape[0],), base, dtype=torch.int64,
                      device=X.device)
    meta = lanes[item, 2]
    while bool((meta >= 0).any()):
        active = meta >= 0
        feat = (meta & ((1 << _FEATURE_BITS) - 1)).long()
        dec = (meta >> _FEATURE_BITS).long() & 0xFF
        thr = value[item]
        v = X.gather(1, torch.where(active, feat, 0)[:, None])[:, 0].to(
            torch.float64)
        mt = (dec >> 2) & 3
        vn = torch.where(torch.isnan(v) & (mt != MISSING_NAN), 0.0, v)
        zero = vn.abs() <= K_ZERO_THRESHOLD
        missing = (((mt == MISSING_ZERO) & zero)
                   | ((mt == MISSING_NAN) & torch.isnan(vn)))
        go_left = torch.where(missing, (dec & 2) != 0, vn <= thr)
        is_cat = active & ((dec & 1) != 0)
        if bool(is_cat.any()):
            go_left = torch.where(is_cat, _cat_left(tb, cat_off[t], thr, v,
                                                     is_cat), go_left)
        nxt = torch.where(go_left, item + 1, base + lanes[item, 3].long())
        item = torch.where(active, nxt, item)
        meta = lanes[item, 2]
    return item


MODE_SUM, MODE_SUM_EARLY_STOP, MODE_LEAF = 0, 1, 2


def _offsets(tb: EnsembleTables) -> tuple:
    return tb.tree_off.tolist(), tb.cat_off.tolist()


def early_stop_test(t: int, k: int, freq: int) -> bool:
    """Whether early stop tests a row's margin before tree t: the first
    tree of an iteration it > 0 that is a multiple of ceil(freq / k)
    iterations (the host loop's counter, which advances k an iteration and
    resets at each test, lightgbm_tpu/models/gbdt.py:1721-1747)."""
    return t > 0 and t % k == 0 and (t // k) % -(-freq // k) == 0


def walks_on(out: torch.Tensor, margin: float) -> torch.Tensor:
    """The rows of the [k, m] f64 sums whose margin is below `margin`:
    2|sum| for k = 1, the largest class sum less the second largest for
    k > 1."""
    if out.shape[0] == 1:
        return 2.0 * out[0].abs() < margin
    top = out.topk(2, dim=0).values
    return top[0] - top[1] < margin


def predict_ensemble_plain(tb: EnsembleTables, X: torch.Tensor, T: int,
                           k: int, mode: int = MODE_SUM, freq: int = 0,
                           margin: float = 0.0) -> torch.Tensor:
    """KP1 in plain PyTorch: the trees t < T walked over every row of X
    [m, F] (f32 or f64, each value compared in f64), one tree at a time.
    Sum modes return [k, m] f64, each row's leaf values added in tree
    order in f64 (tree t to class t % k); with early stop a row stops
    before tree t where `early_stop_test` holds, once its margin below
    `margin` fails (`walks_on`).  Leaf mode returns [m, T] int32."""
    offs = _offsets(tb)
    m = X.shape[0]
    if mode == MODE_LEAF:
        out = torch.zeros((m, T), dtype=torch.int32, device=X.device)
        for t in range(T):
            item = _tree_leaf_item(tb, offs, X, t)
            out[:, t] = tb.items[item, 2] & ((1 << _FEATURE_BITS) - 1)
        return out
    value = tb.items.view(torch.float64)[:, 0]
    out = torch.zeros((k, m), dtype=torch.float64, device=X.device)
    active = torch.ones(m, dtype=torch.bool, device=X.device)
    for t in range(T):
        if mode == MODE_SUM_EARLY_STOP and early_stop_test(t, k, freq):
            active &= walks_on(out, margin)
        v = value[_tree_leaf_item(tb, offs, X, t)]
        c = t % k
        out[c] = torch.where(active, out[c] + v, out[c])
    return out


def tree_values_plain(tb: EnsembleTables, X: torch.Tensor,
                      T: int) -> torch.Tensor:
    """The small-batch walk in plain PyTorch: [T, m] f64, the leaf value
    of tree t that row r reaches at [t, r]."""
    offs = _offsets(tb)
    value = tb.items.view(torch.float64)[:, 0]
    out = torch.zeros((T, X.shape[0]), dtype=torch.float64, device=X.device)
    for t in range(T):
        out[t] = value[_tree_leaf_item(tb, offs, X, t)]
    return out


def ordered_sum_plain(vals: torch.Tensor, k: int, mode: int = MODE_SUM,
                      freq: int = 0, margin: float = 0.0) -> torch.Tensor:
    """The small batch's second pass in plain PyTorch: [k, m] f64, each
    row's values vals[t, row] of the trees t % k == c added in tree order
    from 0.0, with the early stop of predict_ensemble_plain."""
    T, m = vals.shape
    out = torch.zeros((k, m), dtype=torch.float64, device=vals.device)
    active = torch.ones(m, dtype=torch.bool, device=vals.device)
    for t in range(T):
        if mode == MODE_SUM_EARLY_STOP and early_stop_test(t, k, freq):
            active &= walks_on(out, margin)
        c = t % k
        out[c] = torch.where(active, out[c] + vals[t], out[c])
    return out


class DeviceEnsemble:
    """An ensemble's walk tables on a device, built once per model state
    (callers cache on len(models) and a generation count); the surface of
    lightgbm_tpu/ops/predict.py:138."""

    def __init__(self, trees: List, num_classes: int, device=None):
        from ..device import resolve_device
        lay = ensemble_layout(trees, num_classes)
        self.layout = lay
        self.k = lay["k"]
        self.num_trees = len(trees)
        self.ok = lay["ok"]
        self.device = resolve_device(device)
        self.tables = build_tables(trees, self.device)

    def _trees(self, num_iteration: int) -> int:
        return min(max(num_iteration, 0) * self.k, self.num_trees)

    def predict_sum(self, X: np.ndarray, num_iteration: int,
                    early_stop_freq: int = 0,
                    early_stop_margin: float = 0.0) -> np.ndarray:
        """[k, n] f64 summed raw scores over the first num_iteration*k
        trees; early_stop_freq > 0 stops a row once its margin reaches
        early_stop_margin, tested at the first iteration after every
        early_stop_freq trees (predict_ensemble_plain).  Safe to call from
        several threads at once."""
        from .predict_kernel import predict_ensemble
        mode = MODE_SUM_EARLY_STOP if early_stop_freq > 0 else MODE_SUM
        T = self._trees(num_iteration)
        out = torch.zeros((self.k, X.shape[0]), dtype=torch.float64,
                          device=self.device)
        for a, Xd in self._chunks(X):
            predict_ensemble(self.tables, Xd, T, self.k, out, a, mode=mode,
                             freq=early_stop_freq, margin=early_stop_margin)
        return out.cpu().numpy()

    def predict_leaf(self, X: np.ndarray, num_iteration: int) -> np.ndarray:
        """int32 [n, iters*k]: each row's leaf in every tree walked."""
        from .predict_kernel import predict_ensemble
        T = self._trees(num_iteration)
        out = torch.zeros((X.shape[0], T), dtype=torch.int32,
                          device=self.device)
        if T > 0:
            for a, Xd in self._chunks(X):
                predict_ensemble(self.tables, Xd, T, self.k, out, a,
                                 mode=MODE_LEAF)
        return out.cpu().numpy()

    def _chunks(self, X: np.ndarray):
        """(first row, rows on the device) of X, f32 if X is float32 and
        f64 otherwise: on the card in chunks of at most _CHUNK_BYTES, each
        staged in pinned memory of its own and copied without blocking on
        the current stream of the ensemble's device (whatever device the
        calling thread has current), so a chunk's copy overlaps the walk
        of the one before; on the CPU the whole matrix at once.  PyTorch's
        caching host allocator records each copy's event and hands a
        staging block out again only after that copy ends, so callers on
        several threads never read each other's rows."""
        dtype = np.float32 if X.dtype == np.float32 else np.float64
        X = np.ascontiguousarray(X, dtype)
        n, F = X.shape
        if n == 0:
            return
        if self.device.type != "cuda":
            yield 0, torch.from_numpy(X)
            return
        rows = min(n, max(1, _CHUNK_BYTES // (X.itemsize * max(F, 1))))
        tdt = torch.float32 if dtype == np.float32 else torch.float64
        stream = torch.cuda.current_stream(self.device)
        for a in range(0, n, rows):
            b = min(n, a + rows)
            host = torch.empty((b - a, F), dtype=tdt, pin_memory=True)
            host.numpy()[:] = X[a:b]
            with torch.cuda.stream(stream):
                Xd = host.to(self.device, non_blocking=True)
            yield a, Xd

    # -- serving hooks ----------------------------------------------- #
    def device_bytes(self) -> int:
        """Device bytes held by this ensemble's tables; equals
        estimate_device_bytes() for the same trees."""
        return int(sum(t.numel() * t.element_size() for t in self.tables
                       if isinstance(t, torch.Tensor)))

    def shape_signature(self, num_features: int) -> tuple:
        """The ensemble's shape for a serving cache key: the kernel takes
        any shape, so two ensembles of equal signature share nothing more
        than their table sizes."""
        lay = self.layout
        return (self.k, lay["T"], lay["N"], lay["L"], lay["C"], lay["W"],
                int(num_features))

    def predict_bucketed(self, X: np.ndarray, num_iteration: int,
                         max_bucket: int = 1 << 20) -> np.ndarray:
        """predict_sum with rows padded to the power-of-two bucket, as the
        JAX serving path does (per-row results are unchanged by padding:
        each row walks alone).  Returns [k, n]."""
        n = X.shape[0]
        B = bucket_rows(n, max_bucket)
        if B > n:
            Xp = np.zeros((B, X.shape[1]),
                          np.float32 if X.dtype == np.float32 else np.float64)
            Xp[:n] = X
        else:
            Xp = X
        return self.predict_sum(Xp, num_iteration)[:, :n]

    def warmup_buckets(self, num_features: int, buckets,
                       num_iteration: int) -> List[int]:
        """Run each bucket size once (the first run builds the kernels), so
        the first real request waits on nothing.  Returns the bucket sizes
        run."""
        done = []
        for b in sorted(set(int(x) for x in buckets)):
            if b <= 0:
                continue
            self.predict_sum(np.zeros((b, num_features), np.float64),
                             num_iteration)
            done.append(b)
        return done
