"""Device prediction over raw features: the ensemble's walk tables.

Port of lightgbm_tpu/ops/predict.py.  The JAX package rides the TPU's
matrix unit: a dense [rows, T*N] decision tensor, a bf16 [T, L, N]
path-signature tensor and one einsum per row chunk (`_chunk_scores`
:322-364), thresholds compared in double-single f32 and leaf values
summed in f32.  On an H100 that is 2 rows T L N operations where a walk
reads about depth x T nodes a row, so the port walks: KP1
(ops/predict_kernel.predict_ensemble, csrc/predict_ensemble.cu) takes one
thread a row through every tree, comparing and summing in f64.  Its sums
equal the host walk (`out += tree.predict(X)` in models/tree.py) bit for
bit, which the JAX design could not.

The ensemble is held as walk tables, concatenated over the trees:
- per node, at the [T+1] node offset: raw split feature (int32),
  threshold (f64; a categorical node's bitset index), decision bits
  (int8: categorical, default-left, missing type) and the two children
  (int32, ~leaf for a leaf);
- per leaf, at the [T+1] leaf offset: the value (f64, the host tree's
  shrunk values with their bias);
- for categorical nodes, at the [T+1] boundary offset: each tree's
  `cat_boundaries`, rebased onto the concatenated `cat_threshold` words
  (uint32, held as int32 bits).
No table grows as T L N, so every ensemble builds (`ok` is always True).

Tree t adds to class t % k, as JAX's final reshape does.  X reaches the
card as f64 in row chunks of at most _CHUNK_BYTES through pinned staging,
and the output is fetched once, at the end.  On the CPU the tables and
X stay there and the plain version runs.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

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
    node_off: torch.Tensor     # int32 [T+1]
    leaf_off: torch.Tensor     # int32 [T+1]
    cat_off: torch.Tensor      # int32 [T+1]
    feature: torch.Tensor      # int32 [max(N, 1)] raw feature
    threshold: torch.Tensor    # f64   [max(N, 1)]
    decision: torch.Tensor     # int8  [max(N, 1)] decision_type bits
    left: torch.Tensor         # int32 [max(N, 1)]
    right: torch.Tensor        # int32 [max(N, 1)]
    leaf_value: torch.Tensor   # f64   [max(L, 1)]
    cat_bound: torch.Tensor    # int32 [max(C, 1)] absolute word offsets
    cat_words: torch.Tensor    # int32 [max(W, 1)] uint32 bitset words
    max_feature: int           # the largest raw feature a node reads, -1


# bytes a table entry of each kind holds: a tree's three offsets, a node,
# a leaf, a boundary, a word
_TREE_BYTES = 3 * 4
_NODE_BYTES = 4 + 8 + 1 + 4 + 4
_LEAF_BYTES = 8
_BOUND_BYTES = 4
_WORD_BYTES = 4


def ensemble_layout(trees: List, num_classes: int) -> dict:
    """The sizes of the walk tables DeviceEnsemble builds for these trees,
    computed without touching the device: k, the trees T, the nodes N,
    the leaves L, the categorical boundaries C and bitset words W.
    `ok` is always True: no table grows as T L N, so every ensemble
    builds (the JAX layout's signature tensor could refuse one)."""
    N = sum(max(t.num_leaves - 1, 0) for t in trees)
    L = sum(max(t.num_leaves, 1) for t in trees)
    C = sum(len(t.cat_boundaries) for t in trees if t.num_cat > 0)
    W = sum(len(t.cat_threshold) for t in trees if t.num_cat > 0)
    return {"k": max(num_classes, 1), "T": len(trees), "N": N, "L": L,
            "C": C, "W": W, "ok": True}


def estimate_device_bytes(trees: List, num_classes: int) -> int:
    """Device bytes the DeviceEnsemble for `trees` holds, from the layout
    alone: equal to device_bytes() of the built ensemble, so a byte budget
    reserved before the build never drifts from the accounting after it
    (lightgbm_tpu/ops/predict.py:110)."""
    lay = ensemble_layout(trees, num_classes)
    return int((lay["T"] + 1) * _TREE_BYTES
               + max(lay["N"], 1) * _NODE_BYTES
               + max(lay["L"], 1) * _LEAF_BYTES
               + max(lay["C"], 1) * _BOUND_BYTES
               + max(lay["W"], 1) * _WORD_BYTES)


def build_tables(trees: List, device) -> EnsembleTables:
    """The walk tables of `trees` on `device`."""
    lay = ensemble_layout(trees, 1)
    N, L = max(lay["N"], 1), max(lay["L"], 1)
    node_off = np.zeros(len(trees) + 1, np.int32)
    leaf_off = np.zeros(len(trees) + 1, np.int32)
    cat_off = np.zeros(len(trees) + 1, np.int32)
    feature = np.zeros(N, np.int32)
    threshold = np.zeros(N, np.float64)
    decision = np.zeros(N, np.int8)
    left = np.zeros(N, np.int32)
    right = np.zeros(N, np.int32)
    leaf_value = np.zeros(L, np.float64)
    bounds: List[int] = []
    words: List[int] = []
    na = la = 0
    for ti, t in enumerate(trees):
        nn, nl = max(t.num_leaves - 1, 0), max(t.num_leaves, 1)
        feature[na:na + nn] = t.split_feature[:nn]
        threshold[na:na + nn] = t.threshold[:nn]
        decision[na:na + nn] = t.decision_type[:nn]
        left[na:na + nn] = t.left_child[:nn]
        right[na:na + nn] = t.right_child[:nn]
        leaf_value[la:la + nl] = t.leaf_value[:nl]
        if t.num_cat > 0:
            bounds.extend(len(words) + int(b) for b in t.cat_boundaries)
            words.extend(int(w) for w in t.cat_threshold)
        na += nn
        la += nl
        node_off[ti + 1], leaf_off[ti + 1] = na, la
        cat_off[ti + 1] = len(bounds)
    cat_bound = np.array(bounds or [0], np.int32)
    cat_words = np.array(words or [0], np.uint32).view(np.int32)

    def dev(a):
        return torch.as_tensor(a, device=device)
    return EnsembleTables(dev(node_off), dev(leaf_off), dev(cat_off),
                          dev(feature), dev(threshold), dev(decision),
                          dev(left), dev(right), dev(leaf_value),
                          dev(cat_bound), dev(cat_words),
                          int(feature[:na].max()) if na else -1)


# --------------------------------------------------------------------------- #
# KP1's plain version
# --------------------------------------------------------------------------- #
def _cat_left(tb: EnsembleTables, cat0: int, i: torch.Tensor,
              v: torch.Tensor, is_cat: torch.Tensor) -> torch.Tensor:
    """CategoricalDecision (models/tree.py `_categorical_go_left`): the
    value truncated toward zero is a member of node i's bitset; NaN,
    negative ids and ids past the bitset are non-members."""
    nan = torch.isnan(v)
    iv = torch.where(is_cat & ~nan, v, 0.0).to(torch.int64)
    valid = is_cat & ~nan & (iv >= 0)
    iv = torch.where(valid, iv, 0)
    ci = torch.where(is_cat, tb.threshold[i], 0.0).to(torch.int64)
    b = (cat0 + ci).clamp(0, tb.cat_bound.shape[0] - 2)
    lo = tb.cat_bound[b].long()
    hi = tb.cat_bound[b + 1].long()
    word = lo + iv // 32
    in_bounds = word < hi
    bits = tb.cat_words[word.clamp(0, tb.cat_words.shape[0] - 1)].long()
    member = ((bits & 0xFFFFFFFF) >> (iv % 32)) & 1
    return valid & in_bounds & (member > 0)


def _tree_leaf(tb: EnsembleTables, offs: tuple, X: torch.Tensor,
               t: int) -> torch.Tensor:
    """The leaf (int64 [m]) of tree t for every row of X [m, F] f64, by the
    host walk's decisions (models/tree.py Tree.predict_leaf_index), all
    rows at once, level by level until every row rests at a leaf."""
    node_off, _, cat_off = offs
    base, end = node_off[t], node_off[t + 1]
    m = X.shape[0]
    node = torch.full((m,), 0 if end > base else -1, dtype=torch.int64,
                      device=X.device)
    active = node >= 0
    while bool(active.any()):
        i = base + node.clamp_min(0)
        v = X.gather(1, tb.feature[i].long()[:, None])[:, 0]
        dec = tb.decision[i].long()
        mt = (dec >> 2) & 3
        vn = torch.where(torch.isnan(v) & (mt != MISSING_NAN), 0.0, v)
        zero = vn.abs() <= K_ZERO_THRESHOLD
        missing = (((mt == MISSING_ZERO) & zero)
                   | ((mt == MISSING_NAN) & torch.isnan(vn)))
        go_left = torch.where(missing, (dec & 2) != 0, vn <= tb.threshold[i])
        is_cat = (dec & 1) != 0
        if bool(is_cat.any()):
            go_left = torch.where(is_cat, _cat_left(tb, cat_off[t], i, v,
                                                     is_cat), go_left)
        nxt = torch.where(go_left, tb.left[i], tb.right[i]).long()
        node = torch.where(active, nxt, node)
        active = node >= 0
    return ~node


MODE_SUM, MODE_SUM_EARLY_STOP, MODE_LEAF = 0, 1, 2


def predict_ensemble_plain(tb: EnsembleTables, X: torch.Tensor, T: int,
                           k: int, mode: int = MODE_SUM, freq: int = 0,
                           margin: float = 0.0) -> torch.Tensor:
    """KP1 in plain PyTorch: the trees t < T walked over every row of X
    [m, F] f64, one tree at a time.  Sum modes return [k, m] f64, each
    row's leaf values added in tree order in f64 (tree t to class t % k);
    with early stop (k = 1) a row stops before tree t, t a positive
    multiple of freq, once 2|sum| < margin fails.  Leaf mode returns
    [m, T] int32."""
    offs = (tb.node_off.tolist(), tb.leaf_off.tolist(), tb.cat_off.tolist())
    m = X.shape[0]
    if mode == MODE_LEAF:
        out = torch.zeros((m, T), dtype=torch.int32, device=X.device)
        for t in range(T):
            out[:, t] = _tree_leaf(tb, offs, X, t).to(torch.int32)
        return out
    out = torch.zeros((k, m), dtype=torch.float64, device=X.device)
    active = torch.ones(m, dtype=torch.bool, device=X.device)
    for t in range(T):
        if mode == MODE_SUM_EARLY_STOP and t > 0 and t % freq == 0:
            active &= 2.0 * out[0].abs() < margin
        value = tb.leaf_value[offs[1][t] + _tree_leaf(tb, offs, X, t)]
        c = t % k
        out[c] = torch.where(active, out[c] + value, out[c])
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
        # the card's two pinned staging buffers of X and the events of
        # their last copies (_chunks)
        self._staging: List[torch.Tensor] = []
        self._events: List[Optional[torch.cuda.Event]] = [None, None]

    def _trees(self, num_iteration: int) -> int:
        return min(max(num_iteration, 0) * self.k, self.num_trees)

    def predict_sum(self, X: np.ndarray, num_iteration: int,
                    early_stop_freq: int = 0,
                    early_stop_margin: float = 0.0) -> np.ndarray:
        """[k, n] f64 summed raw scores over the first num_iteration*k
        trees; early_stop_freq > 0 (k = 1) stops a row once its margin
        reaches early_stop_margin, checked every early_stop_freq trees."""
        from .predict_kernel import predict_ensemble
        if early_stop_freq > 0 and self.k != 1:
            raise NotImplementedError(
                "prediction early stop of a multiclass ensemble is not "
                "ported yet (ROADMAP.md queue 1, item 11)")
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
        """(first row, f64 rows on the device) of X: on the card in chunks
        of at most _CHUNK_BYTES through two pinned staging buffers, so a
        chunk's copy overlaps the walk of the one before; on the CPU the
        whole matrix at once."""
        X = np.ascontiguousarray(X, np.float64)
        n, F = X.shape
        if n == 0:
            return
        if self.device.type != "cuda":
            yield 0, torch.from_numpy(X)
            return
        rows = min(n, max(1, _CHUNK_BYTES // (8 * max(F, 1))))
        if not self._staging or self._staging[0].shape[0] < rows \
                or self._staging[0].shape[1] != F:
            for ev in self._events:
                if ev is not None:
                    ev.synchronize()
            self._staging = [torch.empty((rows, F), dtype=torch.float64,
                                         pin_memory=True) for _ in range(2)]
        for i, a in enumerate(range(0, n, rows)):
            b = min(n, a + rows)
            j = i % 2
            if self._events[j] is not None:
                self._events[j].synchronize()
            host = self._staging[j][:b - a]
            host.numpy()[:] = X[a:b]
            Xd = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._events[j] = ev
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
            Xp = np.zeros((B, X.shape[1]), np.float64)
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
