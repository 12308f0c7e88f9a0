# Copied from lightgbm_tpu/models/tree.py; kept in step with it by tests/test_torch_train.py.
"""Host-side tree model.

Mirror of the reference Tree (include/LightGBM/tree.h:20-391,
src/io/tree.cpp): SoA node arrays, ~leaf child encoding, decision_type
bitfield (categorical/default-left/missing bits), v2 model-text round trip,
and vectorized raw-feature prediction.  Built from the device TreeArrays the
grower produces; kept as numpy for serialization and non-binned prediction.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..utils import log

K_CATEGORICAL_MASK = 1   # tree.h:14
K_DEFAULT_LEFT_MASK = 2  # tree.h:15
K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


def _avoid_inf(x: float) -> float:
    if math.isnan(x):
        return 0.0
    return min(max(x, -1e300), 1e300)


def _array_to_str(arr, fmt="%g") -> str:
    return " ".join(fmt % v for v in arr)


def _repr_double(v: float) -> str:
    return np.format_float_positional(v, precision=17, trim="-", fractional=False) \
        if v == v else "nan"


class Tree:
    """One decision tree with num_leaves leaves / num_leaves-1 internal nodes."""

    def __init__(self, max_leaves: int = 1):
        n = max(max_leaves - 1, 1)
        self.num_leaves = 1
        self.num_cat = 0
        self.split_feature_inner = np.zeros(n, np.int32)
        self.split_feature = np.zeros(n, np.int32)     # raw/real feature idx
        self.threshold_in_bin = np.zeros(n, np.int32)
        self.threshold = np.zeros(n, np.float64)       # real-valued threshold
        self.decision_type = np.zeros(n, np.int8)
        self.left_child = np.zeros(n, np.int32)
        self.right_child = np.zeros(n, np.int32)
        self.split_gain = np.zeros(n, np.float64)
        self.internal_value = np.zeros(n, np.float64)
        self.internal_count = np.zeros(n, np.int32)
        self.leaf_value = np.zeros(max_leaves, np.float64)
        self.leaf_count = np.zeros(max_leaves, np.int32)
        # categorical bitset storage (tree.h cat_boundaries_/cat_threshold_)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []
        self.shrinkage = 1.0

    # ------------------------------------------------------------------ #
    @classmethod
    def from_arrays(cls, arrays, dataset) -> "Tree":
        """Build from device TreeArrays + the BinnedDataset that grew it
        (real thresholds from bin upper bounds, RealThreshold analogue).

        Callers pass HOST arrays (grow_ops.fetch_tree_arrays) — fetching
        per-field here would pay a device round-trip per field."""
        nl = int(arrays.num_leaves)
        t = cls(max(nl, 1))
        t.num_leaves = nl
        if nl <= 1:
            t.leaf_value = np.asarray(arrays.leaf_value[:1], np.float64).copy()
            t.leaf_count = np.asarray(arrays.leaf_count[:1], np.int32).copy()
            return t
        n = nl - 1
        inner = np.asarray(arrays.split_feature[:n], np.int32)
        t.split_feature_inner = inner.copy()
        t.split_feature = np.array(
            [dataset.real_feature_index[f] for f in inner], np.int32)
        t.threshold_in_bin = np.asarray(arrays.threshold_bin[:n], np.int32).copy()
        dl = np.asarray(arrays.default_left[:n])
        mt = np.asarray(arrays.missing_type[:n], np.int32)
        t.decision_type = (np.where(dl, K_DEFAULT_LEFT_MASK, 0)
                           | (mt << 2)).astype(np.int8)
        # categorical nodes: bin-membership masks -> bitset storage; the
        # threshold slot stores the cat_idx into cat_boundaries (Tree::
        # SplitCategorical, include/LightGBM/tree.h:120-148, 489-512)
        if arrays.cat_mask.shape[1] > 0:
            is_cat = np.asarray(arrays.is_cat[:n])
            cat_masks = np.asarray(arrays.cat_mask[:n])
            for node in np.flatnonzero(is_cat):
                t.decision_type[node] |= K_CATEGORICAL_MASK
                cat_idx = t.num_cat
                mapper = dataset.bin_mappers[inner[node]]
                bins_left = np.flatnonzero(cat_masks[node]).tolist()
                cats_left = [int(mapper.bin_2_categorical[b])
                             for b in bins_left
                             if b < len(mapper.bin_2_categorical)]
                cats_left = [c for c in cats_left if c >= 0]
                t.cat_threshold_inner.extend(construct_bitset(bins_left))
                t.cat_boundaries_inner.append(len(t.cat_threshold_inner))
                t.cat_threshold.extend(construct_bitset(cats_left))
                t.cat_boundaries.append(len(t.cat_threshold))
                t.threshold_in_bin[node] = cat_idx
                t.num_cat += 1
        is_cat_nodes = (t.decision_type & K_CATEGORICAL_MASK) > 0
        t.threshold = np.array(
            [float(b) if c else _avoid_inf(dataset.bin_mappers[f].bin_to_value(b))
             for f, b, c in zip(inner, t.threshold_in_bin, is_cat_nodes)],
            np.float64)
        t.left_child = np.asarray(arrays.left_child[:n], np.int32).copy()
        t.right_child = np.asarray(arrays.right_child[:n], np.int32).copy()
        t.split_gain = np.asarray(arrays.split_gain[:n], np.float64).copy()
        t.internal_value = np.asarray(arrays.internal_value[:n], np.float64).copy()
        t.internal_count = np.asarray(arrays.internal_count[:n], np.int32).copy()
        t.leaf_value = np.asarray(arrays.leaf_value[:nl], np.float64).copy()
        t.leaf_count = np.asarray(arrays.leaf_count[:nl], np.int32).copy()
        return t

    # ------------------------------------------------------------------ #
    def to_json(self, index: int = 0) -> dict:
        """Recursive JSON structure (Tree::ToJSON, src/io/tree.cpp:
        NodeToJSON): internal nodes carry split metadata, leaves carry
        value/count; children keys are left_child/right_child."""
        def node(i):
            if i < 0:
                leaf = ~i
                return {"leaf_index": int(leaf),
                        "leaf_value": float(self.leaf_value[leaf]),
                        "leaf_count": int(self.leaf_count[leaf])}
            dt = int(self.decision_type[i])
            is_cat = bool(dt & K_CATEGORICAL_MASK)
            mt = (dt >> 2) & 3
            d = {"split_index": int(i),
                 "split_feature": int(self.split_feature[i]),
                 "split_gain": float(self.split_gain[i]),
                 "threshold": (int(self.threshold[i]) if is_cat
                               else float(self.threshold[i])),
                 "decision_type": "==" if is_cat else "<=",
                 "default_left": bool(dt & K_DEFAULT_LEFT_MASK),
                 "missing_type": ("None", "Zero", "NaN")[min(mt, 2)],
                 "internal_value": float(self.internal_value[i]),
                 "internal_count": int(self.internal_count[i]),
                 "left_child": node(int(self.left_child[i])),
                 "right_child": node(int(self.right_child[i]))}
            if is_cat:
                ci = int(self.threshold[i])
                lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                cats = []
                for w_i, w in enumerate(self.cat_threshold[lo:hi]):
                    for b in range(32):
                        if (w >> b) & 1:
                            cats.append(w_i * 32 + b)
                d["cat_threshold"] = cats
            return d

        out = {"tree_index": int(index),
               "num_leaves": int(self.num_leaves),
               "num_cat": int(self.num_cat),
               "shrinkage": float(self.shrinkage)}
        out["tree_structure"] = (node(0) if self.num_leaves > 1
                                 else {"leaf_value": float(self.leaf_value[0])})
        return out

    # ------------------------------------------------------------------ #
    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:150-161)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """Tree::AddBias (tree.h:163-174)."""
        self.leaf_value = val + self.leaf_value
        self.internal_value = val + self.internal_value
        self.shrinkage = 1.0

    def as_constant(self, val: float) -> None:
        self.num_leaves = 1
        self.leaf_value = np.array([val], np.float64)
        self.leaf_count = np.zeros(1, np.int32)

    def expected_value(self) -> float:
        """Weighted mean output (used by SHAP base value)."""
        if self.num_leaves == 1:
            return float(self.leaf_value[0])
        total = max(int(self.internal_count[0]), 1)
        return float((self.leaf_value[:self.num_leaves]
                      * self.leaf_count[:self.num_leaves]).sum() / total)

    # ------------------------------------------------------------------ #
    # Prediction over raw feature values (NumericalDecision, tree.h:211-293)
    # ------------------------------------------------------------------ #
    def predict(self, X: np.ndarray) -> np.ndarray:
        leaf = self.predict_leaf_index(X)
        return self.leaf_value[leaf]

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)
        active = node >= 0
        while active.any():
            nd = node[active]
            fv = X[active, self.split_feature[nd]].astype(np.float64)
            mt = (self.decision_type[nd] >> 2) & 3
            is_cat = (self.decision_type[nd] & K_CATEGORICAL_MASK) > 0
            dl = (self.decision_type[nd] & K_DEFAULT_LEFT_MASK) > 0
            thr = self.threshold[nd]

            nan_mask = np.isnan(fv)
            fv_num = np.where(nan_mask & (mt != MISSING_NAN), 0.0, fv)
            is_zero = np.abs(fv_num) <= K_ZERO_THRESHOLD
            missing = ((mt == MISSING_ZERO) & is_zero) | \
                      ((mt == MISSING_NAN) & np.isnan(fv_num))
            go_left = np.where(missing, dl, fv_num <= thr)

            if is_cat.any():
                cat_left = self._categorical_go_left(fv, nd)
                go_left = np.where(is_cat, cat_left, go_left)

            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            node[active] = nxt
            active = node >= 0
        return (~node).astype(np.int32)

    def _categorical_go_left(self, fv: np.ndarray, nd: np.ndarray) -> np.ndarray:
        """CategoricalDecision (tree.h:249-267): bitset membership,
        vectorized over rows."""
        is_cat = (self.decision_type[nd] & K_CATEGORICAL_MASK) > 0
        # int truncation toward zero like static_cast<int>: -0.5 tests
        # category 0, values <= -1 are non-members
        iv = np.where(is_cat & ~np.isnan(fv), fv, 0).astype(np.int64)
        valid = is_cat & ~np.isnan(fv) & (iv >= 0)
        ci = np.where(is_cat, self.threshold[nd], 0).astype(np.int64)
        cb = np.asarray(self.cat_boundaries, np.int64)
        lo = cb[np.clip(ci, 0, len(cb) - 2)]
        hi = cb[np.clip(ci, 0, len(cb) - 2) + 1]
        word = lo + iv // 32
        in_bounds = word < hi
        bits = np.asarray(self.cat_threshold, np.uint32)[
            np.clip(word, 0, max(len(self.cat_threshold) - 1, 0))] \
            if len(self.cat_threshold) else np.zeros(len(fv), np.uint32)
        member = ((bits >> (iv % 32).astype(np.uint32)) & 1) > 0
        return valid & in_bounds & member

    def predict_leaf_index_binned(self, bins: np.ndarray, dataset) -> np.ndarray:
        """DecisionInner walk over inner bin values (host variant)."""
        n = bins.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        num_bins = dataset.feature_num_bins()
        default_bins = np.array([m.default_bin for m in dataset.bin_mappers])
        node = np.zeros(n, np.int32)
        active = node >= 0
        while active.any():
            nd = node[active]
            f = self.split_feature_inner[nd]
            col = bins[active, f].astype(np.int64)
            mt = (self.decision_type[nd] >> 2) & 3
            is_cat = (self.decision_type[nd] & K_CATEGORICAL_MASK) > 0
            dl = (self.decision_type[nd] & K_DEFAULT_LEFT_MASK) > 0
            missing = ((mt == MISSING_ZERO) & (col == default_bins[f])) | \
                      ((mt == MISSING_NAN) & (col == num_bins[f] - 1))
            go_left = np.where(missing, dl, col <= self.threshold_in_bin[nd])
            if is_cat.any():
                cat_left = np.zeros(len(col), bool)
                for i in np.flatnonzero(is_cat):
                    cat_idx = int(self.threshold_in_bin[nd[i]])
                    lo = self.cat_boundaries_inner[cat_idx]
                    hi = self.cat_boundaries_inner[cat_idx + 1]
                    cat_left[i] = _find_in_bitset(
                        self.cat_threshold_inner[lo:hi], int(col[i]))
                go_left = np.where(is_cat, cat_left, go_left)
            node[active] = np.where(go_left, self.left_child[nd],
                                    self.right_child[nd])
            active = node >= 0
        return (~node).astype(np.int32)

    # ------------------------------------------------------------------ #
    # v2 model text (Tree::ToString, src/io/tree.cpp:207-240)
    # ------------------------------------------------------------------ #
    def to_string(self) -> str:
        n = self.num_leaves - 1
        out = []
        out.append("num_leaves=%d" % self.num_leaves)
        out.append("num_cat=%d" % self.num_cat)
        if n > 0:
            out.append("split_feature=" + _array_to_str(self.split_feature[:n], "%d"))
            out.append("split_gain=" + _array_to_str(self.split_gain[:n]))
            out.append("threshold=" + " ".join(
                _repr_double(v) for v in self.threshold[:n]))
            out.append("decision_type=" + _array_to_str(self.decision_type[:n], "%d"))
            out.append("left_child=" + _array_to_str(self.left_child[:n], "%d"))
            out.append("right_child=" + _array_to_str(self.right_child[:n], "%d"))
        out.append("leaf_value=" + " ".join(
            _repr_double(v) for v in self.leaf_value[:self.num_leaves]))
        out.append("leaf_count=" + _array_to_str(self.leaf_count[:self.num_leaves], "%d"))
        if n > 0:
            out.append("internal_value=" + _array_to_str(self.internal_value[:n]))
            out.append("internal_count=" + _array_to_str(self.internal_count[:n], "%d"))
        if self.num_cat > 0:
            out.append("cat_boundaries=" + _array_to_str(self.cat_boundaries, "%d"))
            out.append("cat_threshold=" + _array_to_str(self.cat_threshold, "%d"))
        out.append("shrinkage=%g" % self.shrinkage)
        out.append("")
        return "\n".join(out)

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        """Parse one Tree=... block (Tree::Tree(const char*), tree.cpp:377+)."""
        kv: Dict[str, str] = {}
        for line in text.strip().split("\n"):
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        if "num_leaves" not in kv:
            log.fatal("Tree model string format error: no num_leaves")
        nl = int(kv["num_leaves"])
        t = cls(max(nl, 1))
        t.num_leaves = nl
        t.num_cat = int(kv.get("num_cat", "0"))
        t.shrinkage = float(kv.get("shrinkage", "1"))

        def parse(key, dtype, count):
            if key not in kv or count == 0:
                return None
            vals = kv[key].split()
            return np.array([dtype(x) for x in vals[:count]])

        n = nl - 1
        if n > 0:
            t.split_feature = parse("split_feature", int, n).astype(np.int32)
            t.split_feature_inner = t.split_feature.copy()
            sg = parse("split_gain", float, n)
            t.split_gain = sg.astype(np.float64) if sg is not None else np.zeros(n)
            t.threshold = parse("threshold", float, n).astype(np.float64)
            t.decision_type = parse("decision_type", int, n).astype(np.int8)
            t.left_child = parse("left_child", int, n).astype(np.int32)
            t.right_child = parse("right_child", int, n).astype(np.int32)
            iv = parse("internal_value", float, n)
            t.internal_value = iv.astype(np.float64) if iv is not None else np.zeros(n)
            ic = parse("internal_count", int, n)
            t.internal_count = ic.astype(np.int32) if ic is not None else np.zeros(n, np.int32)
        t.leaf_value = parse("leaf_value", float, nl).astype(np.float64)
        lc = parse("leaf_count", int, nl)
        t.leaf_count = (lc.astype(np.int32) if lc is not None
                        else np.zeros(nl, np.int32))
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
            t.cat_boundaries_inner = list(t.cat_boundaries)
            t.cat_threshold_inner = list(t.cat_threshold)
        return t

    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        depth = {0: 1}
        best = 1
        stack = [0]
        while stack:
            nd = stack.pop()
            for child in (self.left_child[nd], self.right_child[nd]):
                if child >= 0:
                    depth[child] = depth[nd] + 1
                    best = max(best, depth[child])
                    stack.append(child)
        return best


def _find_in_bitset(bits: List[int], pos: int) -> bool:
    """Common::FindInBitset (utils/common.h:843-851)."""
    i1 = pos // 32
    if i1 >= len(bits):
        return False
    return ((bits[i1] >> (pos % 32)) & 1) > 0


def construct_bitset(values) -> List[int]:
    """Common::ConstructBitset: category list -> uint32 words."""
    if len(values) == 0:
        return []
    out = [0] * (max(values) // 32 + 1)
    for v in values:
        out[v // 32] |= (1 << (v % 32))
    return out
