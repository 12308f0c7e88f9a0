# Copied from lightgbm_tpu/models/shap.py; kept in step with it by tests/test_torch_train.py.
"""TreeSHAP feature contributions.

Behavioral port of Tree::TreeSHAP / ExtendPath / UnwindPath / UnwoundPathSum
(src/io/tree.cpp:649-696, include/LightGBM/tree.h:318-349): the polynomial
time SHAP algorithm (Lundberg et al., arXiv:1706.06060).  Output layout
matches PredictContrib: [n, (F+1)*k] with the per-class expected value in
the last slot.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .tree import Tree


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, i=-1, z=0.0, o=0.0, w=0.0):
        self.feature_index = i
        self.zero_fraction = z
        self.one_fraction = o
        self.pweight = w

    def copy(self):
        return _PathElement(self.feature_index, self.zero_fraction,
                            self.one_fraction, self.pweight)


def _extend_path(path: List[_PathElement], unique_depth: int,
                 zero_fraction: float, one_fraction: float,
                 feature_index: int) -> None:
    path[unique_depth] = _PathElement(
        feature_index, zero_fraction, one_fraction,
        1.0 if unique_depth == 0 else 0.0)
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) \
            / (unique_depth + 1)
        path[i].pweight = zero_fraction * path[i].pweight * (unique_depth - i) \
            / (unique_depth + 1)


def _unwind_path(path: List[_PathElement], unique_depth: int,
                 path_index: int) -> None:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = path[i].pweight * (unique_depth + 1) \
                / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction


def _unwound_path_sum(path: List[_PathElement], unique_depth: int,
                      path_index: int) -> float:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1) \
                / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction \
                * (unique_depth - i) / (unique_depth + 1)
        else:
            total += path[i].pweight / (zero_fraction * (unique_depth - i)
                                        / (unique_depth + 1))
    return total


def _decision(tree: Tree, fval: float, node: int) -> int:
    """Single-sample Decision (tree.h:211-293) for the hot-path choice."""
    dt = tree.decision_type[node]
    if dt & 1:  # categorical
        if np.isnan(fval):
            return tree.right_child[node]
        iv = int(fval)
        if iv < 0:
            return tree.right_child[node]
        from .tree import _find_in_bitset
        cat_idx = int(tree.threshold[node])
        lo, hi = tree.cat_boundaries[cat_idx], tree.cat_boundaries[cat_idx + 1]
        return tree.left_child[node] if _find_in_bitset(
            tree.cat_threshold[lo:hi], iv) else tree.right_child[node]
    mt = (dt >> 2) & 3
    if np.isnan(fval) and mt != 2:
        fval = 0.0
    if (mt == 1 and abs(fval) <= 1e-35) or (mt == 2 and np.isnan(fval)):
        return tree.left_child[node] if dt & 2 else tree.right_child[node]
    return tree.left_child[node] if fval <= tree.threshold[node] \
        else tree.right_child[node]


def _data_count(tree: Tree, node: int) -> float:
    return float(tree.leaf_count[~node] if node < 0
                 else tree.internal_count[node])


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               unique_depth: int, parent_path: List[_PathElement],
               parent_zero_fraction: float, parent_one_fraction: float,
               parent_feature_index: int) -> None:
    path = [p.copy() for p in parent_path[:unique_depth]] + \
        [_PathElement() for _ in range(unique_depth, len(parent_path))]
    _extend_path(path, unique_depth, parent_zero_fraction,
                 parent_one_fraction, parent_feature_index)

    if node < 0:  # leaf
        for i in range(1, unique_depth + 1):
            w = _unwound_path_sum(path, unique_depth, i)
            el = path[i]
            phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) \
                * tree.leaf_value[~node]
        return

    hot = _decision(tree, x[tree.split_feature[node]], node)
    cold = tree.right_child[node] if hot == tree.left_child[node] \
        else tree.left_child[node]
    w = _data_count(tree, node)
    hot_zero_fraction = _data_count(tree, hot) / w
    cold_zero_fraction = _data_count(tree, cold) / w
    incoming_zero_fraction = 1.0
    incoming_one_fraction = 1.0

    path_index = 0
    while path_index <= unique_depth:
        if path[path_index].feature_index == tree.split_feature[node]:
            break
        path_index += 1
    if path_index != unique_depth + 1:
        incoming_zero_fraction = path[path_index].zero_fraction
        incoming_one_fraction = path[path_index].one_fraction
        _unwind_path(path, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(tree, x, phi, hot, unique_depth + 1, path,
               hot_zero_fraction * incoming_zero_fraction,
               incoming_one_fraction, tree.split_feature[node])
    _tree_shap(tree, x, phi, cold, unique_depth + 1, path,
               cold_zero_fraction * incoming_zero_fraction, 0.0,
               tree.split_feature[node])


def predict_contrib(gbdt, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
    """[n, (F+1)] (or [n, (F+1)*k] multiclass) SHAP contributions; last slot
    per class is the model expected value (PredictContrib semantics)."""
    from .gbdt import _dense_matrix
    X = _dense_matrix(X)
    n = X.shape[0]
    F = gbdt.max_feature_idx + 1
    k = max(gbdt.num_tree_per_iteration, 1)
    total_iters = len(gbdt.models) // k
    iters = total_iters if num_iteration <= 0 else min(num_iteration, total_iters)
    out = np.zeros((n, k, F + 1), np.float64)
    for it in range(iters):
        for kk in range(k):
            tree = gbdt.models[it * k + kk]
            max_path = tree.max_depth() + 2
            ev = tree.expected_value()
            out[:, kk, F] += ev
            if tree.num_leaves > 1:
                for r in range(n):
                    path = [_PathElement() for _ in range(max_path)]
                    _tree_shap(tree, X[r], out[r, kk], 0, 0, path, 1.0, 1.0, -1)
    if getattr(gbdt, "average_output", False):
        out /= max(iters, 1)
    return out.reshape(n, k * (F + 1)) if k > 1 else out[:, 0, :]
