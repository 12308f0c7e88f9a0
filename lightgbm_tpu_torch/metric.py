"""Evaluation metrics of the port's main path: binary_logloss, auc, l2, rmse.

Port of the matching classes of lightgbm_tpu/metric.py.  Metrics are host
numpy computations on raw scores, converted through the objective where the
reference converts (metric.h:20-40).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .utils import log


class Metric:
    name = "none"
    bigger_is_better = False

    def __init__(self, config=None):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.sum_weights = 0.0

    def init(self, metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, np.float64)
        self.weights = (np.asarray(metadata.weights, np.float64)
                        if metadata.weights is not None else None)
        self.sum_weights = (float(self.weights.sum())
                            if self.weights is not None else float(num_data))

    def eval(self, score: np.ndarray, objective=None) -> List[float]:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        if self.weights is not None:
            return float((losses * self.weights).sum() / self.sum_weights)
        return float(losses.sum() / self.sum_weights)

    def _convert(self, score, objective):
        if objective is not None:
            return np.asarray(objective.convert_output(score))
        return np.asarray(score)


class L2Metric(Metric):
    name = "l2"

    def eval(self, score, objective=None):
        pred = self._convert(score, objective)
        return [self._avg((self.label - pred) ** 2)]


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score, objective=None):
        return [math.sqrt(super().eval(score, objective)[0])]


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective=None):
        prob = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        return [self._avg(np.where(self.label > 0, -np.log(prob),
                                   -np.log(1.0 - prob)))]


class AUCMetric(Metric):
    name = "auc"
    bigger_is_better = True

    def eval(self, score, objective=None):
        # weighted rank-sum AUC (binary_metric.hpp AUCMetric); tied scores
        # share their group's average cumulative weight
        label = self.label
        w = self.weights if self.weights is not None else np.ones_like(label)
        order = np.argsort(score, kind="stable")
        s = np.asarray(score)[order]
        lab = label[order] > 0
        ww = w[order]
        cumw = np.concatenate([[0.0], np.cumsum(ww)])
        new_grp = np.concatenate([[True], s[1:] != s[:-1]])
        grp_id = np.cumsum(new_grp) - 1
        starts = np.flatnonzero(new_grp)
        ends = np.concatenate([starts[1:], [len(s)]])
        avg_rank_w = (cumw[starts[grp_id]] + cumw[ends[grp_id]]) / 2.0
        sum_pos_rank = float((avg_rank_w * ww * lab).sum())
        sum_pos = float((ww * lab).sum())
        sum_neg = float(ww.sum()) - sum_pos
        if sum_pos <= 0 or sum_neg <= 0:
            log.warning("AUC is undefined with only one class; returning 0.5")
            return [0.5]
        return [(sum_pos_rank - sum_pos * sum_pos / 2.0)
                / (sum_pos * sum_neg)]


_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2", "l2_root": "rmse",
    "root_mean_squared_error": "rmse", "rmse": "rmse",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "auc": "auc",
}
_CLASSES = {c.name: c for c in (L2Metric, RMSEMetric, BinaryLoglossMetric,
                                AUCMetric)}


def create_metric(name: str, config=None) -> Metric:
    canon = _ALIASES.get(name.strip().lower())
    if canon is None:
        raise NotImplementedError(
            "metric %r is not ported yet (ROADMAP.md queue 1, item 11)" % name)
    return _CLASSES[canon](config)


def auc(label: np.ndarray, score: np.ndarray) -> float:
    """Unweighted AUC of raw or converted scores."""
    from .io.metadata import Metadata
    m = AUCMetric()
    meta = Metadata(len(label))
    meta.set_label(np.asarray(label))
    m.init(meta, len(label))
    return m.eval(np.asarray(score, np.float64))[0]
