"""Evaluation metrics of the port's main path: binary_logloss, auc, l2, rmse.

Port of the matching classes of lightgbm_tpu/metric.py, its factory and
`is_bigger_better`, and `_metrics_from_config` of lightgbm_tpu/basic.py.
Metrics are host numpy computations on raw scores, converted through the
objective where the reference converts (metric.h:20-40).
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


def create_metric(name: str, config=None) -> Optional[Metric]:
    """The metric of a name or alias; None for "none"; a metric the port
    does not have yet raises."""
    name = name.strip().lower()
    if name in ("", "none", "null", "na", "custom"):
        return None
    canon = _ALIASES.get(name)
    if canon is None:
        raise NotImplementedError(
            "metric %r is not ported yet (ROADMAP.md queue 1, item 11)" % name)
    return _CLASSES[canon](config)


def is_bigger_better(name: str) -> bool:
    """bigger_is_better of a metric name (metric.h factor_to_bigger_better);
    drives early stopping."""
    cls = _CLASSES.get(_ALIASES.get(name.strip().lower(), ""))
    return bool(cls.bigger_is_better) if cls is not None else False


def default_metric_for_objective(objective_name: str) -> str:
    """objective alias -> its natural metric (config.cpp metric
    defaulting; lightgbm_tpu/metric.py:267)."""
    table = {
        "regression": "l2", "regression_l2": "l2", "l2": "l2", "mse": "l2",
        "mean_squared_error": "l2", "l2_root": "rmse", "rmse": "rmse",
        "root_mean_squared_error": "rmse",
        "regression_l1": "l1", "l1": "l1", "mae": "l1",
        "mean_absolute_error": "l1",
        "huber": "huber", "fair": "fair", "poisson": "poisson",
        "quantile": "quantile", "mape": "mape", "gamma": "gamma",
        "tweedie": "tweedie",
        "binary": "binary_logloss",
        "multiclass": "multi_logloss", "softmax": "multi_logloss",
        "multiclassova": "multi_error", "ova": "multi_error",
        "lambdarank": "ndcg",
        "xentropy": "xentropy", "xentlambda": "xentlambda",
    }
    return table.get(objective_name.strip().lower(), "l2")


def metrics_from_config(cfg) -> List[Metric]:
    """The metrics a config asks for, or its objective's default
    (lightgbm_tpu/basic.py:631 `_metrics_from_config`)."""
    names = list(cfg.metric)
    if not names:
        names = [default_metric_for_objective(cfg.objective)]
    metrics = []
    for n in names:
        for sub in n.split(","):
            if sub.strip():
                m = create_metric(sub.strip(), cfg)
                if m is not None:
                    metrics.append(m)
    return metrics


def auc(label: np.ndarray, score: np.ndarray) -> float:
    """Unweighted AUC of raw or converted scores."""
    from .io.metadata import Metadata
    m = AUCMetric()
    meta = Metadata(len(label))
    meta.set_label(np.asarray(label))
    m.init(meta, len(label))
    return m.eval(np.asarray(score, np.float64))[0]
