"""Evaluation metrics.

Port of lightgbm_tpu/metric.py (src/metric/, factory metric.cpp:11-56):
the regression and binary metrics, `is_bigger_better` over every family and
the factory's dispatch to metric_rank.py, metric_xentropy.py and
metric_multiclass.py; plus
`metrics_from_config` (lightgbm_tpu/basic.py:631 `_metrics_from_config`)
and an `auc` helper.  Metrics consume raw scores and route through the
objective's ConvertOutput where the reference does (metric.h:20-40);
`bigger_is_better` drives early stopping (consumed at gbdt.cpp:517).  They
are host numpy computations but NDCG, which runs where the score lies
(metric_rank.py).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

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
        self.metadata = None

    def init(self, metadata, num_data: int) -> None:
        self.metadata = metadata
        self.label = np.asarray(metadata.label, np.float64)
        self.weights = (np.asarray(metadata.weights, np.float64)
                        if metadata.weights is not None else None)
        self.sum_weights = (float(self.weights.sum()) if self.weights is not None
                            else float(num_data))

    def eval(self, score: np.ndarray, objective=None) -> List[float]:
        raise NotImplementedError

    def _avg(self, losses: np.ndarray) -> float:
        if self.weights is not None:
            return float((losses * self.weights).sum() / self.sum_weights)
        return float(losses.sum() / self.sum_weights)

    def _convert(self, score: np.ndarray, objective) -> np.ndarray:
        if objective is not None:
            return np.asarray(objective.convert_output(score))
        return score


# --- regression metrics (src/metric/regression_metric.hpp) ----------------- #
class _PointwiseMetric(Metric):
    """Average pointwise loss over converted predictions."""
    use_convert = True

    def point_loss(self, label, pred):
        raise NotImplementedError

    def eval(self, score, objective=None):
        pred = self._convert(score, objective) if self.use_convert else score
        return [self._avg(self.point_loss(self.label, pred))]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point_loss(self, label, pred):
        return (label - pred) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score, objective=None):
        return [math.sqrt(super().eval(score, objective)[0])]


class L1Metric(_PointwiseMetric):
    name = "l1"

    def point_loss(self, label, pred):
        return np.abs(label - pred)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def point_loss(self, label, pred):
        a = self.config.alpha
        d = label - pred
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def point_loss(self, label, pred):
        a = self.config.alpha
        d = pred - label
        return np.where(np.abs(d) <= a, 0.5 * d * d, a * (np.abs(d) - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def point_loss(self, label, pred):
        c = self.config.fair_c
        x = np.abs(label - pred)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def point_loss(self, label, pred):
        eps = 1e-10
        pred = np.maximum(pred, eps)
        return pred - label * np.log(pred)


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def point_loss(self, label, pred):
        return np.abs((label - pred)) / np.maximum(1.0, np.abs(label))


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def point_loss(self, label, pred):
        # regression_metric.hpp GammaMetric with psi=1 (lgamma(1)=0, the
        # label-only terms cancel): loss = label/pred + log(pred)
        pred = np.maximum(pred, 1e-10)
        return label / pred + np.log(pred)


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def point_loss(self, label, pred):
        eps = 1e-10
        x = label / np.maximum(pred, eps)
        return 2.0 * (-np.log(np.maximum(x, eps)) + x - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def point_loss(self, label, pred):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        pred = np.maximum(pred, eps)
        a = label * np.exp((1 - rho) * np.log(pred)) / (1 - rho)
        b = np.exp((2 - rho) * np.log(pred)) / (2 - rho)
        return -a + b


# --- binary metrics (src/metric/binary_metric.hpp) ------------------------- #
class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def point_loss(self, label, prob):
        eps = 1e-15
        prob = np.clip(prob, eps, 1 - eps)
        return np.where(label > 0, -np.log(prob), -np.log(1.0 - prob))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def point_loss(self, label, prob):
        pred_pos = prob > 0.5
        return np.where(pred_pos != (label > 0), 1.0, 0.0)


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


# --- factory (metric.cpp:11-56) -------------------------------------------- #
_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc",
}

_CLASSES = {c.name: c for c in [
    L2Metric, RMSEMetric, L1Metric, QuantileMetric, HuberMetric, FairMetric,
    PoissonMetric, MAPEMetric, GammaMetric, GammaDevianceMetric, TweedieMetric,
    BinaryLoglossMetric, BinaryErrorMetric, AUCMetric]}

# metric names (canonical, as reported by eval results) whose larger values
# are better — drives early stopping (metric.h factor_to_bigger_better)
_BIGGER_IS_BETTER_NAMES = {"auc", "ndcg", "map"}


def is_bigger_better(name: str) -> bool:
    """bigger_is_better for ANY metric name, including the lazily-imported
    rank/multiclass/xentropy families (which never enter _CLASSES)."""
    base = name.strip().lower().split("@")[0]
    if base in _BIGGER_IS_BETTER_NAMES:
        return True
    cls = _CLASSES.get(_ALIASES.get(base, base))
    return bool(cls.bigger_is_better) if cls is not None else False


def create_metric(name: str, config) -> Optional[Metric]:
    name = name.strip().lower()
    if name in ("", "none", "null", "na", "custom"):
        return None
    if name in ("multi_logloss", "multiclass", "softmax", "multiclassova",
                "multi_error", "multiclass_ova", "ova", "ovr"):
        from .metric_multiclass import create_multiclass_metric
        return create_multiclass_metric(name, config)
    if name in ("ndcg", "lambdarank", "map", "mean_average_precision"):
        from .metric_rank import create_rank_metric
        return create_rank_metric(name, config)
    if name in ("xentropy", "cross_entropy", "xentlambda",
                "cross_entropy_lambda", "kldiv", "kullback_leibler"):
        from .metric_xentropy import create_xentropy_metric
        return create_xentropy_metric(name, config)
    canon = _ALIASES.get(name)
    if canon is None:
        log.fatal("Unknown metric type name: %s" % name)
    return _CLASSES[canon](config)


def default_metric_for_objective(objective_name: str) -> str:
    """objective alias -> its natural metric (config.cpp metric defaulting)."""
    o = objective_name.strip().lower()
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
    return table.get(o, "l2")


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
