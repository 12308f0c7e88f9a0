# Copied from lightgbm_tpu/metric_xentropy.py; kept in step with it by tests/test_torch_train.py.
"""Cross-entropy metrics: xentropy, xentlambda, kldiv.

Re-design of src/metric/xentropy_metric.hpp, vectorized over rows:
- xentropy: XentLoss(y, p) with p from the objective's ConvertOutput
  (sigmoid when no objective is given: raw scores assumed probabilities).
- xentlambda: XentLoss(y, 1-exp(-w*hhat)), hhat = log(1+exp(f)).
- kldiv: xentropy plus the presummed label-entropy offset.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .metric import Metric
from .utils import log

_LOG_EPS = 1.0e-12


def _xent_loss(label: np.ndarray, prob: np.ndarray) -> np.ndarray:
    """XentLoss (xentropy_metric.hpp:31-46) with clipped log args."""
    a = label * np.log(np.maximum(prob, _LOG_EPS))
    b = (1.0 - label) * np.log(np.maximum(1.0 - prob, _LOG_EPS))
    return -(a + b)


class CrossEntropyMetric(Metric):
    """xentropy_metric.hpp:67-160."""

    name = "cross_entropy"
    bigger_is_better = False

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sum_weights <= 0.0:
            log.fatal("[xentropy]: sum-of-weights is non-positive")

    def _prob(self, score, objective):
        if objective is not None:
            return np.asarray(objective.convert_output(np.asarray(score, np.float64)))
        return np.asarray(score, np.float64)  # assumed already probabilities

    def eval(self, score, objective=None) -> List[float]:
        return [self._avg(_xent_loss(self.label, self._prob(score, objective)))]


class CrossEntropyLambdaMetric(Metric):
    """xentropy_metric.hpp:162-243: weights re-parameterize the probability,
    so the loss average is UNWEIGHTED (divides by num_data)."""

    name = "cross_entropy_lambda"
    bigger_is_better = False

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, np.float64)
        if objective is not None:
            hhat = np.asarray(objective.convert_output(score))
        else:
            hhat = np.log1p(np.exp(score))
        w = self.weights if self.weights is not None else 1.0
        p = 1.0 - np.exp(-w * hhat)
        losses = _xent_loss(self.label, p)
        return [float(losses.sum() / len(self.label))]


class KullbackLeiblerDivergence(CrossEntropyMetric):
    """xentropy_metric.hpp:245-352: cross-entropy + presummed label entropy."""

    name = "kullback_leibler"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        p = self.label
        ent = np.where(p > 0, p * np.log(np.maximum(p, _LOG_EPS)), 0.0)
        ent = ent + np.where(1.0 - p > 0,
                             (1.0 - p) * np.log(np.maximum(1.0 - p, _LOG_EPS)), 0.0)
        if self.weights is not None:
            self.presum_label_entropy = float((ent * self.weights).sum()
                                              / self.sum_weights)
        else:
            self.presum_label_entropy = float(ent.sum() / self.sum_weights)

    def eval(self, score, objective=None) -> List[float]:
        xent = super().eval(score, objective)[0]
        return [self.presum_label_entropy + xent]


def create_xentropy_metric(name: str, config) -> Metric:
    name = name.strip().lower()
    if name in ("xentropy", "cross_entropy"):
        return CrossEntropyMetric(config)
    if name in ("xentlambda", "cross_entropy_lambda"):
        return CrossEntropyLambdaMetric(config)
    if name in ("kldiv", "kullback_leibler"):
        return KullbackLeiblerDivergence(config)
    log.fatal("Unknown xentropy metric: %s" % name)
