"""Cross-entropy objectives over probability labels in [0, 1].

Port of lightgbm_tpu/objective_xentropy.py (xentropy_objective.hpp):
- CrossEntropy ("xentropy"): p = sigmoid(f); weights scale the loss linearly.
- CrossEntropyLambda ("xentlambda"): p = 1 - exp(-w * log(1+exp(f)));
  ConvertOutput yields the "normalized exponential parameter" lambda, not p.

Gradients in f32 on the score's device, init scores on the host in f64, as
objective.py does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .objective import K_EPSILON, ObjectiveFunction
from .utils import log


def _check_interval(label, name):
    lab = np.asarray(label)
    if lab.min() < 0.0 or lab.max() > 1.0:
        log.fatal("[%s]: label must be in the interval [0, 1]" % name)


def _label_mean(obj) -> float:
    """The (weighted) mean label in f64, the init score's statistic."""
    label = obj._host(obj.label)
    if obj.weights is not None:
        w = obj._host(obj.weights)
        return float((label * w).sum() / w.sum())
    return float(label.mean()) if len(label) else 0.0


class CrossEntropy(ObjectiveFunction):
    """xentropy_objective.hpp:38-137."""

    name = "xentropy"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        _check_interval(metadata.label, self.name)
        if metadata.weights is not None:
            w = np.asarray(metadata.weights)
            if w.min() < 0.0:
                log.fatal("[%s]: at least one weight is negative" % self.name)
            if w.sum() == 0.0:
                log.fatal("[%s]: sum of weights is zero" % self.name)

    def _raw_gradients(self, score):
        z = 1.0 / (1.0 + torch.exp(-score))
        return z - self.label, z * (1.0 - z)

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = min(max(_label_mean(self), K_EPSILON), 1.0 - K_EPSILON)
        init = math.log(pavg / (1.0 - pavg))
        log.info("[xentropy]: pavg = %f -> initscore = %f", pavg, init)
        return init

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-np.asarray(raw)))


class CrossEntropyLambda(ObjectiveFunction):
    """xentropy_objective.hpp:141-250."""

    name = "xentlambda"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        _check_interval(metadata.label, self.name)
        if metadata.weights is not None:
            w = np.asarray(metadata.weights)
            if w.min() <= 0.0:
                log.fatal("[%s]: at least one weight is non-positive"
                          % self.name)

    def get_gradients(self, score):
        # the weighted form is not a linear scaling: no base-class weighting
        if self.weights is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            return z - self.label, z * (1.0 - z)
        w = self.weights
        y = self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        havg = _label_mean(self)
        init = math.log(max(math.exp(havg) - 1.0, K_EPSILON))
        log.info("[xentlambda]: havg = %f -> initscore = %f", havg, init)
        return init

    def convert_output(self, raw):
        # lambda = log(1+exp(f)), not a probability (hpp:219-228)
        return np.log1p(np.exp(np.asarray(raw)))
