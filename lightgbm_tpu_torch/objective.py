"""Objective functions of the port's main path.

Port of `ObjectiveFunction`, `RegressionL2Loss` (:172) and `BinaryLogloss`
(:421) of lightgbm_tpu/objective.py.  Gradients are computed in f32 on the
score's device with the same elementwise formulas; the boost-from-average
init score (`boost_from_score`) is computed on the host in f64.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .utils import log

K_EPSILON = 1e-15


class ObjectiveFunction:
    """Interface mirror of objective_function.h:13-89."""

    name = "none"

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self.metadata = None

    def init(self, metadata, num_data: int, device) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.label = torch.as_tensor(
            np.asarray(self._transform_label(metadata.label), np.float32),
            device=device)
        self.weights = (torch.as_tensor(np.asarray(metadata.weights,
                                                   np.float32), device=device)
                        if metadata.weights is not None else None)

    def _transform_label(self, label: np.ndarray) -> np.ndarray:
        return label

    def get_gradients(self, score: torch.Tensor):
        """score [n] f32 -> (grad, hess) [n] f32."""
        grad, hess = self._raw_gradients(score)
        if self.weights is not None:
            grad, hess = grad * self.weights, hess * self.weights
        return grad, hess

    def _raw_gradients(self, score):
        raise NotImplementedError

    def carry_ok(self) -> bool:
        """True when the driver may run the carried arena: the gate of the
        JAX objective's `carry_fields` (objective.py:107-111), which is
        None for every objective but the two below."""
        return False

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw):
        return raw

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_string(self) -> str:
        return self.name


class RegressionL2Loss(ObjectiveFunction):
    """regression_objective.hpp RegressionL2loss."""

    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def _transform_label(self, label):
        if self.sqrt:
            return np.sign(label) * np.sqrt(np.abs(label))
        return label

    def _raw_gradients(self, score):
        return score - self.label, torch.ones_like(score)

    def carry_ok(self) -> bool:
        # the exact type: a subclass with other gradients must opt in
        # itself (objective.py:187-193)
        return type(self) is RegressionL2Loss and self.weights is None

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self.label.double().cpu().numpy()
        if self.weights is not None:
            w = self.weights.double().cpu().numpy()
            return float((label * w).sum() / max(w.sum(), K_EPSILON))
        return float(label.mean()) if len(label) else 0.0

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_string(self) -> str:
        return self.name + (" sqrt" if self.sqrt else "")


class BinaryLogloss(ObjectiveFunction):
    """binary_objective.hpp BinaryLogloss."""

    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %f should be greater than zero"
                      % self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        self.need_train = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label = np.asarray(metadata.label)
        pos = int((label > 0).sum())
        neg = num_data - pos
        self.need_train = pos > 0 and neg > 0
        if not self.need_train:
            log.warning("Contains only one class")
        log.info("Number of positive: %d, number of negative: %d", pos, neg)
        w_neg = w_pos = 1.0
        if self.is_unbalance and pos > 0 and neg > 0:
            if pos > neg:
                w_neg = pos / neg
            else:
                w_pos = neg / pos
        w_pos *= self.scale_pos_weight
        self._signed_label = torch.as_tensor(
            np.where(label > 0, 1.0, -1.0).astype(np.float32), device=device)
        self._label_weight = torch.as_tensor(
            np.where(label > 0, w_pos, w_neg).astype(np.float32),
            device=device)
        if metadata.weights is None:
            self._pos_frac = pos / max(1, num_data)
        else:
            w = np.asarray(metadata.weights)
            self._pos_frac = float((w * (label > 0)).sum()
                                   / max(w.sum(), K_EPSILON))

    def _raw_gradients(self, score):
        sl = self._signed_label
        response = -sl * self.sigmoid / (1.0 + torch.exp(sl * self.sigmoid
                                                         * score))
        abs_resp = torch.abs(response)
        grad = response * self._label_weight
        hess = abs_resp * (self.sigmoid - abs_resp) * self._label_weight
        return grad, hess

    def carry_ok(self) -> bool:
        # objective.py:467-475
        return (type(self) is BinaryLogloss and self.weights is None
                and self.need_train)

    def boost_from_score(self, class_id: int = 0) -> float:
        if not self.need_train:
            return 0.0
        pavg = min(max(self._pos_frac, K_EPSILON), 1.0 - K_EPSILON)
        init = math.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info("[binary:BoostFromScore]: pavg=%f -> initscore=%f", pavg,
                 init)
        return init

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(raw)))

    def class_need_train(self, class_id: int) -> bool:
        return self.need_train

    def to_string(self) -> str:
        return "binary sigmoid:%g" % self.sigmoid


_REGISTRY = {}
for _cls, _aliases in (
        (RegressionL2Loss, ("regression_l2", "l2", "mean_squared_error",
                            "mse", "l2_root", "root_mean_squared_error",
                            "rmse")),
        (BinaryLogloss, ())):
    _REGISTRY[_cls.name] = _cls
    for _a in _aliases:
        _REGISTRY[_a] = _cls


def create_objective(name: str, config) -> ObjectiveFunction:
    """Objective by (aliased) name; an objective this slice has not ported
    raises NotImplementedError."""
    key = name.strip().lower()
    if key in ("multiclass", "softmax", "multiclassova", "multiclass_ova",
               "ova", "ovr"):
        raise NotImplementedError(
            "multiclass objectives are not ported yet (ROADMAP.md queue 1, "
            "item 11)")
    cls = _REGISTRY.get(key)
    if cls is None:
        raise NotImplementedError(
            "objective %r is not ported yet: this slice has binary and "
            "regression (L2); the rest is ROADMAP.md queue 1, item 11" % name)
    return cls(config)
