"""Objective functions.

Port of lightgbm_tpu/objective.py: `ObjectiveFunction`, the regression
family (L2 :172, L1 :228, Huber :252, Fair :271, Poisson :294, Quantile
:327, MAPE :362, Gamma :394, Tweedie :403), `BinaryLogloss` (:421), the
percentile helpers (:29-66) and the factory with its aliases (:534-578).
Gradients are computed in f32 on the score's device with the same
elementwise formulas; init scores (`boost_from_score`) are computed on the
host in f64.  Ranking, cross-entropy and multiclass live in objective_rank.py,
objective_xentropy.py and objective_multiclass.py, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .utils import log

K_EPSILON = 1e-15


# Copied from lightgbm_tpu/objective.py:29-66.
def percentile(data: np.ndarray, alpha: float) -> float:
    """PercentileFun: descending-order interpolated percentile."""
    n = len(data)
    if n <= 1:
        return float(data[0]) if n else 0.0
    d = np.sort(np.asarray(data, np.float64))[::-1]
    float_pos = (1.0 - alpha) * n
    pos = int(float_pos)
    if pos < 1:
        return float(d[0])
    if pos >= n:
        return float(d[-1])
    bias = float_pos - pos
    v1, v2 = d[pos - 1], d[pos]
    return float(v1 - (v1 - v2) * bias)


def weighted_percentile(data: np.ndarray, weights: np.ndarray, alpha: float) -> float:
    """WeightedPercentileFun: CDF-interpolated weighted percentile."""
    n = len(data)
    if n <= 1:
        return float(data[0]) if n else 0.0
    order = np.argsort(np.asarray(data, np.float64), kind="stable")
    cdf = np.cumsum(np.asarray(weights, np.float64)[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(data[order[pos]])
    v1 = float(data[order[pos - 1]])
    v2 = float(data[order[pos]])
    if pos + 1 < n and cdf[pos + 1] - cdf[pos] > K_EPSILON:
        return (threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) * (v2 - v1) + v1
    return v2


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

    def is_renew_tree_output(self) -> bool:
        """True for the objectives whose leaves are refit to a percentile of
        their residuals after each tree (L1, quantile, MAPE)."""
        return False

    def renew_alpha(self) -> float:
        """The percentile of a leaf refit: the median, quantile's alpha."""
        return 0.5

    def renew_weights(self) -> Optional[torch.Tensor]:
        """The weights of a leaf refit's percentile: the rows' weights,
        MAPE's 1/|label| in their place."""
        return self.weights

    def class_need_train(self, class_id: int) -> bool:
        return True

    @property
    def num_model_per_iteration(self) -> int:
        """Trees an iteration grows: one, k for the multiclass objectives."""
        return 1

    def to_string(self) -> str:
        return self.name

    def _host(self, t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
        """A device vector of the objective as host f64."""
        return None if t is None else t.double().cpu().numpy()


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
        label = self._host(self.label)
        if self.weights is not None:
            w = self._host(self.weights)
            return float((label * w).sum() / max(w.sum(), K_EPSILON))
        return float(label.mean()) if len(label) else 0.0

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_string(self) -> str:
        return self.name + (" sqrt" if self.sqrt else "")


class RegressionL1Loss(RegressionL2Loss):
    name = "regression_l1"

    def _raw_gradients(self, score):
        return torch.sign(score - self.label), torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self._host(self.label)
        if self.weights is not None:
            return weighted_percentile(label, self._host(self.weights), 0.5)
        return percentile(label, 0.5)

    def is_renew_tree_output(self) -> bool:
        return True


class RegressionHuberLoss(RegressionL2Loss):
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if self.alpha <= 0:
            log.fatal("alpha should be greater than zero")

    def _raw_gradients(self, score):
        diff = score - self.label
        grad = torch.where(diff.abs() <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return grad, torch.ones_like(score)


class RegressionFairLoss(RegressionL2Loss):
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def _raw_gradients(self, score):
        x = score - self.label
        grad = self.c * x / (x.abs() + self.c)
        hess = self.c * self.c / ((x.abs() + self.c) ** 2)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0


class RegressionPoissonLoss(RegressionL2Loss):
    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if float(self.label.min()) < 0:
            log.fatal("[poisson]: at least one target label is negative")

    def _raw_gradients(self, score):
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + self.max_delta_step)
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = RegressionL2Loss.boost_from_score(self, class_id)
        return math.log(max(mean, 1e-20))

    def convert_output(self, raw):
        return np.exp(raw)


class RegressionQuantileLoss(RegressionL2Loss):
    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not 0 < self.alpha < 1:
            log.fatal("alpha should be in (0, 1)")

    def _raw_gradients(self, score):
        delta = score - self.label
        grad = torch.where(delta >= 0, 1.0 - self.alpha, -self.alpha)
        return grad.to(score.dtype), torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        label = self._host(self.label)
        if self.weights is not None:
            return weighted_percentile(label, self._host(self.weights),
                                       self.alpha)
        return percentile(label, self.alpha)

    def is_renew_tree_output(self) -> bool:
        return True

    def renew_alpha(self) -> float:
        return self.alpha


class RegressionMAPELoss(RegressionL1Loss):
    name = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label = np.asarray(metadata.label, np.float64)
        if (np.abs(label) < 1).any():
            log.warning("Some label values are < 1 in absolute value. "
                        "MAPE is unstable with such values, so LightGBM "
                        "rounds them to 1.0 when calculating MAPE.")
        self.label_weight = torch.as_tensor(
            (1.0 / np.maximum(1.0, np.abs(label))).astype(np.float32),
            device=device)

    def _raw_gradients(self, score):
        diff = score - self.label
        return torch.sign(diff) * self.label_weight, torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._host(self.label),
                                   self._host(self.label_weight), 0.5)

    def renew_weights(self) -> Optional[torch.Tensor]:
        return self.label_weight


class RegressionGammaLoss(RegressionPoissonLoss):
    name = "gamma"

    def _raw_gradients(self, score):
        grad = 1.0 - self.label * torch.exp(-score)
        hess = self.label * torch.exp(-score)
        return grad, hess


class RegressionTweedieLoss(RegressionPoissonLoss):
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def _raw_gradients(self, score):
        e1 = torch.exp((1 - self.rho) * score)
        e2 = torch.exp((2 - self.rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1 - self.rho) * e1 + (2 - self.rho) * e2
        return grad, hess


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


def _register(cls, *aliases):
    _REGISTRY[cls.name] = cls
    for a in aliases:
        _REGISTRY[a] = cls


# lightgbm_tpu/objective.py:534-578
_register(RegressionL2Loss, "regression_l2", "l2", "mean_squared_error", "mse",
          "l2_root", "root_mean_squared_error", "rmse")
_register(RegressionL1Loss, "l1", "mean_absolute_error", "mae")
_register(RegressionHuberLoss)
_register(RegressionFairLoss)
_register(RegressionPoissonLoss)
_register(RegressionQuantileLoss)
_register(RegressionMAPELoss, "mean_absolute_percentage_error")
_register(RegressionGammaLoss)
_register(RegressionTweedieLoss)
_register(BinaryLogloss)


def create_objective(name: str, config) -> Optional[ObjectiveFunction]:
    """Objective by (aliased) name (lightgbm_tpu/objective.py:548-575);
    None for "none" (a custom objective); an unknown name is fatal."""
    key = name.strip().lower()
    if key in ("none", "null", "custom", "na", ""):
        return None
    if key in ("multiclass", "softmax", "multiclassova", "multiclass_ova",
               "ova", "ovr"):
        from .objective_multiclass import MulticlassOVA, MulticlassSoftmax
        return (MulticlassSoftmax if key in ("multiclass", "softmax")
                else MulticlassOVA)(config)
    if key in ("lambdarank", "rank"):
        from .objective_rank import LambdarankNDCG
        return LambdarankNDCG(config)
    if key in ("xentropy", "cross_entropy"):
        from .objective_xentropy import CrossEntropy
        return CrossEntropy(config)
    if key in ("xentlambda", "cross_entropy_lambda"):
        from .objective_xentropy import CrossEntropyLambda
        return CrossEntropyLambda(config)
    cls = _REGISTRY.get(key)
    if cls is None:
        log.fatal("Unknown objective type name: %s" % name)
    return cls(config)
