# Copied from lightgbm_tpu/metric_multiclass.py; kept in step with it by tests/test_torch_train.py.
"""Multiclass metrics: multi_logloss and multi_error.

Re-design of src/metric/multiclass_metric.hpp: scores arrive flattened
class-major [k*n]; the per-row ConvertOutput loop becomes one vectorized
softmax/sigmoid over the reshaped [k, n] matrix.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .metric import Metric
from .utils import log


class _MulticlassMetric(Metric):
    bigger_is_better = False

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)

    def _probs(self, score: np.ndarray, objective) -> np.ndarray:
        """[k*n] class-major scores -> [n, k] converted predictions."""
        k = self.num_class
        if objective is not None:
            k = objective.num_model_per_iteration
        n = len(self.label)
        mat = np.asarray(score, np.float64).reshape(k, n).T  # [n, k]
        if objective is not None:
            return np.asarray(objective.convert_output_multi(mat))
        return mat

    def point_loss(self, probs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, score, objective=None) -> List[float]:
        losses = self.point_loss(self._probs(score, objective))
        return [self._avg(losses)]


class MultiSoftmaxLoglossMetric(_MulticlassMetric):
    """multi_logloss (MulticlassMetric<MultiSoftmaxLoglossMetric>)."""

    name = "multi_logloss"

    def point_loss(self, probs):
        rows = np.arange(len(self.label))
        p = probs[rows, self.label.astype(np.int64)]
        return -np.log(np.maximum(p, 1e-15))


class MultiErrorMetric(_MulticlassMetric):
    """multi_error: 1 unless the true class strictly beats every other
    class (ties count as errors, multiclass_metric.hpp LossOnPoint)."""

    name = "multi_error"

    def point_loss(self, probs):
        rows = np.arange(len(self.label))
        true_p = probs[rows, self.label.astype(np.int64)]
        masked = probs.copy()
        masked[rows, self.label.astype(np.int64)] = -np.inf
        return (masked.max(axis=1) >= true_p).astype(np.float64)


def create_multiclass_metric(name: str, config) -> Metric:
    name = name.strip().lower()
    if name in ("multi_logloss", "multiclass", "softmax", "multiclassova",
                "multiclass_ova", "ova", "ovr"):
        return MultiSoftmaxLoglossMetric(config)
    if name in ("multi_error",):
        return MultiErrorMetric(config)
    log.fatal("Unknown multiclass metric: %s" % name)
