"""Multiclass objectives: softmax and one-vs-all.

Port of lightgbm_tpu/objective_multiclass.py (src/objective/
multiclass_objective.hpp:16-259): scores arrive class-major [k, n] and
gradients return in the same layout, computed on the score's device in f32
as one softmax over the class axis (`MulticlassSoftmax`, :20) or one
`BinaryLogloss` a class over binarized labels (`MulticlassOVA`, :118).
The class priors behind `boost_from_score` and `class_need_train` are
computed on the host in f64.  Neither rides the carried arena (the JAX
driver's `_carried_ok` refuses k != 1, lightgbm_tpu/models/gbdt.py:
847-849).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .objective import BinaryLogloss, K_EPSILON, ObjectiveFunction
from .utils import log


def _check_num_class(config) -> int:
    num_class = int(config.num_class)
    if num_class < 2:
        log.fatal("Number of classes should be specified and greater than 1 "
                  "for multiclass training")
    return num_class


class MulticlassSoftmax(ObjectiveFunction):
    """multiclass_objective.hpp:16-160 (lightgbm_tpu/objective_multiclass.
    py:20-93)."""

    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = _check_num_class(config)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label_int = np.asarray(metadata.label).astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class:
            log.fatal("Label must be in [0, %d), but found %d in label"
                      % (self.num_class, int(label_int.min()
                                             if label_int.min() < 0
                                             else label_int.max())))
        # the one-hot labels [k, n] f32, made once: a captured round reads
        # them as it reads the label
        onehot = label_int[None, :] == np.arange(self.num_class)[:, None]
        self._onehot = torch.as_tensor(onehot.astype(np.float32),
                                       device=device)
        # class prior probabilities drive BoostFromScore / ClassNeedTrain
        w = (np.asarray(metadata.weights, np.float64)
             if metadata.weights is not None else np.ones(num_data))
        probs = np.zeros(self.num_class)
        np.add.at(probs, label_int, w)
        self.class_init_probs = probs / max(w.sum(), K_EPSILON)

    def _raw_gradients(self, score):
        p = softmax0(score)
        return p - self._onehot, 2.0 * p * (1.0 - p)

    def boost_from_score(self, class_id: int = 0) -> float:
        return math.log(max(K_EPSILON, self.class_init_probs[class_id]))

    def class_need_train(self, class_id: int) -> bool:
        p = abs(self.class_init_probs[class_id])
        return bool(K_EPSILON < p < 1.0 - K_EPSILON)

    def convert_output_multi(self, raw):
        """raw [n, k] -> softmax probabilities [n, k], f64 on the host."""
        raw = np.asarray(raw, np.float64)
        e = np.exp(raw - raw.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def convert_output(self, raw):
        return self.convert_output_multi(raw)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def to_string(self) -> str:
        return "multiclass num_class:%d" % self.num_class


def softmax0(score: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 0, the maximum subtracted first (Common::Softmax;
    lightgbm_tpu/objective_multiclass.py:96)."""
    e = torch.exp(score - score.max(dim=0, keepdim=True).values)
    return e / e.sum(dim=0, keepdim=True)


class _ClassMetadata:
    """A metadata view whose label is one class binarized (the lambda
    capture in MulticlassOVA's BinaryLogloss construction,
    multiclass_objective.hpp:169-172; lightgbm_tpu/objective_multiclass.
    py:103)."""

    def __init__(self, metadata, class_id: int):
        self._m = metadata
        label = np.asarray(metadata.label)
        self.label = (label.astype(np.int32) == class_id).astype(np.float32)
        self.weights = metadata.weights

    def __getattr__(self, name):
        return getattr(self._m, name)


class MulticlassOVA(ObjectiveFunction):
    """multiclass_objective.hpp:164-259 (lightgbm_tpu/objective_multiclass.
    py:118-179): one independent BinaryLogloss a class over binarized
    labels."""

    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = _check_num_class(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            log.fatal("Sigmoid parameter %f should be greater than zero"
                      % self.sigmoid)
        self.binary_loss = [BinaryLogloss(config)
                            for _ in range(self.num_class)]

    def init(self, metadata, num_data, device):
        self.metadata = metadata
        self.num_data = num_data
        for i, loss in enumerate(self.binary_loss):
            loss.init(_ClassMetadata(metadata, i), num_data, device)

    def get_gradients(self, score):
        grads, hesses = zip(*(loss.get_gradients(score[i])
                              for i, loss in enumerate(self.binary_loss)))
        return torch.stack(grads), torch.stack(hesses)

    def boost_from_score(self, class_id: int = 0) -> float:
        return self.binary_loss[class_id].boost_from_score(0)

    def class_need_train(self, class_id: int) -> bool:
        return self.binary_loss[class_id].class_need_train(0)

    def convert_output_multi(self, raw):
        """raw [n, k] -> each class's sigmoid (no normalization)."""
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(raw,
                                                              np.float64)))

    def convert_output(self, raw):
        return self.convert_output_multi(raw)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def to_string(self) -> str:
        return "multiclassova num_class:%d sigmoid:%g" % (self.num_class,
                                                          self.sigmoid)
