"""DART boosting (src/boosting/dart.hpp:17-205).

Port of lightgbm_tpu/models/dart.py (its resilience hooks, :40-102, are not
ported: ROADMAP.md queue 1, item 14): before each iteration a random subset
of the trees is dropped from the training score, the new tree is fit to the
rest of the ensemble's residuals, then the dropped trees and the new one
are renormalized.  The drops and the rescaled trees reach the training
score and the validation scores through KP2's add mode on their bins.
DART changes old trees within an iteration, so it fetches every tree in
its round (`_allow_deferred`), and every iteration that rescales trees
bumps the model's generation, which keys the device ensemble's cache.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .gbdt import GBDT


class DART(GBDT):
    """Dropout boosting (dart.py:12-176)."""

    _allow_deferred = False

    def __init__(self, config, train_set, objective, device):
        super().__init__(config, train_set, objective, device)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_index: List[int] = []

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._dropping_trees()
        if super().train_one_iter(gradients, hessians):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    # -- dropping (dart.hpp:88-140, dart.py:104-149) ----------------------
    def _dropping_trees(self) -> None:
        self._drop_index = []
        cfg = self.config
        is_skip = self._drop_rng.rand() < cfg.skip_drop
        if not is_skip and self.iter > 0:
            drop_rate = cfg.drop_rate
            # max_drop <= 0 means no limit (the reference's size_t cast of a
            # negative value, dart.hpp:105)
            max_drop = cfg.max_drop if cfg.max_drop > 0 else self.iter + 1
            if not cfg.uniform_drop:
                inv_avg = len(self.tree_weight) / self.sum_weight \
                    if self.sum_weight > 0 else 0.0
                if cfg.max_drop > 0 and self.sum_weight > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight)
                for i in range(self.iter):
                    if self._drop_rng.rand() < \
                            drop_rate * self.tree_weight[i] * inv_avg:
                        self._drop_index.append(i)
                        if len(self._drop_index) >= max_drop:
                            break
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter))
                for i in range(self.iter):
                    if self._drop_rng.rand() < drop_rate:
                        self._drop_index.append(i)
                        if len(self._drop_index) >= max_drop:
                            break
        k = self.num_tree_per_iteration
        if self._drop_index:
            # the dropped trees change here and in _normalize, before any
            # read of the model
            self._model_gen += 1
        for i in self._drop_index:
            for kk in range(k):
                tree = self.models[i * k + kk]
                tree.shrink(-1.0)
                self._add_train_tree_score(tree, kk)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / \
                (1.0 + len(self._drop_index))
        elif not self._drop_index:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / \
                (cfg.learning_rate + len(self._drop_index))

    # -- normalization (dart.hpp:141-196, dart.py:150-176) ----------------
    def _normalize(self) -> None:
        kdrop = float(len(self._drop_index))
        k = self.num_tree_per_iteration
        cfg = self.config
        for i in self._drop_index:
            for kk in range(k):
                tree = self.models[i * k + kk]
                if not cfg.xgboost_dart_mode:
                    tree.shrink(1.0 / (kdrop + 1.0))
                    for _, vs, _m in self.valid_states:
                        self._add_tree_score(vs, tree, kk)
                    tree.shrink(-kdrop)
                else:
                    tree.shrink(self.shrinkage_rate)
                    for _, vs, _m in self.valid_states:
                        self._add_tree_score(vs, tree, kk)
                    tree.shrink(-kdrop / cfg.learning_rate)
                self._add_train_tree_score(tree, kk)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (
                        1.0 / (kdrop + 1.0))
                    self.tree_weight[i] *= kdrop / (kdrop + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] * (
                        1.0 / (kdrop + cfg.learning_rate))
                    self.tree_weight[i] *= kdrop / (kdrop + cfg.learning_rate)
