"""Random forest mode (src/boosting/rf.hpp:18-209).

Port of lightgbm_tpu/models/rf.py: bagged trees with no shrinkage and an
averaged output.  The gradients are taken once, against the constant
boost-from-average score, into the booster's `_grad` and `_hess`; every
round grows a tree a class over the bag (K3's pred mode at the root, leaf
ids by K4's set mode), fetches it and adds its bias, and the scores keep
the running average of the trees' outputs: the training score through
KP2's masked add over the bag's leaf ids, each validation score through
KP2's add mode.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import quantize as qz
from ..utils import log
from .gbdt import GBDT, K_EPSILON
from .tree import Tree


class RF(GBDT):
    """Bagged trees with no shrinkage and averaged output (rf.py:13-102)."""

    _holds_gradients = True

    def __init__(self, config, train_set, objective, device):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            log.fatal("Random forest mode requires bagging "
                      "(bagging_freq > 0 and bagging_fraction in (0, 1))")
        super().__init__(config, train_set, objective, device)
        self.average_output = True
        self.shrinkage_rate = 1.0
        self._rf_init_scores = [0.0] * max(self.num_tree_per_iteration, 1)
        self._rf_grad_ready = False

    def _compute_rf_gradients(self) -> None:
        """Gradients against the constant init score (rf.hpp:75-93,
        rf.py:36-48), the score rounded to the
        booster's type as JAX's."""
        k = self.num_tree_per_iteration
        n = self.num_data
        for kk in range(k):
            self._rf_init_scores[kk] = (
                self.objective.boost_from_score(kk)
                if self.config.boost_from_average else 0.0)
        tmp = torch.as_tensor(
            np.asarray(self._rf_init_scores, np.float64),
            device=self.device).to(self.dtype).view(k, 1).expand(
                k, n).contiguous()
        grad, hess = self.objective.get_gradients(tmp if k > 1 else tmp[0])
        self._grad.copy_(grad.to(self.dtype).view(k, n))
        self._hess.copy_(hess.to(self.dtype).view(k, n))
        self._rf_grad_ready = True

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """rf.py:50-81: one bagged tree a class, fetched in its round; a
        class that grows no tree keeps its init score as a constant tree.
        RF never stops early, and takes no custom gradients."""
        if gradients is not None or hessians is not None:
            log.fatal("RF mode does not support custom objective")
        if not self._rf_grad_ready:
            self._compute_rf_gradients()
        k = self.num_tree_per_iteration
        self._bagging(self.iter)
        classes = tuple(kk for kk in range(k)
                        if self.objective.class_need_train(kk))
        keys = [None] * len(classes)
        if self._quantized:
            # the eager path's unfolded key (gbdt.py:1383-1388)
            keys = [qz.quantize_key(self._quant_seed, self.iter)] * len(
                classes)
        slot = None
        if classes:
            slot = self._slot()
            self._stage_inputs(slot, classes, keys)
        for kk in range(k):
            new_tree, out, arrays = Tree(1), None, None
            if kk in classes:
                packed, out, arrays = self._run_round(None, "leaf_ids", True,
                                                      class_id=kk)
                host_arrays = self._fetch(packed, slot, kk)
                if int(host_arrays.num_leaves) > 1:
                    new_tree = Tree.from_arrays(host_arrays, self.train_set)
            init = self._rf_init_scores[kk]
            if new_tree.num_leaves > 1:
                if self.objective.is_renew_tree_output():
                    self._renew_tree_output(new_tree, kk, out)
                if abs(init) > K_EPSILON:
                    new_tree.add_bias(init)
                self._average_in(new_tree, kk, out, arrays)
            else:
                new_tree.as_constant(init)
                self._average_in(new_tree, kk, None, None)
            self.models.append(new_tree)
        self.iter += 1
        return False

    def _average_in(self, tree: Tree, class_id: int, leaf_ids, arrays) -> None:
        """score <- (score * iter + tree) / (iter + 1) in f32 (rf.hpp:130-134,
        rf.py:83-97), on the training score and every validation score; the
        training rows out of the bag walked by KP2's masked add."""
        it = self.iter
        score = self.scores[class_id]
        score.mul_(it)
        if arrays is None:
            score.add_(float(tree.leaf_value[0]))
        else:
            self._add_leaf_values(self._leaf_values(tree), leaf_ids, True,
                                  arrays, class_id)
        score.mul_(1.0 / (it + 1))
        for _, vs, _m in self.valid_states:
            vs.scores[class_id].mul_(it)
            self._add_tree_score(vs, tree, class_id)
            vs.scores[class_id].mul_(1.0 / (it + 1))

    def _renew_baseline_score(self, class_id: int) -> torch.Tensor:
        # RF's residuals are against the constant init score, not the
        # running average (rf.hpp:126 passes init_scores_[class])
        return torch.full((self.num_data,), self._rf_init_scores[class_id],
                          dtype=self.dtype, device=self.device)
