"""GOSS, gradient-based one-side sampling (src/boosting/goss.hpp:26-213).

Port of lightgbm_tpu/models/goss.py: every iteration past the warm-up keeps
the `top_rate` share of rows with the largest sum over classes of |g*h|
and a uniform `other_rate` share of the rest, whose gradients and hessians
are multiplied by (n - top_k) / other_k; the other rows take no part in the
tree.  The warm-up, the first int(1 / learning_rate) iterations, keeps
every row.  The sample is drawn on the device inside the gradients' graph
(`_sample_gradients`): the row predicate goes to `_bag_pred`, which the
tree's root partition (K3's pred mode) and the out-of-sample rows' score
walk (KP2's masked add) read as they read a bag, with no host read.
"""
from __future__ import annotations

import torch

from ..ops import threefry
from ..utils import log
from .gbdt import GBDT, Sample


def goss_sample(grad: torch.Tensor, hess: torch.Tensor, key, multiply: float,
                top_k: int, other_k: int):
    """lightgbm_tpu/models/goss.py:14-31 `_goss_sample` on [k, n] f32
    gradients: (grad, hess) with the sampled other rows' amplified, and the
    in-sample predicate (uint8 [n]).  `key`: the draw's threefry key, a pair
    of ints or an int64 [2] device tensor."""
    score = (grad * hess).abs()
    total = score[0]
    for row in score[1:]:
        total = total + row
    u = threefry.uniform(key, total.shape[0], total.device)
    return goss_select(grad, hess, total, u, multiply, top_k, other_k)


def goss_select(grad: torch.Tensor, hess: torch.Tensor, score: torch.Tensor,
                u: torch.Tensor, multiply: float, top_k: int, other_k: int):
    """The sample of `goss_sample` from its score and uniform draw.  `thr` is
    the top_k-th largest score and every row at or above it is in (ties
    keep every tied row); of the rest, the other_k rows of the smallest u,
    the lower row first among equal u, as XLA's `top_k(-u, other_k)` takes
    them: a stable ascending sort, whose order is defined where torch.topk's
    is not.  Static shapes throughout, so the sample captures in a graph."""
    n = score.shape[0]
    thr = torch.sort(score, descending=True).values[top_k - 1]
    is_top = score >= thr
    u = torch.where(is_top, 2.0, u)
    idx = torch.sort(u, stable=True).indices[:other_k]
    sel = torch.zeros(n, dtype=torch.bool, device=score.device)
    sel.index_fill_(0, idx, True)
    sel &= ~is_top
    amp = torch.where(sel, multiply, 1.0).to(grad.dtype)
    return grad * amp, hess * amp, (is_top | sel).to(torch.uint8)


class GOSS(GBDT):
    """Keeps the top `top_rate` rows by |g*h| every iteration past the
    warm-up, plus a random `other_rate` share of the rest with amplified
    gradients (goss.py:34-85), through the `_sample_gradients` hook of the
    driver's eager path."""

    _holds_gradients = True

    def __init__(self, config, train_set, objective, device):
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            log.fatal("Cannot use bagging in GOSS")
        super().__init__(config, train_set, objective, device)
        log.info("Using GOSS")
        self._goss_key = threefry.PRNGKey(config.bagging_seed)
        # the sample's predicate, one buffer the graphs read every round
        self._sample_pred = None
        self._goss_counts = None

    def _bagging(self, it: int):
        # the sample replaces the bag (goss.py:61-64): set by
        # _sample_gradients just before
        return self._bag_pred

    def _sample_gradients(self):
        """goss.hpp:87-135 (goss.py:66-85): None in the warm-up; otherwise
        the next key of the chain and the device half that samples the
        rows."""
        cfg = self.config
        n = self.num_data
        if self.iter < int(1.0 / max(cfg.learning_rate, 1e-12)):
            self._bag_pred = None
            self._goss_counts = None
            return None
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        multiply = (n - top_k) / other_k
        self._goss_key, sub = threefry.split(self._goss_key)
        if self._sample_pred is None:
            self._sample_pred = torch.empty(n, dtype=torch.uint8,
                                            device=self.device)
        self._bag_pred = self._sample_pred
        self._goss_counts = (top_k, other_k)

        def fn(grad, hess, key):
            grad, hess, pred = goss_sample(grad, hess, key, multiply, top_k,
                                           other_k)
            self._sample_pred.copy_(pred)
            return grad, hess

        return Sample(("goss", top_k, other_k), sub, fn)
