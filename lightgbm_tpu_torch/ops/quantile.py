"""Per-leaf percentile renewal for the L1-family objectives.

Port of lightgbm_tpu/ops/quantile.py `renew_leaf_percentiles` (:22):
RenewTreeOutput for regression_l1, quantile and MAPE refits every leaf
output to a (weighted) percentile of the leaf's residuals (reference
regression_objective.hpp:17-69 PercentileFun / WeightedPercentileFun and
serial_tree_learner.cpp:850-928).  All leaves in one pass on the
residuals' device: rows grouped by (leaf, residual) with two stable
argsorts, per-leaf offsets from a bincount, and the interpolation as a
handful of [L]-sized gathers; no loop over leaves.
"""
from __future__ import annotations

from typing import Optional

import torch

K_EPSILON = 1e-15


def renew_leaf_percentiles(residual: torch.Tensor, lids: torch.Tensor,
                           alpha: float, L: int,
                           weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """[L] percentile of residuals per leaf (leaves without rows -> 0).

    residual: [n] f32; lids: [n] int row -> leaf (-1 = out of the bag);
    alpha: the percentile; weights: [n] or None.  PercentileFun's
    descending interpolation and WeightedPercentileFun's CDF interpolation,
    as the JAX function computes them."""
    n = residual.shape[0]
    dev, dt = residual.device, residual.dtype
    lid = torch.where(lids >= 0, lids, L).long()
    # ascending residual within each leaf: two stable argsorts
    o1 = torch.argsort(residual, stable=True)
    o2 = torch.argsort(lid[o1], stable=True)
    order = o1[o2]
    v = residual[order]
    counts = torch.bincount(lid, minlength=L + 1)[:L]
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    c = counts
    zero = torch.zeros((), dtype=dt, device=dev)
    # alpha in the residuals' precision, as the JAX function receives it
    a = torch.as_tensor(alpha, dtype=dt, device=dev)

    def at(i):
        return v[i.clamp(0, n - 1)]

    if weights is None:
        # PercentileFun on the descending view d[i] = v[c-1-i]
        float_pos = (1.0 - a) * c
        pos = torch.floor(float_pos).long()
        bias = (float_pos - pos).to(dt)
        v1 = at(starts + c - pos)           # d[pos-1]
        v2 = at(starts + c - 1 - pos)       # d[pos]
        interp = v1 - (v1 - v2) * bias
        out = torch.where(pos < 1, at(starts + c - 1),
                          torch.where(pos >= c, at(starts), interp))
        return torch.where(c <= 1, torch.where(c == 1, at(starts), zero),
                           out)

    w = weights[order]
    cum = torch.cumsum(w, 0)
    seg_off = torch.where(starts > 0, cum[(starts - 1).clamp(0, n - 1)], zero)
    lid_sorted = lid[order]
    # each row's CDF inside its leaf
    row_off = torch.cat([seg_off, torch.zeros(1, dtype=dt, device=dev)])[
        lid_sorted.clamp(0, L)]
    cdf = cum - row_off
    totals = torch.where(c > 0, cum[(ends - 1).clamp(0, n - 1)] - seg_off,
                         zero)
    thr = totals * a
    real = lid_sorted < L
    below = (cdf <= thr[lid_sorted.clamp(0, L - 1)]) & real
    pos = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
        0, lid_sorted.clamp(0, L - 1), below.long())
    pos = torch.minimum(pos, c - 1)

    def cdf_at(i):
        return cdf[i.clamp(0, n - 1)]

    v_pos = at(starts + pos)
    v_prev = at(starts + pos - 1)
    d = cdf_at(starts + pos + 1) - cdf_at(starts + pos)
    interp = (thr - cdf_at(starts + pos)) / torch.where(
        d.abs() > K_EPSILON, d, torch.ones_like(d)) * (v_pos - v_prev) + v_prev
    inner = torch.where((pos + 1 < c) & (d > K_EPSILON), interp, v_pos)
    out = torch.where((pos == 0) | (pos == c - 1), v_pos, inner)
    return torch.where(c <= 1, torch.where(c == 1, at(starts), zero), out)
