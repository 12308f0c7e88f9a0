"""Ranking math on the score's device: queries batched by size class.

Port of lightgbm_tpu/ops/ranking.py.  The reference computes lambdarank
gradients and NDCG with per-query host loops (rank_objective.hpp:80-167
GetGradientsForOneQuery, rank_metric.hpp NDCGMetric::Eval); here queries
are grouped by size class into padded [Q, S] blocks (S the next power of
two, at least 8) and each block runs as a few tensor operations: a stable
descending sort, dense [chunk, S, S] pair matrices for the lambda sums,
masked positions for the padding.

Every table (row indices, sorted label gains, inverse max DCG, discounts)
is a device tensor built once at construction, and the chunk loop over a
block's queries is fixed then, so a round that calls `DeviceLambdarank`
reads no host value and copies none to the device: the round's CUDA graph
captures it.  Only the scores stream through.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

_BUCKET_MIN = 8
# pair matrices are [chunk, S, S]; each chunk at most 2^22 values (16 MB of
# f32 a plane), the JAX package's budget
_CHUNK_BUDGET = 1 << 22


# _bucket_size, QueryBuckets and _chunk copied from
# lightgbm_tpu/ops/ranking.py:36-74.
def _bucket_size(sz: int) -> int:
    b = _BUCKET_MIN
    while b < sz:
        b *= 2
    return b


class QueryBuckets:
    """Static padded layout of queries grouped by size class.

    For each bucket: `idx` [Q, S] int32 row indices into the data arrays
    (padding = n, a sentinel one past the end), plus the query ids [Q]
    for per-query scalars.
    """

    def __init__(self, query_boundaries: np.ndarray, num_data: int):
        qb = np.asarray(query_boundaries, np.int64)
        sizes = np.diff(qb)
        self.num_data = int(num_data)
        self.num_queries = len(sizes)
        by_bucket = {}
        for q, sz in enumerate(sizes):
            if sz <= 0:
                continue
            by_bucket.setdefault(_bucket_size(int(sz)), []).append(q)
        self.buckets = []           # list of (idx [Q,S] i32, qids [Q] i32)
        for S in sorted(by_bucket):
            qids = np.asarray(by_bucket[S], np.int32)
            idx = np.full((len(qids), S), self.num_data, np.int64)
            for r, q in enumerate(qids):
                a, b = qb[q], qb[q + 1]
                idx[r, :b - a] = np.arange(a, b)
            self.buckets.append((idx.astype(np.int32), qids))


def _chunk(Q: int, S: int) -> int:
    c = max(1, _CHUNK_BUDGET // max(S * S, 1))
    return int(min(c, Q))


def _descending(score_pad: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Each row's slots by descending score, padding last, ties in slot
    order: argsort(-where(real, s, -inf), stable).  Adding 0.0 first makes
    -0.0 a +0.0, so a sort that orders by bit pattern ties them as the
    comparison sorts of JAX and numpy do."""
    key = torch.where(real, score_pad + 0.0, float("-inf"))
    return torch.argsort(-key, dim=1, stable=True)


def lambda_bucket(score_pad, lab, gains, real, inv_mdcg, disc,
                  sigmoid: float, chunk: int):
    """Lambdarank sums for one padded bucket (lightgbm_tpu/ops/ranking.py:
    77-132 `_lambda_bucket`), `chunk` queries at a time.

    score_pad/lab/gains/real: [Q, S]; inv_mdcg: [Q]; disc: [S].  Returns
    (lam, hes) [Q, S] in the unsorted (original slot) order.  Per query
    the same f32 expressions as the JAX function; the [chunk, S, S] pair
    sums reassociate as each library reduces."""
    Q, S = score_pad.shape
    paired = (disc[:, None] - disc[None, :]).abs()
    lams, hess = [], []
    for c0 in range(0, Q, chunk):
        sl = slice(c0, c0 + chunk)
        s0, l0, g0, r0, inv = (score_pad[sl], lab[sl], gains[sl], real[sl],
                               inv_mdcg[sl])
        order = _descending(s0, r0)
        s = torch.gather(s0, 1, order)
        lo = torch.gather(l0, 1, order)
        g = torch.gather(g0, 1, order)
        r = torch.gather(r0, 1, order)
        best = torch.where(r, s, float("-inf")).amax(dim=1)
        worst = torch.where(r, s, float("inf")).amin(dim=1)
        delta = s[:, :, None] - s[:, None, :]
        valid = ((lo[:, :, None] > lo[:, None, :])
                 & r[:, :, None] & r[:, None, :])
        dcg_gap = g[:, :, None] - g[:, None, :]
        dndcg = dcg_gap * paired[None] * inv[:, None, None]
        # regularize by score distance when scores differ (hpp:139-142)
        norm = (best != worst)[:, None, None]
        dndcg = torch.where(norm, dndcg / (0.01 + delta.abs()), dndcg)
        sig = 2.0 / (1.0 + torch.exp(
            torch.clamp(2.0 * sigmoid * delta, -80.0, 80.0)))
        p_lambda = torch.where(valid, sig * -dndcg, 0.0)
        p_hess = torch.where(valid, sig * (2.0 - sig) * 2.0 * dndcg, 0.0)
        lam_s = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
        hes_s = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        # back to the original slots
        lams.append(torch.empty_like(lam_s).scatter_(1, order, lam_s))
        hess.append(torch.empty_like(hes_s).scatter_(1, order, hes_s))
    return torch.cat(lams), torch.cat(hess)


class DeviceLambdarank:
    """Lambdarank gradients of every query on the score's device
    (lightgbm_tpu/ops/ranking.py:135-181)."""

    def __init__(self, query_boundaries, labels, label_gain,
                 inverse_max_dcgs, sigmoid: float, device):
        labels = np.asarray(labels)
        n = len(labels)
        self.n = n
        self.sigmoid = float(sigmoid)
        self.qb = QueryBuckets(query_boundaries, n)
        gain_tab = np.asarray(label_gain, np.float64)
        inv = np.asarray(inverse_max_dcgs, np.float64)
        dev = torch.device(device)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        self._buckets = []
        # each row's position in the buckets' flattened slots: the
        # gradients return to row order by one gather
        pos = np.zeros(n, np.int64)
        base = 0
        for idx, qids in self.qb.buckets:
            lab_pad = np.full(idx.shape, -1, np.int32)
            real = idx < n
            lab_pad[real] = labels[idx[real]].astype(np.int32)
            pos[idx[real]] = base + np.flatnonzero(real.reshape(-1))
            base += idx.size
            self._buckets.append(dict(
                idx=t(idx, torch.int64),
                lab=t(lab_pad.astype(np.float64)),
                gains=t(np.where(real, gain_tab[np.clip(lab_pad, 0, None)],
                                 0.0)),
                real=t(real, torch.bool),
                inv=t(inv[qids]),
                disc=t(1.0 / np.log2(2.0 + np.arange(idx.shape[1]))),
                chunk=_chunk(*idx.shape)))
        self._pos = t(pos, torch.int64)
        self._pad = torch.full((1,), float("-inf"), device=dev)

    def __call__(self, score: torch.Tensor) -> tuple:
        """(grad, hess) f32 [n] in row order from the f32 score [n]."""
        ext = torch.cat([score.reshape(-1).to(torch.float32), self._pad])
        lams, hess = [], []
        for b in self._buckets:
            lam, hes = lambda_bucket(ext[b["idx"]], b["lab"], b["gains"],
                                     b["real"], b["inv"], b["disc"],
                                     self.sigmoid, b["chunk"])
            lams.append(lam.reshape(-1))
            hess.append(hes.reshape(-1))
        # 0.0 + x, as the JAX function's scatter-add into zeros sums it
        return (torch.cat(lams)[self._pos] + 0.0,
                torch.cat(hess)[self._pos] + 0.0)


def ndcg_bucket(score_pad, gains, real, inv_mdcg_k, wq, disc, ks) -> torch.Tensor:
    """Weighted NDCG sums at each k for one bucket -> [len(ks)]
    (lightgbm_tpu/ops/ranking.py:184-198 `_ndcg_bucket`)."""
    order = _descending(score_pad, real)
    g = torch.gather(gains, 1, order)                      # [Q, S]
    pos = torch.arange(score_pad.shape[1], device=score_pad.device)
    out = []
    for j, k in enumerate(ks):
        dcg = (g * disc * (pos < k)[None, :]).sum(dim=1)   # [Q]
        # all-negative queries (inv <= 0) count as NDCG = 1
        ndcg = torch.where(inv_mdcg_k[:, j] > 0.0, dcg * inv_mdcg_k[:, j],
                           1.0)
        out.append((ndcg * wq).sum())
    return torch.stack(out)


class DeviceNDCG:
    """NDCG@k over all queries on one device, in f32
    (lightgbm_tpu/ops/ranking.py:201-254; rank_metric.hpp:15-171)."""

    def __init__(self, query_boundaries, labels, label_gain, eval_at,
                 inverse_max_dcgs, query_weights=None, device="cpu"):
        labels = np.asarray(labels)
        n = len(labels)
        self.n = n
        self.ks = tuple(int(k) for k in eval_at)
        self.qb = QueryBuckets(query_boundaries, n)
        self.device = torch.device(device)
        # zero-row queries are in no bucket but still count as NDCG = 1
        # (maxDCG <= 0 rule, rank_metric.hpp NDCGMetric::Eval)
        sizes = np.diff(np.asarray(query_boundaries, np.int64))
        gain_tab = np.asarray(label_gain, np.float64)
        inv = np.asarray(inverse_max_dcgs, np.float64)   # [num_q, K]
        qw = (np.asarray(query_weights, np.float64)
              if query_weights is not None
              else np.ones(self.qb.num_queries))
        self.sum_weights = float(qw.sum())
        self.base = float(qw[sizes <= 0].sum())

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self._buckets = []
        for idx, qids in self.qb.buckets:
            real = idx < n
            lab_pad = np.where(real, np.clip(labels, 0, None)[
                np.clip(idx, 0, n - 1)].astype(np.int64), 0)
            self._buckets.append(dict(
                idx=t(idx, torch.int64),
                gains=t(np.where(real, gain_tab[lab_pad], 0.0)),
                real=t(real, torch.bool),
                inv=t(inv[qids]),
                wq=t(qw[qids]),
                disc=t(1.0 / np.log2(2.0 + np.arange(idx.shape[1])))))
        self._pad = torch.full((1,), float("-inf"), device=self.device)

    def __call__(self, score) -> List[float]:
        score = torch.as_tensor(score).to(self.device, torch.float32)
        ext = torch.cat([score.reshape(-1), self._pad])
        total = torch.zeros(len(self.ks), dtype=torch.float32,
                            device=self.device)
        for b in self._buckets:
            total = total + ndcg_bucket(ext[b["idx"]], b["gains"], b["real"],
                                        b["inv"], b["wq"], b["disc"], self.ks)
        return [(float(x) + self.base) / self.sum_weights
                for x in total.cpu().numpy()]
