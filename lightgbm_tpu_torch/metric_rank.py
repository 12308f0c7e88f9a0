"""Ranking metrics: NDCG@k and MAP@k, plus the shared DCG calculator.

Port of lightgbm_tpu/metric_rank.py (src/metric/rank_metric.hpp NDCGMetric,
map_metric.hpp MapMetric, dcg_calculator.cpp DCGCalculator): per-query
stable sorts over descending score with cached inverse max-DCG; queries
whose max DCG is non-positive contribute 1.0 (all-negative queries).  The
JAX module but for NDCG's evaluation, which runs ops/ranking.DeviceNDCG
where the score lies: a numpy score on the CPU, a tensor on its device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .metric import Metric
from .ops.ranking import DeviceNDCG
from .utils import log

K_MAX_POSITION = 10000


def default_label_gain() -> List[float]:
    """label_gain = 2^i - 1 (dcg_calculator.cpp:30-38)."""
    return [0.0] + [float((1 << i) - 1) for i in range(1, 31)]


class DCGCalculator:
    """dcg_calculator.cpp:1-165 as an instance (the reference uses statics)."""

    def __init__(self, label_gain: Optional[Sequence[float]] = None):
        if not label_gain:
            label_gain = default_label_gain()
        self.label_gain_np = np.asarray(label_gain, np.float64)
        self._discount = 1.0 / np.log2(2.0 + np.arange(K_MAX_POSITION))

    def discount(self, positions):
        return self._discount[positions]

    def check_label(self, label: np.ndarray) -> None:
        lab = np.asarray(label)
        if np.abs(lab - lab.astype(np.int64)).max(initial=0.0) > 1e-10:
            log.fatal("label should be int type for ranking task, for the "
                      "gain of label, please set the label_gain parameter")
        if lab.size and (lab.min() < 0
                         or lab.max() >= len(self.label_gain_np)):
            log.fatal("label exceeds the allowed range for label_gain")

    def cal_maxdcg_at_k(self, k: int, label: np.ndarray) -> float:
        """Max DCG@k: labels taken in descending order (dcg_calculator.cpp:52-74)."""
        lab = np.sort(np.asarray(label).astype(np.int64))[::-1]
        k = min(k, len(lab))
        if k <= 0:
            return 0.0
        return float((self.label_gain_np[lab[:k]] * self._discount[:k]).sum())

    def cal_dcg_at_k(self, k: int, label: np.ndarray, score: np.ndarray) -> float:
        sorted_idx = np.argsort(-np.asarray(score), kind="stable")
        lab = np.asarray(label).astype(np.int64)[sorted_idx]
        k = min(k, len(lab))
        if k <= 0:
            return 0.0
        return float((self.label_gain_np[lab[:k]] * self._discount[:k]).sum())


class _RankMetric(Metric):
    bigger_is_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = [int(k) for k in config.eval_at] or [1, 2, 3, 4, 5]
        for k in self.eval_at:
            if k <= 0:
                log.fatal("eval_at positions must be positive")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("The %s metric requires query information" % self.name)
        self.query_boundaries = np.asarray(metadata.query_boundaries, np.int64)
        self.num_queries = len(self.query_boundaries) - 1
        self.query_weights = (np.asarray(metadata.query_weights, np.float64)
                              if metadata.query_weights is not None else None)
        self.sum_query_weights = (float(self.query_weights.sum())
                                  if self.query_weights is not None
                                  else float(self.num_queries))


class NDCGMetric(_RankMetric):
    """rank_metric.hpp:15-171."""

    name = "ndcg"
    # GBDT._eval_state hands this metric its device score, not a host copy
    takes_tensor = True

    def __init__(self, config):
        super().__init__(config)
        self.dcg = DCGCalculator(list(config.label_gain))

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.dcg.check_label(self.label)
        # cache inverse max DCG at each eval position; negative marks
        # all-negative queries (their NDCG counts as 1)
        self.inverse_max_dcgs = np.zeros((self.num_queries, len(self.eval_at)))
        for q in range(self.num_queries):
            a, b = self.query_boundaries[q], self.query_boundaries[q + 1]
            for j, k in enumerate(self.eval_at):
                m = self.dcg.cal_maxdcg_at_k(k, self.label[a:b])
                self.inverse_max_dcgs[q, j] = 1.0 / m if m > 0.0 else -1.0
        self._ndcg = None

    def eval(self, score, objective=None) -> List[float]:
        """NDCG at each eval_at position, in f32 on the device of the first
        score evaluated (the CPU for a numpy score), its tables built there
        then."""
        if self._ndcg is None:
            self._ndcg = DeviceNDCG(
                self.query_boundaries, self.label, self.dcg.label_gain_np,
                self.eval_at, self.inverse_max_dcgs, self.query_weights,
                device=score.device if isinstance(score, torch.Tensor)
                else "cpu")
        return self._ndcg(score)

    def eval_host(self, score, objective=None) -> List[float]:
        """Numpy per-query path (parity oracle for DeviceNDCG)."""
        score = np.asarray(score, np.float64)
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            a, b = self.query_boundaries[q], self.query_boundaries[q + 1]
            w = self.query_weights[q] if self.query_weights is not None else 1.0
            if self.inverse_max_dcgs[q, 0] <= 0.0:
                result += w  # all-negative query: NDCG = 1
                continue
            for j, k in enumerate(self.eval_at):
                dcg = self.dcg.cal_dcg_at_k(k, self.label[a:b], score[a:b])
                result[j] += dcg * self.inverse_max_dcgs[q, j] * w
        return list(result / self.sum_query_weights)


class MapMetric(_RankMetric):
    """map_metric.hpp:15-168 (MAP@k; a doc is relevant iff label > 0.5)."""

    name = "map"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.npos_per_query = np.array(
            [(self.label[self.query_boundaries[q]:self.query_boundaries[q + 1]]
              > 0.5).sum() for q in range(self.num_queries)], np.int64)

    def _map_at_ks(self, label, score, npos) -> np.ndarray:
        sorted_idx = np.argsort(-np.asarray(score), kind="stable")
        rel = label[sorted_idx] > 0.5
        hits = np.cumsum(rel)
        prec_terms = np.where(rel, hits / (np.arange(len(rel)) + 1.0), 0.0)
        sum_ap = np.cumsum(prec_terms)
        out = np.zeros(len(self.eval_at))
        for j, k in enumerate(self.eval_at):
            kk = min(k, len(rel))
            if npos > 0:
                out[j] = sum_ap[kk - 1] / min(npos, kk) if kk > 0 else 0.0
            else:
                out[j] = 1.0
        return out

    def eval(self, score, objective=None) -> List[float]:
        score = np.asarray(score, np.float64)
        result = np.zeros(len(self.eval_at))
        for q in range(self.num_queries):
            a, b = self.query_boundaries[q], self.query_boundaries[q + 1]
            w = self.query_weights[q] if self.query_weights is not None else 1.0
            result += self._map_at_ks(self.label[a:b], score[a:b],
                                      self.npos_per_query[q]) * w
        return list(result / self.sum_query_weights)


def create_rank_metric(name: str, config) -> Metric:
    name = name.strip().lower()
    if name in ("ndcg", "lambdarank"):
        return NDCGMetric(config)
    if name in ("map", "mean_average_precision"):
        return MapMetric(config)
    log.fatal("Unknown ranking metric: %s" % name)
