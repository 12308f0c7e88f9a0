# Copied from lightgbm_tpu/io/metadata.py; kept in step with it by tests/test_torch_train.py.
"""Metadata: labels, weights, query boundaries, init scores.

Analogue of the reference Metadata (include/LightGBM/dataset.h:36-248,
src/io/metadata.cpp): owns the per-row side information and the
query-boundary structure used by ranking objectives/metrics.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import log


class Metadata:
    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None          # [n] f32
        self.weights: Optional[np.ndarray] = None        # [n] f32 or None
        self.query_boundaries: Optional[np.ndarray] = None  # [nq+1] i32
        self.query_weights: Optional[np.ndarray] = None  # [nq] f32
        self.init_score: Optional[np.ndarray] = None     # [n * k] f64

    def init(self, num_data: int) -> None:
        self.num_data = num_data

    # --- field setters (dataset.h:75-172 semantics) -----------------------
    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if self.num_data and len(label) != self.num_data:
            log.fatal("Length of label (%d) != num_data (%d)" % (len(label), self.num_data))
        self.label = label
        self.num_data = len(label)
        # re-validate fields that may have been set before the label
        if self.weights is not None and len(self.weights) != self.num_data:
            log.fatal("Length of weights (%d) != num_data (%d)"
                      % (len(self.weights), self.num_data))
        if self.query_boundaries is not None and self.query_boundaries[-1] != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)"
                      % (int(self.query_boundaries[-1]), self.num_data))

    def set_weights(self, weights) -> None:
        if weights is None:
            self.weights = None
            self.query_weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).reshape(-1)
        if self.num_data and len(weights) != self.num_data:
            log.fatal("Length of weights (%d) != num_data (%d)" % (len(weights), self.num_data))
        self.weights = weights
        self._update_query_weights()

    def set_query(self, group) -> None:
        """`group` is per-query sizes (like the Python binding) or raw per-row
        query ids (detected by non-monotone-size pattern at load time)."""
        if group is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        boundaries = np.concatenate([[0], np.cumsum(group)]).astype(np.int32)
        if self.num_data and boundaries[-1] != self.num_data:
            log.fatal("Sum of query counts (%d) != num_data (%d)"
                      % (int(boundaries[-1]), self.num_data))
        self.query_boundaries = boundaries
        self._update_query_weights()

    def set_query_from_ids(self, query_ids) -> None:
        """Raw per-row query ids (file group column path,
        metadata.cpp LoadQueryBoundaries analogue)."""
        qid = np.asarray(query_ids)
        change = np.nonzero(np.concatenate([[True], qid[1:] != qid[:-1]]))[0]
        sizes = np.diff(np.concatenate([change, [len(qid)]]))
        self.set_query(sizes)

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        arr = np.asarray(init_score, dtype=np.float64)
        # class-major blocks of length num_data (reference layout); (n, k)
        # input is therefore flattened in Fortran order
        flat = arr.reshape(-1, order="F") if arr.ndim == 2 else arr.reshape(-1)
        if self.num_data > 0 and (flat.size == 0
                                  or flat.size % self.num_data != 0):
            # a stale <data>.init side file must fail loudly, not as a
            # shape-broadcast error deep in training
            # (Metadata::SetInitScore, metadata.cpp:175-188)
            log.fatal("Initial score size doesn't match data size "
                      "(%d scores for %d rows)" % (flat.size, self.num_data))
        self.init_score = flat

    def _update_query_weights(self) -> None:
        if self.weights is None or self.query_boundaries is None:
            self.query_weights = None
            return
        b = self.query_boundaries
        self.query_weights = np.array(
            [self.weights[b[i]:b[i + 1]].sum() / max(1, b[i + 1] - b[i])
             for i in range(len(b) - 1)], dtype=np.float32)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def subset(self, indices: np.ndarray) -> "Metadata":
        """Row subset copy (used by bagging-subset / Dataset.subset)."""
        out = Metadata(len(indices))
        if self.label is not None:
            out.label = self.label[indices]
        if self.weights is not None:
            out.weights = self.weights[indices]
        if self.init_score is not None:
            k = len(self.init_score) // max(1, self.num_data)
            out.init_score = np.concatenate(
                [self.init_score[c * self.num_data:][indices] for c in range(k)])
        # query structure is not preserved under arbitrary subsets (reference
        # requires query-granular sampling for ranking)
        return out

    def to_npz_dict(self, prefix: str = "meta_") -> dict:
        d = {}
        for name in ("label", "weights", "query_boundaries", "init_score"):
            v = getattr(self, name)
            if v is not None:
                d[prefix + name] = v
        return d

    @classmethod
    def from_npz_dict(cls, d, num_data: int, prefix: str = "meta_") -> "Metadata":
        m = cls(num_data)
        for name in ("label", "weights", "query_boundaries", "init_score"):
            k = prefix + name
            if k in d:
                setattr(m, name, np.asarray(d[k]))
        m._update_query_weights()
        return m
