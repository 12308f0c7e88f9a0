# Copied from lightgbm_tpu/io/efb.py; kept in step with it by tests/test_torch_train.py.
"""Exclusive Feature Bundling (EFB).

Behavioral port of the reference's greedy conflict-bounded bundling
(src/io/dataset.cpp:67-212, FindGroups + FastFeatureBundling) adapted to
this framework's dense-only storage: mutually (near-)exclusive sparse
features share one dense bundled column, shrinking the histogram axis the
same way the reference's FeatureGroup does (include/LightGBM/
feature_group.h:18-255).  Differences by design:

- groups of ONE feature keep their original bin encoding (this framework
  stores every feature's default bin explicitly, so no FixHistogram pass
  exists for them — VERDICT'd round-1 redesign); only multi-feature
  bundles use the shared-zero-bin offset encoding, and only their
  per-feature default bins are reconstructed at scan time from leaf
  totals (the reference reconstructs every feature, dataset.cpp:928-949);
- the bundle bin budget is always capped at 256 (the reference only caps
  for its GPU learner; our columns are uint8 device tensors);
- no sparse-group take-apart (reference does that only when sparse bin
  storage is enabled, FastFeatureBundling dataset.cpp:186-200) and no
  final group shuffle (OpenMP load balancing, irrelevant here).

Bundled-column encoding for a multi-feature group (FeatureGroup ctor +
PushData, feature_group.h:33-136): bin 0 = every feature at its default;
feature j with default_bin==0 maps bins 1..nb-1 to offset_j..offset_j+nb-2
(offset_j cumulative from 1), default_bin!=0 maps bin b to offset_j+b with
a hole at its default.  On conflict (several features non-default in one
row) the LAST feature in group order wins, like sequential PushData.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

MAX_BUNDLE_BINS = 256
_MAX_SEARCH_GROUP = 100


class BundleInfo:
    """Static bundling layout shared by dataset build and tree growth."""

    def __init__(self, groups: List[List[int]], num_bins: Sequence[int],
                 default_bins: Sequence[int]):
        self.groups = groups
        F = len(num_bins)
        G = len(groups)
        self.feature_default = np.asarray(default_bins, np.int32)
        self.feature_group = np.zeros(F, np.int32)
        self.feature_lo = np.zeros(F, np.int32)     # group-bin range of the
        self.feature_hi = np.zeros(F, np.int32)     # feature's mapped bins
        self.feature_shift = np.zeros(F, np.int32)  # group_bin = bin + shift
        self.needs_fix = np.zeros(F, bool)          # default bin reconstructed
        self.group_num_bins = np.zeros(G, np.int32)
        for g, feats in enumerate(groups):
            if len(feats) == 1:
                f = feats[0]
                self.feature_group[f] = g
                self.feature_lo[f] = 0
                self.feature_hi[f] = num_bins[f]
                self.feature_shift[f] = 0
                self.group_num_bins[g] = num_bins[f]
                continue
            total = 1                               # bin 0 = all-defaults
            for f in feats:
                nb, db = int(num_bins[f]), int(default_bins[f])
                self.feature_group[f] = g
                self.needs_fix[f] = True
                if db == 0:
                    self.feature_lo[f] = total
                    self.feature_hi[f] = total + nb - 1
                    self.feature_shift[f] = total - 1
                    total += nb - 1
                else:
                    self.feature_lo[f] = total
                    self.feature_hi[f] = total + nb
                    self.feature_shift[f] = total
                    total += nb
            self.group_num_bins[g] = total

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def any_bundled(self) -> bool:
        return any(len(g) > 1 for g in self.groups)

    # -- (de)serialization for the binary dataset cache -------------------
    def to_state(self) -> str:
        return json.dumps({"groups": self.groups})

    @classmethod
    def from_state(cls, state: str, num_bins, default_bins) -> "BundleInfo":
        return cls(json.loads(state)["groups"], num_bins, default_bins)


def find_groups(nonzero_rows: List[np.ndarray], num_bins: Sequence[int],
                default_bins: Sequence[int], order: Sequence[int],
                total_sample_cnt: int, max_error_cnt: int, filter_cnt: int,
                num_data: int, rng: np.random.RandomState
                ) -> List[List[int]]:
    """Greedy conflict-bounded grouping (FindGroups, dataset.cpp:67-137).

    nonzero_rows[f]: sample-row indices where feature f is non-default.
    """
    groups: List[List[int]] = []
    conflict_marks: List[np.ndarray] = []
    group_conflict: List[int] = []
    group_nonzero: List[int] = []
    group_bins: List[int] = []

    def extra_bins(f):
        return int(num_bins[f]) - (1 if int(default_bins[f]) == 0 else 0)

    for fidx in order:
        nz = nonzero_rows[fidx]
        cur_cnt = len(nz)
        available = [g for g in range(len(groups))
                     if (group_nonzero[g] + cur_cnt
                         <= total_sample_cnt + max_error_cnt)
                     and group_bins[g] + extra_bins(fidx) <= MAX_BUNDLE_BINS]
        # bounded search: the most recent group plus a random sample of the
        # rest (dataset.cpp:96-105)
        search: List[int] = []
        if available:
            search.append(available[-1])
            rest = available[:-1]
            if len(rest) > _MAX_SEARCH_GROUP - 1:
                pick = rng.choice(len(rest), _MAX_SEARCH_GROUP - 1,
                                  replace=False)
                rest = [rest[i] for i in sorted(pick)]
            search.extend(rest)
        placed = False
        for g in search:
            rest_max = max_error_cnt - group_conflict[g]
            cnt = int(np.count_nonzero(conflict_marks[g][nz]))
            if cnt <= rest_max:
                rest_nonzero = (cur_cnt - cnt) * num_data / max(
                    total_sample_cnt, 1)
                if rest_nonzero < filter_cnt:
                    continue
                groups[g].append(fidx)
                group_conflict[g] += cnt
                group_nonzero[g] += cur_cnt - cnt
                group_bins[g] += extra_bins(fidx)
                conflict_marks[g][nz] = True
                placed = True
                break
        if not placed:
            groups.append([fidx])
            group_conflict.append(0)
            marks = np.zeros(total_sample_cnt, bool)
            marks[nz] = True
            conflict_marks.append(marks)
            group_nonzero.append(cur_cnt)
            group_bins.append(1 + extra_bins(fidx))
    return groups


def fast_feature_bundling(nonzero_rows: List[np.ndarray],
                          total_sample_cnt: int,
                          num_bins: Sequence[int],
                          default_bins: Sequence[int],
                          max_conflict_rate: float,
                          min_data_in_leaf: int,
                          num_data: int) -> Optional[BundleInfo]:
    """Bundle layout from sampled per-feature non-default row sets
    (FastFeatureBundling, dataset.cpp:139-212).  Returns None when
    nothing bundles (every group is a singleton) so the caller can keep
    the plain per-feature matrix."""
    F = len(nonzero_rows)
    if F <= 1:
        return None
    S = total_sample_cnt
    counts = np.array([len(z) for z in nonzero_rows])
    max_error_cnt = int(S * max_conflict_rate)
    filter_cnt = int(0.95 * min_data_in_leaf / max(num_data, 1) * S)

    natural = list(range(F))
    by_cnt = sorted(natural, key=lambda f: -counts[f])
    g1 = find_groups(nonzero_rows, num_bins, default_bins, natural,
                     S, max_error_cnt, filter_cnt, num_data,
                     np.random.RandomState(num_data % (2 ** 31)))
    g2 = find_groups(nonzero_rows, num_bins, default_bins, by_cnt,
                     S, max_error_cnt, filter_cnt, num_data,
                     np.random.RandomState(num_data % (2 ** 31)))
    groups = g2 if len(g2) < len(g1) else g1
    if all(len(g) == 1 for g in groups):
        return None
    return BundleInfo(groups, num_bins, default_bins)

