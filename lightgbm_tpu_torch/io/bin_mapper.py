# Copied from lightgbm_tpu/io/bin_mapper.py; kept in step with it by tests/test_torch_train.py.
"""Per-feature value<->bin mapping.

Host-side (setup path) re-implementation of the reference bin finding
(src/io/bin.cpp:73-400, include/LightGBM/bin.h:61-209,468-504): numeric
features get quantile-style greedy bins with zero always isolated in its own
bin; categorical features get count-ranked category bins with a 99% coverage
cutoff; missing handling is None/Zero/NaN.  The resulting bin boundaries feed
the device-resident binned matrix; this code runs once at dataset
construction, so plain numpy is the right tool (the hot path is on-device).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import log

K_ZERO_THRESHOLD = 1e-35  # meta.h:40

NUMERICAL = 0
CATEGORICAL = 1

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

_MISSING_NAMES = {MISSING_NONE: "none", MISSING_ZERO: "zero", MISSING_NAN: "nan"}


def _next_after(a: float) -> float:
    return math.nextafter(a, math.inf)


def _double_equal_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a, inf) — values this close share a bin
    (utils/common.h:852-855)."""
    return b <= _next_after(a)


def greedy_find_bin(distinct_values, counts, max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Equal-frequency greedy binning over (distinct value, count) pairs;
    behavioral port of GreedyFindBin (src/io/bin.cpp:73-149)."""
    num_distinct = len(distinct_values)
    assert max_bin > 0
    bin_upper_bound: List[float] = []
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += counts[i]
            if cur_cnt >= min_data_in_bin:
                val = _next_after((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bin_upper_bound or not _double_equal_ordered(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt = 0
        bin_upper_bound.append(math.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt // min_data_in_bin)))
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = int(total_cnt)
    is_big = [counts[i] >= mean_bin_size for i in range(num_distinct)]
    for i in range(num_distinct):
        if is_big[i]:
            rest_bin_cnt -= 1
            rest_sample_cnt -= counts[i]
    mean_bin_size = rest_sample_cnt / rest_bin_cnt if rest_bin_cnt > 0 else math.inf
    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin

    bin_cnt = 0
    lower_bounds[0] = distinct_values[0]
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts[i]
        cur_cnt += counts[i]
        # need a new bin: big value gets its own; or bin filled; or next is
        # big and this bin is at least half filled (bin.cpp:124-127)
        if is_big[i] or cur_cnt >= mean_bin_size or \
           (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * np.float32(0.5))):
            upper_bounds[bin_cnt] = distinct_values[i]
            bin_cnt += 1
            lower_bounds[bin_cnt] = distinct_values[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                # C++ double division yields a benign inf at 0
                mean_bin_size = (rest_sample_cnt / rest_bin_cnt
                                 if rest_bin_cnt > 0 else math.inf)
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _next_after((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _double_equal_ordered(bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values, counts, max_bin: int,
                                  total_sample_cnt: int, min_data_in_bin: int) -> List[float]:
    """Zero always isolated in [-1e-35, 1e-35]; negatives and positives get
    proportional bin budgets (src/io/bin.cpp:151-205)."""
    left_cnt_data = cnt_zero = right_cnt_data = 0
    for v, c in zip(distinct_values, counts):
        if v <= -K_ZERO_THRESHOLD:
            left_cnt_data += c
        elif v > K_ZERO_THRESHOLD:
            right_cnt_data += c
        else:
            cnt_zero += c

    left_cnt = next((i for i, v in enumerate(distinct_values) if v > -K_ZERO_THRESHOLD),
                    len(distinct_values))

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1))) if denom else 1
        bin_upper_bound = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                          left_max_bin, left_cnt_data, min_data_in_bin)
        bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    right_start = next((i for i in range(left_cnt, len(distinct_values))
                        if distinct_values[i] > K_ZERO_THRESHOLD), -1)
    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        assert right_max_bin > 0
        right_bounds = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    return bin_upper_bound


class BinMapper:
    """One feature's value->bin mapping (bin.h:61-209)."""

    def __init__(self):
        self.num_bin = 1
        self.missing_type = MISSING_NONE
        self.is_trivial = True
        self.sparse_rate = 1.0
        self.bin_type = NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.min_val = 0.0
        self.max_val = 0.0
        self.default_bin = 0

    # -- construction ------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int, bin_type: int = NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False) -> None:
        """Behavioral port of BinMapper::FindBin (src/io/bin.cpp:207-399).

        `values` are the sampled non-zero values; zeros are implied by
        total_sample_cnt - len(values)."""
        values = np.asarray(values, dtype=np.float64)
        na_mask = np.isnan(values)
        na_cnt = int(na_mask.sum())
        values = values[~na_mask]

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
        if self.missing_type != MISSING_NAN:
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        distinct_values, counts = self._distinct_with_zero(np.sort(values, kind="stable"),
                                                           zero_cnt)
        self.min_val = distinct_values[0] if distinct_values else 0.0
        self.max_val = distinct_values[-1] if distinct_values else 0.0

        cnt_in_bin: List[int] = []
        if bin_type == NUMERICAL:
            if self.missing_type == MISSING_NAN:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, max_bin - 1,
                    total_sample_cnt - na_cnt, min_data_in_bin)
                bounds.append(math.nan)
            else:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct_values, counts, max_bin, total_sample_cnt, min_data_in_bin)
                if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            self.bin_upper_bound = np.array(bounds)
            self.num_bin = len(bounds)
            cnt_in_bin = [0] * self.num_bin
            i_bin = 0
            for v, c in zip(distinct_values, counts):
                while v > self.bin_upper_bound[i_bin]:
                    i_bin += 1
                cnt_in_bin[i_bin] += c
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
            assert self.num_bin <= max_bin
        else:
            cnt_in_bin = self._find_bin_categorical(distinct_values, counts,
                                                    total_sample_cnt, max_bin,
                                                    min_data_in_bin, na_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and self._need_filter(cnt_in_bin, total_sample_cnt,
                                                     min_split_data):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
            if self.bin_type == CATEGORICAL:
                assert self.default_bin > 0
            self.sparse_rate = cnt_in_bin[self.default_bin] / total_sample_cnt \
                if total_sample_cnt else 1.0
        else:
            self.sparse_rate = 1.0

    @staticmethod
    def _distinct_with_zero(sorted_values: np.ndarray, zero_cnt: int
                            ) -> Tuple[List[float], List[int]]:
        """Distinct (value, count) pairs with the implied zeros spliced in at
        the right position (bin.cpp:238-268).

        Vectorized: exact-equal grouping via np.unique, then a Python merge
        only over the (few) distinct values for the nextafter-equality chain
        — duplicates are exactly equal, so chaining over distincts matches
        chaining over raw samples.
        """
        n = len(sorted_values)
        uniq, ucnt = (np.unique(sorted_values, return_counts=True) if n
                      else (np.empty(0), np.empty(0, dtype=int)))
        distinct: List[float] = []
        counts: List[int] = []
        if n == 0 or (uniq[0] > 0.0 and zero_cnt > 0):
            distinct.append(0.0)
            counts.append(zero_cnt)
        for i in range(len(uniq)):
            cur, c = float(uniq[i]), int(ucnt[i])
            if distinct and distinct[-1] != 0.0 and _double_equal_ordered(distinct[-1], cur) \
               and not (distinct[-1] < 0.0 < cur):
                distinct[-1] = cur  # keep the larger of near-equal values
                counts[-1] += c
            else:
                if distinct and distinct[-1] < 0.0 and cur > 0.0:
                    distinct.append(0.0)
                    counts.append(zero_cnt)
                distinct.append(cur)
                counts.append(c)
        if n > 0 and uniq[-1] < 0.0 and zero_cnt > 0:
            distinct.append(0.0)
            counts.append(zero_cnt)
        return distinct, counts

    def _find_bin_categorical(self, distinct_values, counts, total_sample_cnt: int,
                              max_bin: int, min_data_in_bin: int, na_cnt: int) -> List[int]:
        """Count-ranked categories, 99% coverage cutoff (bin.cpp:303-376)."""
        vals_int: List[int] = []
        counts_int: List[int] = []
        for v, c in zip(distinct_values, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += c
                log.warning("Met negative value in categorical features, "
                            "will convert it to NaN")
            elif vals_int and iv == vals_int[-1]:
                counts_int[-1] += c
            else:
                vals_int.append(iv)
                counts_int.append(c)
        self.num_bin = 0
        rest_cnt = total_sample_cnt - na_cnt
        cnt_in_bin: List[int] = []
        if rest_cnt > 0:
            if vals_int and vals_int[-1] // 100 > len(vals_int):
                log.warning("Met categorical feature which contains sparse values. "
                            "Consider renumbering to consecutive integers "
                            "started from zero")
            order = sorted(range(len(vals_int)),
                           key=lambda i: (-counts_int[i], vals_int[i]))
            counts_int = [counts_int[i] for i in order]
            vals_int = [vals_int[i] for i in order]
            # category 0 must not land in bin 0 (default_bin > 0 is asserted)
            if vals_int and vals_int[0] == 0:
                if len(counts_int) == 1:
                    counts_int.append(0)
                    vals_int.append(vals_int[0] + 1)
                counts_int[0], counts_int[1] = counts_int[1], counts_int[0]
                vals_int[0], vals_int[1] = vals_int[1], vals_int[0]
            cut_cnt = int((total_sample_cnt - na_cnt) * np.float32(0.99))
            cur_cat = 0
            self.categorical_2_bin = {}
            self.bin_2_categorical = []
            used_cnt = 0
            max_bin = min(len(vals_int), max_bin)
            while cur_cat < len(vals_int) and (used_cnt < cut_cnt or self.num_bin < max_bin):
                if counts_int[cur_cat] < min_data_in_bin and cur_cat > 1:
                    break
                self.bin_2_categorical.append(vals_int[cur_cat])
                self.categorical_2_bin[vals_int[cur_cat]] = self.num_bin
                used_cnt += counts_int[cur_cat]
                cnt_in_bin.append(counts_int[cur_cat])
                self.num_bin += 1
                cur_cat += 1
            if cur_cat == len(vals_int) and na_cnt > 0:
                self.bin_2_categorical.append(-1)
                self.categorical_2_bin[-1] = self.num_bin
                cnt_in_bin.append(0)
                self.num_bin += 1
            if cur_cat == len(vals_int) and na_cnt == 0:
                self.missing_type = MISSING_NONE
            elif na_cnt == 0:
                self.missing_type = MISSING_ZERO
            else:
                self.missing_type = MISSING_NAN
            if cnt_in_bin:
                cnt_in_bin[-1] += total_sample_cnt - used_cnt
        return cnt_in_bin

    @staticmethod
    def _need_filter_numerical(cnt_in_bin, total_cnt, filter_cnt) -> bool:
        sum_left = 0
        for c in cnt_in_bin[:-1]:
            sum_left += c
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
        return True

    def _need_filter(self, cnt_in_bin, total_cnt: int, filter_cnt: int) -> bool:
        """True if no split point could satisfy min-data on both sides
        (bin.cpp:48-71)."""
        if self.bin_type == NUMERICAL:
            return self._need_filter_numerical(cnt_in_bin, total_cnt, filter_cnt)
        if len(cnt_in_bin) <= 2:
            for c in cnt_in_bin[:-1]:
                if c >= filter_cnt and total_cnt - c >= filter_cnt:
                    return False
            return True
        return False

    # -- mapping -----------------------------------------------------------
    def value_to_bin(self, value: float) -> int:
        """bin.h:468-504."""
        if isinstance(value, (np.floating, float)) and math.isnan(value):
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == NUMERICAL:
            r = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                r -= 1
            l = 0
            while l < r:
                m = (r + l - 1) // 2
                if value <= self.bin_upper_bound[m]:
                    r = m
                else:
                    l = m + 1
            return l
        iv = int(value)
        if iv < 0:
            return self.num_bin - 1
        return self.categorical_2_bin.get(iv, self.num_bin - 1)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin for a whole column."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == NUMERICAL:
            nan_mask = np.isnan(values)
            v = np.where(nan_mask, 0.0, values)
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
            # first l with v <= upper_bound[l]; ub ends with +inf so the
            # result is always < n_search (matches the bin.h binary search)
            ub = self.bin_upper_bound[:n_search]
            bins = np.searchsorted(ub, v, side="left")
            bins = np.clip(bins, 0, n_search - 1)
            if self.missing_type == MISSING_NAN:
                bins = np.where(nan_mask, self.num_bin - 1, bins)
            return bins.astype(np.uint32)
        # categorical: vectorized dict lookup via sorted-key searchsorted,
        # matching the scalar value_to_bin semantics exactly
        nan_mask = np.isnan(values)
        fill = -1 if self.missing_type == MISSING_NAN else 0  # NaN->last bin | ->cat 0
        iv = np.where(nan_mask, fill, values).astype(np.int64)
        keys = np.array(sorted(self.categorical_2_bin), dtype=np.int64)
        vals = np.array([self.categorical_2_bin[k] for k in keys], dtype=np.uint32)
        pos = np.clip(np.searchsorted(keys, iv), 0, len(keys) - 1)
        hit = keys[pos] == iv
        out = np.where(hit & (iv >= 0), vals[pos], self.num_bin - 1).astype(np.uint32)
        return out

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative value for a bin (used for threshold real values)."""
        if self.bin_type == NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # -- (de)serialization for distributed find-bin ------------------------
    def to_state(self) -> dict:
        return {
            "num_bin": self.num_bin, "missing_type": self.missing_type,
            "is_trivial": self.is_trivial, "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": np.asarray(self.bin_upper_bound).tolist(),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val, "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_state(cls, state: dict) -> "BinMapper":
        m = cls()
        m.num_bin = state["num_bin"]
        m.missing_type = state["missing_type"]
        m.is_trivial = state["is_trivial"]
        m.sparse_rate = state["sparse_rate"]
        m.bin_type = state["bin_type"]
        m.bin_upper_bound = np.array(state["bin_upper_bound"])
        m.bin_2_categorical = list(state["bin_2_categorical"])
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = state["min_val"]
        m.max_val = state["max_val"]
        m.default_bin = state["default_bin"]
        return m

    def __repr__(self):
        kind = "cat" if self.bin_type == CATEGORICAL else "num"
        return "BinMapper(%s, num_bin=%d, missing=%s%s)" % (
            kind, self.num_bin, _MISSING_NAMES[self.missing_type],
            ", trivial" if self.is_trivial else "")
