"""The binned training dataset (in-memory numpy construction).

Port of `BinnedDataset.construct` of lightgbm_tpu/io/dataset.py for dense
matrices: the same row sample for bin finding, the same BinMappers
(io/bin_mapper.py, numerical or categorical), the same trivial-feature
filter and the same EFB bundles (io/efb.py), so bin boundaries and the
binned matrix are equal bit for bit.  The bins are [n, G] columns, one a
feature or, with bundles, one an EFB group: uint8, or uint16 where any
column has more than 256 bins (lightgbm_tpu/io/dataset.py:376-378,
:396-397).  On the dataset's device they are a uint8 tensor, or an int16
tensor holding the uint16 bins' bytes (PyTorch's uint16 dtype takes few
operations): the kernels read it as uint16, and plain code widens a value
by `bin_values`.  A row subset (`subset`) shares the mappers and copies
the binned rows.  File and binary-cache I/O and sparse input are not
ported yet (ROADMAP.md queue 1, item 3).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from . import efb
from .bin_mapper import CATEGORICAL, NUMERICAL, BinMapper
from .metadata import Metadata


class BinnedDataset:
    """Binned feature matrix + per-feature mappers + metadata."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0          # raw column count
        self.used_feature_map: List[int] = []      # raw idx -> inner idx or -1
        self.real_feature_index: List[int] = []    # inner idx -> raw idx
        self.bin_mappers: List[BinMapper] = []     # per inner feature
        self.bins: Optional[np.ndarray] = None     # [n, G] uint8/16 host
        self.bundle: Optional[efb.BundleInfo] = None   # EFB layout or None
        self.feature_offsets: Optional[np.ndarray] = None
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.monotone_constraints: Optional[np.ndarray] = None  # [F_used] i8
        self.feature_penalty: Optional[np.ndarray] = None       # [F_used] f64
        self.max_bin: int = 255
        self._device_bins: Optional[torch.Tensor] = None

    @classmethod
    def construct(cls, X: np.ndarray, config,
                  metadata: Optional[Metadata] = None,
                  categorical_features: Sequence[int] = (),
                  feature_names: Optional[Sequence[str]] = None,
                  reference: Optional["BinnedDataset"] = None
                  ) -> "BinnedDataset":
        """Build from a dense raw float matrix; with `reference`, reuse its
        bin mappers and bundles (validation-set path)."""
        X = np.asarray(X)
        if X.ndim != 2:
            log.fatal("Input data must be 2-dimensional")
        n, num_raw = X.shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_raw
        ds.metadata = metadata if metadata is not None else Metadata(n)
        ds.metadata.init(n)
        if reference is not None:
            if num_raw != reference.num_total_features:
                log.fatal("The number of features in data (%d) is not the "
                          "same as it was in training data (%d)"
                          % (num_raw, reference.num_total_features))
            for name in ("used_feature_map", "real_feature_index",
                         "bin_mappers", "feature_names", "feature_offsets",
                         "monotone_constraints", "feature_penalty",
                         "max_bin", "bundle"):
                setattr(ds, name, getattr(reference, name))
            ds.bins = ds.bin_block(X)
            return ds

        ds.max_bin = config.max_bin
        cat_set = set(int(c) for c in categorical_features)
        sample_cnt = min(config.bin_construct_sample_cnt, n)
        rng = np.random.RandomState(config.data_random_seed)
        sample_indices = (np.arange(n) if sample_cnt >= n else
                          np.sort(rng.choice(n, sample_cnt, replace=False)))
        Xs = X[sample_indices]
        # trivial-feature filter count scales with the sampling fraction
        # (dataset_loader.cpp:849-850)
        filter_cnt = max(1, int(config.min_data_in_leaf
                                * len(sample_indices) / n))
        mappers = []
        for f in range(num_raw):
            col = np.asarray(Xs[:, f], dtype=np.float64)
            nonzero = col[(np.abs(col) > 1e-35) | np.isnan(col)]
            m = BinMapper()
            m.find_bin(nonzero, Xs.shape[0], config.max_bin,
                       config.min_data_in_bin, filter_cnt,
                       CATEGORICAL if f in cat_set else NUMERICAL,
                       config.use_missing, config.zero_as_missing)
            mappers.append(m)
        ds.used_feature_map = [-1] * num_raw
        for f, m in enumerate(mappers):
            if not m.is_trivial:
                ds.used_feature_map[f] = len(ds.real_feature_index)
                ds.real_feature_index.append(f)
                ds.bin_mappers.append(m)
        if not ds.real_feature_index:
            log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        ds.feature_names = (list(feature_names) if feature_names
                            else ["Column_%d" % i for i in range(num_raw)])
        nb = [m.num_bin for m in ds.bin_mappers]
        ds.feature_offsets = np.concatenate([[0], np.cumsum(nb)]).astype(
            np.int32)
        ds._resolve_constraints(config)
        ds._find_bundles(Xs, config)
        ds.bins = ds.bin_block(X)
        return ds

    def _find_bundles(self, Xs: np.ndarray, config) -> None:
        """EFB grouping from the sampled rows (lightgbm_tpu/io/dataset.py
        `_find_bundles`, FastFeatureBundling, dataset.cpp:139-212)."""
        if not config.enable_bundle or self.num_features <= 1:
            return
        if config.tree_learner == "feature":
            # feature-parallel shards scan units by raw feature
            log.debug("EFB disabled for feature-parallel tree learner")
            return
        nonzero_rows = []
        for inner, raw in enumerate(self.real_feature_index):
            m = self.bin_mappers[inner]
            b = m.values_to_bins(np.asarray(Xs[:, raw], np.float64))
            nonzero_rows.append(np.flatnonzero(b != m.default_bin))
        self.bundle = efb.fast_feature_bundling(
            nonzero_rows, Xs.shape[0], [m.num_bin for m in self.bin_mappers],
            [m.default_bin for m in self.bin_mappers],
            config.max_conflict_rate, config.min_data_in_leaf, self.num_data)
        if self.bundle is not None:
            log.info("EFB bundled %d features into %d groups",
                     self.num_features, self.bundle.num_groups)

    def _resolve_constraints(self, config) -> None:
        if config.monotone_constraints:
            if len(config.monotone_constraints) != self.num_total_features:
                log.fatal("monotone_constraints has %d entries but data has "
                          "%d features" % (len(config.monotone_constraints),
                                           self.num_total_features))
            self.monotone_constraints = np.array(
                [config.monotone_constraints[raw]
                 for raw in self.real_feature_index], dtype=np.int8)
        if config.feature_contri:
            if len(config.feature_contri) != self.num_total_features:
                log.fatal("feature_contri has %d entries but data has %d "
                          "features" % (len(config.feature_contri),
                                        self.num_total_features))
            self.feature_penalty = np.array(
                [config.feature_contri[raw] for raw in self.real_feature_index],
                dtype=np.float64)

    def bin_block(self, X) -> np.ndarray:
        """[k, num_raw] floats -> [k, G] bins: one column a feature, or
        with bundles one a group, its features' non-default bins shifted
        into the group's range, later features of a group winning
        conflicts (lightgbm_tpu/io/dataset.py `bin_block`); uint8, or
        uint16 where a column has more than 256 bins (:376-378,
        :396-397)."""
        n = X.shape[0]
        info = self.bundle
        max_nb = (int(info.group_num_bins.max()) if info is not None else
                  max((m.num_bin for m in self.bin_mappers), default=2))
        if max_nb > 65536:
            raise ValueError("a column of %d bins does not fit uint16 bins"
                             % max_nb)
        dtype = np.uint8 if max_nb <= 256 else np.uint16

        def feature_bins(inner):
            return self.bin_mappers[inner].values_to_bins(np.asarray(
                X[:, self.real_feature_index[inner]], np.float64))

        def group_bins(feats):
            if len(feats) == 1:
                return feature_bins(feats[0]).astype(dtype)
            col = np.zeros(n, np.int64)
            for inner in feats:
                b = feature_bins(inner).astype(np.int64)
                nz = b != int(info.feature_default[inner])
                col = np.where(nz, b + int(info.feature_shift[inner]), col)
            return col.astype(dtype)

        groups = ([[f] for f in range(self.num_features)] if info is None
                  else info.groups)
        bins = np.empty((n, len(groups)), dtype=dtype)
        for g, feats in enumerate(groups):
            bins[:, g] = group_bins(feats)
        return bins

    # Copied from lightgbm_tpu/io/dataset.py:715-731.
    def subset(self, indices: np.ndarray) -> "BinnedDataset":
        """Row-subset copy sharing mappers (dataset.h CopySubset)."""
        out = BinnedDataset()
        out.num_data = len(indices)
        out.num_total_features = self.num_total_features
        out.used_feature_map = list(self.used_feature_map)
        out.real_feature_index = list(self.real_feature_index)
        out.bin_mappers = self.bin_mappers
        out.bins = self.bins[indices]
        out.feature_offsets = self.feature_offsets
        out.feature_names = list(self.feature_names)
        out.monotone_constraints = self.monotone_constraints
        out.feature_penalty = self.feature_penalty
        out.max_bin = self.max_bin
        out.bundle = self.bundle
        out.metadata = self.metadata.subset(np.asarray(indices))
        return out

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def feature_num_bins(self) -> np.ndarray:
        return np.array([m.num_bin for m in self.bin_mappers], dtype=np.int32)

    @property
    def num_groups(self) -> int:
        """Columns of the bin matrix: EFB groups, or one a feature."""
        return (self.bundle.num_groups if self.bundle is not None
                else self.num_features)

    @property
    def is_categorical(self) -> np.ndarray:
        """bool [F]: the features binned as categories."""
        return np.array([m.bin_type == CATEGORICAL for m in self.bin_mappers],
                        bool)

    def hist_max_bin(self) -> int:
        """Bins per histogram column: the largest group's (up to 256 with
        bundles, whatever max_bin is) or feature's bin count
        (lightgbm_tpu/models/gbdt.py `_DatasetState.hist_max_bin`)."""
        if self.bundle is not None:
            return int(self.bundle.group_num_bins.max())
        return int(self.feature_num_bins().max()) if self.num_features else 2

    def device_bins(self, device) -> torch.Tensor:
        """The binned matrix as an [n, G] tensor on `device` (cached):
        uint8, or int16 holding uint16 bins' bytes (`bin_values` reads
        them)."""
        device = torch.device(device)
        if self._device_bins is None or self._device_bins.device != device:
            host = self.bins
            if host.dtype == np.uint16:
                host = host.view(np.int16)
            self._device_bins = torch.from_numpy(host).to(device)
        return self._device_bins


def bin_values(bins: torch.Tensor) -> torch.Tensor:
    """Device bins (uint8, or int16 holding uint16 bins) as their int64
    values: an int16 value is widened and its sign bits cleared."""
    if bins.dtype == torch.int16:
        return bins.long() & 0xFFFF
    return bins.long()
