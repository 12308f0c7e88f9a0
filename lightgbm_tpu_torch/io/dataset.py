"""The binned training dataset (in-memory numpy construction).

Port of `BinnedDataset.construct` of lightgbm_tpu/io/dataset.py for dense
numerical matrices: the same row sample for bin finding, the same
BinMappers (io/bin_mapper.py), the same trivial-feature filter and the same
EFB grouping decision (io/efb.py), so bin boundaries and the binned matrix
are equal bit for bit.  The bins become a uint8 [n, G] tensor on the
dataset's device.  File and binary-cache I/O, sparse input, categorical
features and real multi-feature bundles are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from . import efb
from .bin_mapper import NUMERICAL, BinMapper
from .metadata import Metadata


class BinnedDataset:
    """Binned feature matrix + per-feature mappers + metadata."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0          # raw column count
        self.used_feature_map: List[int] = []      # raw idx -> inner idx or -1
        self.real_feature_index: List[int] = []    # inner idx -> raw idx
        self.bin_mappers: List[BinMapper] = []     # per inner feature
        self.bins: Optional[np.ndarray] = None     # [n, F_used] uint8 host
        self.bundle = None                         # always None in the port
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
        bin mappers (validation-set path)."""
        if categorical_features:
            raise NotImplementedError(
                "categorical features are not ported yet (ROADMAP.md queue "
                "1, item 11)")
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
                         "max_bin"):
                setattr(ds, name, getattr(reference, name))
            ds.bins = ds.bin_block(X)
            return ds

        ds.max_bin = config.max_bin
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
                       config.min_data_in_bin, filter_cnt, NUMERICAL,
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
        ds._check_bundles(Xs, config)
        ds.bins = ds.bin_block(X)
        return ds

    def _check_bundles(self, Xs: np.ndarray, config) -> None:
        """The EFB grouping decision of the JAX dataset; a real
        multi-feature bundle raises, since the grower has no unbundling."""
        if not config.enable_bundle or self.num_features <= 1:
            return
        nonzero_rows = []
        for inner, raw in enumerate(self.real_feature_index):
            m = self.bin_mappers[inner]
            b = m.values_to_bins(np.asarray(Xs[:, raw], np.float64))
            nonzero_rows.append(np.flatnonzero(b != m.default_bin))
        bundle = efb.fast_feature_bundling(
            nonzero_rows, Xs.shape[0], [m.num_bin for m in self.bin_mappers],
            [m.default_bin for m in self.bin_mappers],
            config.max_conflict_rate, config.min_data_in_leaf, self.num_data)
        if bundle is not None:
            raise NotImplementedError(
                "EFB bundled %d features into %d groups; multi-feature "
                "bundles are not ported yet (ROADMAP.md queue 1, item 11); "
                "pass enable_bundle=False"
                % (self.num_features, bundle.num_groups))

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
        """[k, num_raw] floats -> [k, F_used] uint8 bins."""
        max_nb = max((m.num_bin for m in self.bin_mappers), default=2)
        if max_nb > 256:
            raise NotImplementedError(
                "features with more than 256 bins need the label engine "
                "(ROADMAP.md queue 1, item 11)")
        bins = np.empty((X.shape[0], self.num_features), dtype=np.uint8)
        for inner, raw in enumerate(self.real_feature_index):
            bins[:, inner] = self.bin_mappers[inner].values_to_bins(
                np.asarray(X[:, raw], dtype=np.float64)).astype(np.uint8)
        return bins

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def feature_num_bins(self) -> np.ndarray:
        return np.array([m.num_bin for m in self.bin_mappers], dtype=np.int32)

    def device_bins(self, device) -> torch.Tensor:
        """The binned matrix as a uint8 [n, G] tensor on `device` (cached)."""
        device = torch.device(device)
        if self._device_bins is None or self._device_bins.device != device:
            self._device_bins = torch.from_numpy(self.bins).to(device)
        return self._device_bins
