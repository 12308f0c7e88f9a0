"""Dataset and Booster: the port's public objects.

Port of `Dataset` (:78) and `Booster` (:373) of lightgbm_tpu/basic.py for
in-memory dense data.  Both take an explicit `device`: the CUDA card unless
the caller passes device="cpu"; with no device and no CUDA they raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from .config import Config
from .device import resolve_device
from .io.dataset import BinnedDataset
from .io.metadata import Metadata
from .models.gbdt import GBDT
from .objective import create_objective


class LightGBMError(Exception):
    pass


class Dataset:
    """Lazily-constructed training dataset."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, init_score=None,
                 feature_name: Union[str, Sequence[str]] = "auto",
                 categorical_feature: Union[str, Sequence] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, device=None):
        self.device = resolve_device(device)
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        mat = np.asarray(self.data, np.float64)
        if mat.ndim == 1:
            mat = mat[:, None]
        cfg = Config(self.params)
        meta = Metadata(mat.shape[0])
        if self.label is not None:
            meta.set_label(np.asarray(self.label))
        if self.weight is not None:
            meta.set_weights(np.asarray(self.weight))
        if self.init_score is not None:
            meta.set_init_score(np.asarray(self.init_score))
        categorical = ([] if self.categorical_feature in ("auto", None)
                       else list(self.categorical_feature))
        names = (list(self.feature_name)
                 if self.feature_name != "auto" and self.feature_name else None)
        ref = (self.reference.construct()._binned
               if self.reference is not None else None)
        self._binned = BinnedDataset.construct(
            mat, cfg, metadata=meta, categorical_features=categorical,
            feature_names=names, reference=ref)
        if self.free_raw_data:
            self.data = None
        return self

    def set_weight(self, weight) -> "Dataset":
        """Set (or, with None, clear) the row weights; a constructed
        dataset keeps its bins."""
        self.weight = weight
        if self._binned is not None:
            self._binned.metadata.set_weights(
                np.asarray(weight) if weight is not None else None)
        return self


class Booster:
    """Booster over the port's GBDT driver."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.params = dict(params) if params else {}
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise LightGBMError("Training data should be Dataset instance")
            if train_set._binned is None and self.params:
                merged = dict(train_set.params)
                merged.update(self.params)
                train_set.params = merged
            cfg = Config(self.params)
            train_set.construct()
            objective = create_objective(cfg.objective, cfg)
            self.config = cfg
            self._gbdt = GBDT(cfg, train_set._binned, objective, self.device)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self.config = Config(self.params)
            self._gbdt = GBDT(self.config, None, None, self.device)
            self._gbdt.load_model_from_string(model_str)
        else:
            raise LightGBMError("Booster needs at least one of train_set, "
                                "model_file, model_str")

    def update(self) -> bool:
        """One boosting iteration; True when training cannot continue."""
        return self._gbdt.train_one_iter()

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        return self._gbdt.predict(np.asarray(data, np.float64), num_iteration,
                                  raw_score=raw_score)

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)
