"""Dataset and Booster: the port's public objects.

Port of `Dataset` (:78) and `Booster` (:373) of lightgbm_tpu/basic.py for
in-memory dense data with weights and query groups, with validation sets
and their evaluation
(`add_valid`, `eval_train`, `eval_valid`, :450-533).  Both take an explicit
`device`: the CUDA card unless the caller passes device="cpu"; with no
device and no CUDA they raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import Config
from .device import resolve_device
from .io.dataset import BinnedDataset
from .io.metadata import Metadata
from .metric import is_bigger_better, metrics_from_config
from .models import create_boosting
from .models.gbdt import GBDT
from .objective import create_objective
from .utils import log


class LightGBMError(Exception):
    pass


def _to_matrix(data, float32: bool = False):
    """(matrix, names): the input as a matrix, a pandas DataFrame (category
    columns as their codes, its column names as names) or Series, a scipy
    sparse matrix (kept sparse, as CSR), or anything numpy reads, a vector
    as one column; names None but for a DataFrame.  Copied from the
    in-memory branches of lightgbm_tpu/basic.py:31-64 `_to_matrix` (the
    file-path branch is not).  With float32, a float32 numpy array stays
    float32 (the device walk widens each value to f64 where it compares
    it, which is exact); everything else is f64."""
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            names = [str(c) for c in data.columns]
            cat_cols = [c for c in data.columns
                        if str(data[c].dtype) in ("category",)]
            df = data.copy()
            for c in cat_cols:
                df[c] = df[c].cat.codes
            return df.to_numpy(dtype=np.float64), names
        if isinstance(data, pd.Series):
            return data.to_numpy(dtype=np.float64)[:, None], None
    except ImportError:
        pass
    try:
        import scipy.sparse as sp
        if sp.issparse(data):
            return data.tocsr(), None
    except ImportError:
        pass
    if float32 and isinstance(data, np.ndarray) and data.dtype == np.float32:
        arr = data
    else:
        arr = np.asarray(data, np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr, None


# Copied from lightgbm_tpu/basic.py:67-76.
def _pandas_categorical_columns(data) -> List[int]:
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return [i for i, c in enumerate(data.columns)
                    if str(data[c].dtype) == "category"]
    except ImportError:
        pass
    return []


class Dataset:
    """Lazily-constructed training dataset."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, Sequence[str]] = "auto",
                 categorical_feature: Union[str, Sequence] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, device=None):
        self.device = resolve_device(device)
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        if isinstance(self.data, str):
            raise NotImplementedError(
                "a Dataset from a file path is not ported yet (ROADMAP.md "
                "queue 1, item 3)")
        mat, names = _to_matrix(self.data)
        if not isinstance(mat, np.ndarray):
            raise NotImplementedError(
                "a Dataset from sparse input is not ported yet (ROADMAP.md "
                "queue 1, item 3)")
        cfg = Config(self.params)
        meta = Metadata(mat.shape[0])
        if self.label is not None:
            meta.set_label(np.asarray(self.label))
        if self.weight is not None:
            meta.set_weights(np.asarray(self.weight))
        if self.group is not None:
            meta.set_query(np.asarray(self.group))
        if self.init_score is not None:
            meta.set_init_score(np.asarray(self.init_score))
        # category columns and names as lightgbm_tpu/basic.py:187-219 reads
        # them: a category column (its codes) reaches the binner as a
        # categorical feature
        categorical = []
        if self.categorical_feature == "auto":
            categorical = _pandas_categorical_columns(self.data)
        elif self.categorical_feature:
            for c in self.categorical_feature:
                if isinstance(c, str) and names and c in names:
                    categorical.append(names.index(c))
                elif isinstance(c, int):
                    categorical.append(c)
        if self.feature_name != "auto" and self.feature_name:
            names = list(self.feature_name)
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

    def set_group(self, group) -> "Dataset":
        """Set the query sizes (lightgbm_tpu/basic.py:312-315): group[i]
        rows of query i, in row order; a constructed dataset keeps its
        bins."""
        self.group = group
        if self._binned is not None and group is not None:
            self._binned.metadata.set_query(np.asarray(group))
        return self

    def get_group(self) -> Optional[np.ndarray]:
        """The query sizes, or None without queries
        (lightgbm_tpu/basic.py:332)."""
        self.construct()
        b = self._binned.metadata.query_boundaries
        return None if b is None else np.diff(b)


class Booster:
    """Booster over the port's GBDT driver."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set = train_set
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
            self._gbdt = create_boosting(cfg, train_set._binned, objective,
                                         self.device)
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

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Attach a validation set, evaluated with the config's metrics.  A
        dataset given no reference is binned on its own, as the JAX package
        bins it (lightgbm_tpu/basic.py add_valid), and a warning says what
        that does: its metric walks the trees' training bin thresholds over
        bins cut by other mappers, so it is not the metric of `predict` on
        those rows.  Pass `reference=train_set` to bin it with the training
        set's mappers."""
        if data.reference is None:
            log.warning(
                "Validation set '%s' has no reference: it is binned on its "
                "own mappers, and its metric walks the trees' training bin "
                "thresholds over those bins, so it is not the metric of "
                "predict() on its rows; pass reference=<the training "
                "Dataset> to bin it with the training set's mappers", name)
        data.construct()
        self._gbdt.add_valid(name, data._binned,
                             metrics_from_config(self.config))
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training cannot continue."""
        return self._gbdt.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_model_per_iteration(self) -> int:
        """Trees an iteration: num_class for multiclass, else one."""
        return self._gbdt.num_tree_per_iteration

    def eval_train(self) -> List[tuple]:
        """(dataset name, metric name, value, bigger_is_better) of each
        training metric."""
        return self._eval("training", self._gbdt.eval_train())

    def eval_valid(self) -> List[tuple]:
        out = []
        for name, res in self._gbdt.eval_valid().items():
            out.extend(self._eval(name, res))
        return out

    @staticmethod
    def _eval(name: str, results: Dict[str, List[float]]) -> List[tuple]:
        return [(name, metric_name, v, is_bigger_better(metric_name))
                for metric_name, vals in results.items() for v in vals]

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False, pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                device: Optional[bool] = None) -> np.ndarray:
        """Predictions of the first num_iteration iterations
        (lightgbm_tpu/basic.py:536-549): each row's leaf per tree
        (pred_leaf), its SHAP contributions (pred_contrib), or its scores,
        raw or through the objective's link, with the margin-based early
        stop.  Scores and leaves come from the device ensemble (KP1 on the
        card) unless device=False pins the host walk; they agree bit for
        bit.  A float32 array reaches the device walk as float32."""
        mat, _ = _to_matrix(data, float32=True)
        if pred_leaf:
            return self._gbdt.predict_leaf_index(mat, num_iteration,
                                                 device=device)
        if pred_contrib:
            return self._gbdt.predict_contrib(mat, num_iteration)
        return self._gbdt.predict(
            mat, num_iteration, raw_score=raw_score,
            early_stop=pred_early_stop,
            early_stop_freq=pred_early_stop_freq,
            early_stop_margin=pred_early_stop_margin, device=device)

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)
