"""Dataset and Booster: the port's public objects.

Port of `Dataset` (:78) and `Booster` (:373) of lightgbm_tpu/basic.py for
in-memory dense data with weights, query groups and init scores: the
Dataset's fields, validation sets made by `create_valid` and row subsets
(`subset`, over the binned rows); the Booster's training (`update` with a
custom objective, `rollback_one_iter`, `reset_parameter`), evaluation
with custom eval functions, prediction, `refit`, model text in and out
(`save_model`, `model_from_string`, `dump_model`, pickling) and
introspection (`get_leaf_output`, `feature_importance`).  Both take an
explicit `device`: the CUDA card unless the caller passes device="cpu";
with no device and no CUDA they raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .config import Config, alias_transform
from .device import resolve_device
from .io.dataset import BinnedDataset
from .io.metadata import Metadata
from .metric import is_bigger_better, metrics_from_config
from .models import create_boosting, load_boosting_from_string
from .objective import create_objective
from .utils import log


class LightGBMError(log.LightGBMError):
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
        self.used_indices: Optional[np.ndarray] = None
        self._binned: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        if self.used_indices is not None and self.reference is not None:
            # a subset: the reference's binned rows (basic.py:161-165)
            ref = self.reference.construct()
            self._binned = ref._binned.subset(self.used_indices)
            self._set_fields(self._binned.metadata)
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
        self._set_fields(meta)
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

    def _set_fields(self, meta: Metadata) -> None:
        if self.weight is not None:
            meta.set_weights(np.asarray(self.weight))
        if self.group is not None:
            meta.set_query(np.asarray(self.group))
        if self.init_score is not None:
            meta.set_init_score(np.asarray(self.init_score))

    # -- the python-side surface (lightgbm_tpu/basic.py:234-371) ---------
    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers, on its
        device."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, device=self.device)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows used_indices (sorted) of this dataset, cut from its
        binned rows when constructed: no binning anew."""
        ds = Dataset(None, reference=self, params=params or self.params,
                     device=self.device)
        ds.used_indices = np.sort(np.asarray(used_indices))
        return ds

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None and label is not None:
            self._binned.metadata.set_label(np.asarray(label))
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

    def set_init_score(self, init_score) -> "Dataset":
        """The rows' initial raw scores (class-major [k*n], or [n, k]);
        the score a booster on this dataset starts from."""
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(init_score)
        return self

    def get_group(self) -> Optional[np.ndarray]:
        """The query sizes, or None without queries
        (lightgbm_tpu/basic.py:332)."""
        self.construct()
        b = self._binned.metadata.query_boundaries
        return None if b is None else np.diff(b)

    def get_label(self):
        self.construct()
        return self._binned.metadata.label

    def get_weight(self):
        self.construct()
        return self._binned.metadata.weights

    def get_init_score(self):
        self.construct()
        return self._binned.metadata.init_score

    def get_field(self, name):
        getter = {"label": self.get_label, "weight": self.get_weight,
                  "group": self.get_group, "init_score": self.get_init_score}
        if name not in getter:
            raise LightGBMError("Unknown field name: %s" % name)
        return getter[name]()

    def set_field(self, name, data):
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group, "init_score": self.set_init_score}
        if name not in setter:
            raise LightGBMError("Unknown field name: %s" % name)
        return setter[name](data)

    def num_data(self) -> int:
        self.construct()
        return self._binned.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._binned.num_total_features

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._binned.feature_names)


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
        self._valid_sets: List[Tuple[str, Dataset]] = []
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise LightGBMError("Training data should be Dataset instance")
            if train_set._binned is None and self.params:
                merged = dict(train_set.params)
                merged.update(self.params)
                train_set.params = merged
            cfg = Config(self.params)
            train_set.construct()
            # objective=none: the rounds take a custom objective's
            # gradients (basic.py:465-470)
            objective = create_objective(cfg.objective, cfg)
            self.config = cfg
            self._gbdt = create_boosting(cfg, train_set._binned, objective,
                                         self.device)
        elif model_file is not None:
            with open(model_file) as f:
                self._init_from_string(f.read())
        elif model_str is not None:
            self._init_from_string(model_str)
        else:
            raise LightGBMError("Booster needs at least one of train_set, "
                                "model_file, model_str")

    def _init_from_string(self, text: str) -> None:
        self.config = Config(self.params)
        self._gbdt = load_boosting_from_string(text, self.config,
                                               self.device)

    # -- training ----------------------------------------------------------
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
        self._valid_sets.append((name, data))
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when training cannot continue.
        fobj(preds, train_set) -> (grad, hess): a custom objective of the
        training scores (raw, f64, flat class-major for k > 1), whose
        gradients the round trains on (basic.py:457-470)."""
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = fobj(self._gbdt.raw_scores("training"),
                          self._train_set)
        return self._gbdt.train_one_iter(np.asarray(grad, np.float64),
                                         np.asarray(hess, np.float64))

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's trees and their scores."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Reset parameters of the live booster (basic.py:476-504): the
        learning rate alone takes effect at the next round with no new
        graph and no drain; anything else syncs the model and rebuilds the
        config and split parameters, and the next round of each graph key
        captures anew."""
        updates = alias_transform(dict(params))
        merged = dict(self.params)
        merged.update(params)
        self.params = merged
        if set(updates) <= {"learning_rate"}:
            lr = updates.get("learning_rate")
            if lr is not None:
                self.config.learning_rate = float(lr)
                self._gbdt.config.learning_rate = float(lr)
                self._gbdt.set_learning_rate(float(lr))
            return self
        self.config = Config(merged)
        self._gbdt.reset_config(self.config)
        return self

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_model_per_iteration(self) -> int:
        """Trees an iteration: num_class for multiclass, else one."""
        return self._gbdt.num_tree_per_iteration

    # -- evaluation --------------------------------------------------------
    def eval_train(self, feval=None) -> List[tuple]:
        """(dataset name, metric name, value, bigger_is_better) of each
        training metric, then of feval(preds, train_set) (a tuple of
        (name, value, bigger_is_better) or a list of them)."""
        out = self._eval("training", self._gbdt.eval_train())
        if feval is not None:
            out.extend(_normalize_feval(
                feval(self._gbdt.raw_scores("training"), self._train_set),
                "training"))
        return out

    def eval_valid(self, feval=None) -> List[tuple]:
        """The same for each validation set, its metrics then feval's."""
        out = []
        data = dict(self._valid_sets)
        for name, res in self._gbdt.eval_valid().items():
            out.extend(self._eval(name, res))
            if feval is not None:
                out.extend(_normalize_feval(
                    feval(self._gbdt.raw_scores(name), data.get(name)),
                    name))
        return out

    @staticmethod
    def _eval(name: str, results: Dict[str, List[float]]) -> List[tuple]:
        return [(name, metric_name, v, is_bigger_better(metric_name))
                for metric_name, vals in results.items() for v in vals]

    # -- prediction --------------------------------------------------------
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

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new Booster on this one's device, its leaf values refit on
        (data, label) (basic.py:551-560): new = decay_rate * old +
        (1 - decay_rate) * the leaf output of the rows' gradients."""
        mat, _ = _to_matrix(data, float32=True)
        new_booster = Booster(model_str=self.model_to_string(),
                              params=dict(self.params,
                                          refit_decay_rate=decay_rate),
                              device=self.device)
        new_booster._gbdt.refit(mat, label, **kwargs)
        return new_booster

    def refit_inplace(self, data, label, weight=None,
                      group=None) -> "Booster":
        """Refit this booster's leaf values in place (basic.py:562-567)."""
        mat, _ = _to_matrix(data, float32=True)
        self._gbdt.refit(mat, label, weight=weight, group=group)
        return self

    # -- model text and introspection --------------------------------------
    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0) -> "Booster":
        """The model text, written atomically (basic.py:570-577)."""
        self._gbdt.save_model_to_file(filename, start_iteration,
                                      num_iteration)
        return self

    def model_to_string(self, num_iteration: int = -1,
                        start_iteration: int = 0) -> str:
        return self._gbdt.save_model_to_string(start_iteration, num_iteration)

    def model_from_string(self, model_str: str) -> "Booster":
        """This booster's model replaced by model text (basic.py:591-598)."""
        self._init_from_string(model_str)
        self.best_iteration = -1
        return self

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as a JSON-style dict (basic.py:579-589)."""
        return self._gbdt.dump_model(num_iteration)

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """The raw output of one leaf (basic.py:600-603)."""
        return self._gbdt.get_leaf_output(tree_id, leaf_id)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        """Per feature, its splits ("split") or their summed gains
        ("gain") in the first `iteration` iterations (basic.py:605-607)."""
        return self._gbdt.feature_importance(importance_type, iteration)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def __getstate__(self):
        """Pickled as its params, model text and best round
        (basic.py:614-628); it unpickles on the same device."""
        return {"params": self.params, "model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score, "device": str(self.device)}

    def __setstate__(self, state):
        self.params = state["params"]
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self.device = resolve_device(state["device"])
        self._train_set = None
        self._valid_sets = []
        self._init_from_string(state["model_str"])


# Copied from lightgbm_tpu/engine.py:274-281.
def _normalize_feval(res, data_name):
    """feval returns (name, value, bigger_is_better) or a list of them."""
    if res is None:
        return []
    if isinstance(res, tuple):
        res = [res]
    return [(data_name, r[0], r[1], r[2]) for r in res]
