# Copied from lightgbm_tpu/sklearn.py, with a `device` parameter that the
# wrappers pass to Dataset and train, and `get_params` returning the
# constructor's parameters without scikit-learn too (the JAX package's
# returns only the extra keyword arguments there, ROADMAP.md queue 3).
"""scikit-learn API wrappers.

Mirror of python-package/lightgbm/sklearn.py (868 LoC): LGBMModel base +
LGBMRegressor / LGBMClassifier / LGBMRanker, with custom-objective closures
over (y_true, y_pred [, weight, group]) and eval-metric wrappers returning
(name, value, is_higher_better) — same calling conventions so user code
moves over unchanged.  `device` is the port's: the CUDA card unless
device="cpu".
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import basic, engine

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.exceptions import NotFittedError
    from sklearn.preprocessing import LabelEncoder
    from sklearn.utils.validation import check_array
    _SKLEARN = True
except ImportError:  # pragma: no cover
    BaseEstimator = object

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass

    class NotFittedError(ValueError):
        pass
    LabelEncoder = None
    check_array = None
    _SKLEARN = False


class LGBMNotFittedError(NotFittedError):
    """Raised on predict-before-fit: a NotFittedError subclass so
    sklearn tooling (check_is_fitted, pipelines) recognizes it
    (reference compat.py LGBMNotFittedError)."""


def _check_X(X, estimator=None):
    """Input validation shared by fit/predict: rejects complex and empty
    inputs with sklearn's messages, accepts CSR/CSC sparse (the Dataset
    layer bins sparse columns natively) and preserves NaN (missing
    values are first-class in GBDTs)."""
    if _SKLEARN:
        return check_array(X, accept_sparse=["csr", "csc"],
                           dtype=np.float64, ensure_all_finite=False,
                           estimator=estimator)
    return np.asarray(X, np.float64)


def _call_with_dataset(func: Callable, preds, dataset, what: str):
    """Dispatch a user callback taking (y_true, y_pred[, weight[, group]]).

    The arity is taken from inspect.signature so functools.partial and
    bound methods work; errors raised inside the callback propagate
    unchanged (the reference wrappers, sklearn.py:24-214)."""
    import inspect

    labels = dataset.get_label()
    argsets = {2: (labels, preds),
               3: (labels, preds, dataset.get_weight()),
               4: (labels, preds, dataset.get_weight(), dataset.get_group())}
    try:
        params = inspect.signature(func).parameters.values()
        if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
            argc = 4
        else:
            argc = sum(p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
                       for p in params)
    except (TypeError, ValueError):
        argc = 2
    if argc not in argsets:
        raise TypeError("Self-defined %s should have 2-4 arguments" % what)
    return func(*argsets[argc])


def _objective_from_callable(func: Callable):
    """Wrap sklearn-style fobj(y_true, y_pred[, weight[, group]]) into the
    engine's fobj(preds, dataset) (sklearn.py:24-118 _ObjectiveFunctionWrapper)."""
    def wrapped(preds, dataset):
        grad, hess = _call_with_dataset(func, preds, dataset, "objective")
        return grad, hess
    return wrapped


def _eval_from_callable(func: Callable):
    """sklearn-style feval(y_true, y_pred[, weight[, group]]) ->
    engine feval(preds, dataset) (sklearn.py:120-214)."""
    def wrapped(preds, dataset):
        return _call_with_dataset(func, preds, dataset, "eval function")
    return wrapped


def _apply_class_weight(class_weight, y, sample_weight):
    """dict / 'balanced' class_weight -> per-sample weights folded into
    sample_weight (reference _LGBMComputeSampleWeight usage,
    python-package/lightgbm/sklearn.py:488-493).  Returns sample_weight
    unchanged when class_weight is None."""
    if class_weight is None:
        return sample_weight
    if _SKLEARN:
        from sklearn.utils.class_weight import compute_sample_weight
        cw = compute_sample_weight(class_weight, y)
    else:
        y = np.asarray(y)
        classes, counts = np.unique(y, return_counts=True)
        if class_weight == "balanced":
            wmap = {c: len(y) / (len(classes) * cnt)
                    for c, cnt in zip(classes, counts)}
        elif isinstance(class_weight, dict):
            wmap = {c: class_weight.get(c, 1.0) for c in classes}
        else:
            raise ValueError("class_weight must be 'balanced' or a dict")
        cw = np.array([wmap[v] for v in y], np.float64)
    if sample_weight is None or len(sample_weight) == 0:
        return cw
    return np.multiply(np.asarray(sample_weight, np.float64), cw)


class LGBMModel(BaseEstimator):
    """Base sklearn estimator (sklearn.py:216-617)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100,
                 subsample_for_bin=200000, objective=None, class_weight=None,
                 min_split_gain=0.0, min_child_weight=1e-3, min_child_samples=20,
                 subsample=1.0, subsample_freq=0, colsample_bytree=1.0,
                 reg_alpha=0.0, reg_lambda=0.0, random_state=None,
                 n_jobs=-1, silent=True, importance_type="split",
                 device=None, **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[basic.Booster] = None
        self._evals_result = None
        self._best_iteration = -1
        self._best_score = {}
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self.set_params(**kwargs)

    # -- sklearn plumbing --------------------------------------------------
    def get_params(self, deep=True):
        if _SKLEARN:
            params = super().get_params(deep=deep)
        else:
            # the constructor's named parameters, as BaseEstimator reads
            # them
            sig = inspect.signature(LGBMModel.__init__)
            params = {name: getattr(self, name)
                      for name, p in sig.parameters.items()
                      if name != "self" and p.kind != p.VAR_KEYWORD}
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, "_other_params"):
                self._other_params[key] = value
        return self

    def _process_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        params.pop("device", None)
        # sklearn-alias -> native names (sklearn.py:296-318)
        ren = {"boosting_type": "boosting", "min_split_gain": "min_gain_to_split",
               "min_child_weight": "min_sum_hessian_in_leaf",
               "min_child_samples": "min_data_in_leaf",
               "subsample": "bagging_fraction", "subsample_freq": "bagging_freq",
               "colsample_bytree": "feature_fraction",
               "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
               "random_state": "seed", "subsample_for_bin": "bin_construct_sample_cnt",
               "n_jobs": "num_threads"}
        for old, new in ren.items():
            if old in params:
                v = params.pop(old)
                if v is not None:
                    params[new] = v
        if params.get("seed") is None:
            params.pop("seed", None)
        if self.silent:
            params.setdefault("verbose", -1)
        obj = (self.objective if self.objective is not None
               else getattr(self, "_objective_resolved", None))
        if callable(obj):
            self._fobj = _objective_from_callable(obj)
            params["objective"] = "none"
        else:
            self._fobj = None
            if obj is not None:
                params["objective"] = obj
        # per-fit overrides (num_class etc.) — kept out of the constructor
        # params so refitting on different data re-derives them (sklearn
        # estimators must not mutate __init__ params in fit)
        params.update(getattr(self, "_fit_param_overrides", {}))
        return params

    # -- fit ---------------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto", callbacks=None):
        params = self._process_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        feval = _eval_from_callable(eval_metric) if callable(eval_metric) else None

        # class_weight -> per-sample weights multiplied into sample_weight
        # (reference fit path, python-package/lightgbm/sklearn.py:488-493).
        # LGBMClassifier folds it in on the ORIGINAL labels before
        # encoding (_cw_folded); this base path covers direct LGBMModel
        # users
        if not getattr(self, "_cw_folded", False):
            sample_weight = _apply_class_weight(self.class_weight, y,
                                                sample_weight)

        if y is None:
            raise ValueError(
                "requires y to be passed, but the target y is None")
        X = _check_X(X, estimator=self)
        if _SKLEARN:
            from sklearn.utils.validation import (check_consistent_length,
                                                  column_or_1d)
            if not callable(getattr(self, "objective", None)):
                # finite-label validation + 2d-column ravel with the
                # standard DataConversionWarning; custom objectives may
                # use unconventional label encodings, leave those alone
                y = column_or_1d(y, warn=True)
                y = check_array(y, ensure_2d=False, dtype=np.float64,
                                input_name="y")
            check_consistent_length(X, y)
        self._n_features = X.shape[1]
        # sklearn-protocol fitted marker (trailing underscore, set in
        # fit): check_is_fitted / pipelines key off it
        self.n_features_in_ = X.shape[1]
        train_set = basic.Dataset(X, label=y, weight=sample_weight,
                                  group=group, init_score=init_score,
                                  feature_name=feature_name,
                                  categorical_feature=categorical_feature,
                                  device=self.device)
        valid_sets: List[basic.Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = eval_sample_weight[i] if eval_sample_weight else None
                if eval_class_weight is not None and i < len(eval_class_weight):
                    vw = _apply_class_weight(eval_class_weight[i], vy, vw)
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(basic.Dataset(
                    np.asarray(vx, np.float64), label=vy, weight=vw, group=vg,
                    init_score=vi, reference=train_set, device=self.device))
                valid_names.append(eval_names[i] if eval_names
                                   else "valid_%d" % i)

        evals_result: Dict[str, Any] = {}
        self._Booster = engine.train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            fobj=self._fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks, device=self.device)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def predict(self, X, raw_score=False, num_iteration=-1,
                pred_leaf=False, pred_contrib=False, **kwargs):
        if self._Booster is None:
            raise LGBMNotFittedError(
                "Estimator not fitted, call fit before exploiting the model.")
        X = _check_X(X, estimator=self)
        if X.shape[1] != self._n_features:
            # sklearn's standard consistency error message
            raise ValueError(
                "X has %d features, but %s is expecting %d features "
                "as input." % (X.shape[1], type(self).__name__,
                               self._n_features))
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    # -- attributes --------------------------------------------------------
    @property
    def n_features_(self):
        return self._n_features

    @property
    def booster_(self) -> basic.Booster:
        if self._Booster is None:
            raise LGBMNotFittedError(
                "No booster found. Need to call fit first.")
        return self._Booster

    def __sklearn_tags__(self):
        tags = super().__sklearn_tags__()
        tags.input_tags.sparse = True      # Dataset bins CSR/CSC natively
        tags.input_tags.allow_nan = True   # missing values are first-class
        return tags

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(
            importance_type=self.importance_type)


class LGBMRegressor(RegressorMixin, LGBMModel):
    """sklearn.py:619-658."""

    def fit(self, X, y, **kwargs):
        self._objective_resolved = "regression"
        self._fit_param_overrides = {}
        return super().fit(X, y, **kwargs)


class LGBMClassifier(ClassifierMixin, LGBMModel):
    """sklearn.py:660-789."""

    def fit(self, X, y, **kwargs):
        if y is None:
            raise ValueError(
                "requires y to be passed, but the target y is None")
        y = np.asarray(y)
        if _SKLEARN:
            from sklearn.utils.multiclass import check_classification_targets
            from sklearn.utils.validation import column_or_1d
            if y.ndim > 1:
                y = column_or_1d(y, warn=True)
            if y.dtype.kind == "f" and not np.isfinite(y).all():
                raise ValueError(
                    "Input y contains NaN or infinity")
            # rejects continuous targets with the standard
            # "Unknown label type: continuous" error
            check_classification_targets(y)
        if LabelEncoder is not None:
            self._le = LabelEncoder().fit(y)
            y_enc = self._le.transform(y)
            self._classes = self._le.classes_
        else:
            self._classes = np.unique(y)
            y_enc = np.searchsorted(self._classes, y)
        self._n_classes = len(self._classes)
        self._objective_resolved = ("binary" if self._n_classes <= 2
                                    else "multiclass")
        self._fit_param_overrides = (
            {"num_class": self._n_classes} if self._n_classes > 2 else {})
        # dict class_weight keys refer to ORIGINAL labels: fold the
        # weights in here, before label encoding, so {label: w} works for
        # any label set (the v2.2.4 reference applies it to the encoded
        # labels — a landmine later LightGBM fixed; 'balanced' and
        # 0..k-1 integer dicts are unaffected either way)
        if self.class_weight is not None:
            kwargs["sample_weight"] = _apply_class_weight(
                self.class_weight, y, kwargs.get("sample_weight"))
        self._cw_folded = True
        try:
            return super().fit(X, y_enc, **kwargs)
        finally:
            self._cw_folded = False

    def predict(self, X, raw_score=False, num_iteration=-1,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration,
                                    pred_leaf, pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim > 1:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result > 0.5).astype(int)
        return np.asarray(self._classes)[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=-1,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        result = super().predict(X, raw_score, num_iteration,
                                 pred_leaf, pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    """sklearn.py:791-868."""

    def fit(self, X, y, group=None, eval_group=None, eval_at=(1, 2, 3, 4, 5),
            **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if kwargs.get("eval_set") is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        self._objective_resolved = "lambdarank"
        self._fit_param_overrides = {"ndcg_eval_at": list(eval_at)}
        self.eval_at = list(eval_at)
        return super().fit(X, y, group=group, eval_group=eval_group, **kwargs)
