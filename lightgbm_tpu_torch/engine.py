"""Training and cross-validation: port of lightgbm_tpu/engine.py `train`
(:29-271) and `cv` (:290-442) with validation sets, training metrics,
custom objectives and eval functions, continued training (`init_model`),
callbacks before and after each round (learning-rate schedules among
them) and early stopping.  Checkpoint resume (`resume_from`) is not
ported yet and raises."""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError, _normalize_feval
from .config import ALIAS_TABLE
from .metric import metrics_from_config
from .utils import log


def _pop_param(params: Dict[str, Any], canonical: str, default):
    """Pop a parameter under any of its config-table aliases."""
    out = default
    for name in [canonical] + [a for a, c in ALIAS_TABLE.items()
                               if c == canonical]:
        if name in params:
            out = params.pop(name)
    return out


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None, evals_result=None,
          verbose_eval=True, learning_rates=None,
          keep_training_booster: bool = False, callbacks=None,
          resume_from: Optional[str] = None, device=None) -> Booster:
    """Train a booster for num_boost_round rounds (fewer when no leaf can
    split any more, or when early stopping ends it) on `device`: the CUDA
    card unless device="cpu".  valid_sets are evaluated after every round
    with the config's metrics (the training set among them gives training
    metrics, as `is_provide_training_metric` does) and with
    feval(preds, dataset); evals_result collects the values and
    `best_iteration` the early-stopping round.  fobj(preds, train_set) ->
    (grad, hess) trains on a custom objective (objective=none).
    init_model (a Booster or a model file) continues training: its raw
    predictions, walked by KP1 on the device, become the init scores of
    every dataset not yet constructed, and the new booster holds only the
    new trees (the JAX package's rule; upstream LightGBM merges).
    learning_rates (a list a round, or a function of the round) schedules
    the learning rate through `callback.reset_parameter`."""
    params = dict(params) if params else {}
    num_boost_round = int(_pop_param(params, "num_iterations", num_boost_round))
    esr = _pop_param(params, "early_stopping_round", early_stopping_rounds)
    early_stopping_rounds = int(esr) if esr is not None else None
    if num_boost_round <= 0:
        raise LightGBMError("num_boost_round should be greater than zero.")
    if resume_from is not None:
        raise NotImplementedError("checkpoint resume (resume_from) is not "
                                  "ported yet (ROADMAP.md queue 1, item 14)")
    if fobj is not None:
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    init_iters = 0
    if init_model is not None:
        if isinstance(init_model, str):
            predictor = Booster(model_file=init_model, params=params,
                                device=device)
        else:
            predictor = Booster(model_str=init_model.model_to_string(),
                                params=params, device=device)
        init_iters = predictor.current_iteration
        # the old model's raw predictions seed the scores
        # (engine.py:84-99, _set_init_score_by_predictor)
        for ds in [train_set] + list(valid_sets or []):
            if ds is None or ds._binned is not None \
                    or ds.init_score is not None or ds.data is None:
                continue
            ds.init_score = np.asarray(predictor.predict(ds.data,
                                                         raw_score=True))

    booster = Booster(params=params, train_set=train_set, device=device)

    is_valid_contain_train = False
    train_data_name = "training"
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, valid_data in enumerate(valid_sets):
            name = valid_names[i] if valid_names else "valid_%d" % i
            if valid_data is train_set:
                is_valid_contain_train = True
                train_data_name = name
                continue
            booster.add_valid(valid_data, name)
    booster._train_data_name = train_data_name

    cfg = booster.config
    if is_valid_contain_train or cfg.is_provide_training_metric:
        for m in metrics_from_config(cfg):
            m.init(train_set._binned.metadata, train_set._binned.num_data)
            booster._gbdt.train_metrics.append(m)

    begin_round, end_round = init_iters, init_iters + num_boost_round
    callbacks = set(callbacks) if callbacks else set()
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if verbose_eval is True:
        callbacks.add(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.add(callback_mod.print_evaluation(verbose_eval))
    if learning_rates is not None:
        callbacks.add(callback_mod.reset_parameter(
            learning_rate=learning_rates))
    if evals_result is not None:
        callbacks.add(callback_mod.record_evaluation(evals_result))
    cb_before = {cb for cb in callbacks
                 if getattr(cb, "before_iteration", False)}
    cb_after = sorted(callbacks - cb_before,
                      key=lambda cb: getattr(cb, "order", 0))
    cb_before = sorted(cb_before, key=lambda cb: getattr(cb, "order", 0))

    def env(i, results):
        return callback_mod.CallbackEnv(
            model=booster, params=params, iteration=i,
            begin_iteration=begin_round, end_iteration=end_round,
            evaluation_result_list=results)

    for i in range(begin_round, end_round):
        try:
            for cb in cb_before:
                cb(env(i, None))
        except callback_mod.EarlyStopException as es:
            # a stop before the round: best_iteration counts the rounds
            # already trained (engine.py:205-213)
            booster.best_iteration = es.best_iteration + 1
            _record_best(booster, es.best_score)
            break
        finished = booster.update(fobj=fobj)
        evaluation_result_list = []
        if valid_sets is not None or booster._gbdt.train_metrics:
            if is_valid_contain_train or booster._gbdt.train_metrics:
                for _, mname, v, bigger in booster.eval_train():
                    evaluation_result_list.append(
                        (train_data_name, mname, v, bigger))
            evaluation_result_list.extend(booster.eval_valid())
        if feval is not None:
            # engine.py:225-236: feval on the training set when it is among
            # the validation sets, then on each validation set
            if is_valid_contain_train:
                evaluation_result_list.extend(_normalize_feval(
                    feval(booster._gbdt.raw_scores("training"), train_set),
                    train_data_name))
            for name, vds in booster._valid_sets:
                evaluation_result_list.extend(_normalize_feval(
                    feval(booster._gbdt.raw_scores(name), vds), name))
        try:
            for cb in cb_after:
                cb(env(i, evaluation_result_list))
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            _record_best(booster, es.best_score)
            break
        if finished:
            break
    # the deferred trees drained before the count (lightgbm_tpu/engine.py:
    # 257-267): a drain may still trim trailing degenerate rounds
    booster._gbdt._sync_model()
    if booster.best_iteration <= 0:
        booster.best_iteration = (booster.num_trees()
                                  // booster.num_model_per_iteration())
    if not keep_training_booster:
        booster._train_set = None
    return booster


# Copied from lightgbm_tpu/engine.py:284-288.
def _record_best(booster, best_score_list):
    booster.best_score = collections.defaultdict(dict)
    if best_score_list:
        for name, metric, v, _ in best_score_list:
            booster.best_score[name][metric] = v


def cv(params, train_set, num_boost_round=100, folds=None, nfold=5,
       stratified=True, shuffle=True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv=True, seed=0, callbacks=None, device=None):
    """k-fold cross-validation (engine.py:290-388): the folds of
    `_make_folds` (stratified, shuffled or by query group), each a booster
    on `device` trained over a `subset` of the binned set (no binning
    anew) with its held-out rows as the validation set "valid"; returns
    {metric-mean: [...], metric-stdv: [...]} a round, cut at early
    stopping's best round.  init_model is not used, as in the JAX
    package."""
    params = dict(params) if params else {}
    num_boost_round = int(_pop_param(params, "num_iterations", num_boost_round))
    esr = _pop_param(params, "early_stopping_round", early_stopping_rounds)
    early_stopping_rounds = int(esr) if esr is not None else None
    if metrics is not None:
        params["metric"] = metrics
    if fobj is not None:
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    train_set.construct()
    n = train_set.num_data()
    label = train_set.get_label()
    group = train_set.get_group()

    folds = _make_folds(folds, nfold, n, label, group, stratified, shuffle,
                        seed, params)

    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr = train_set.subset(sorted(train_idx))
        te = train_set.subset(sorted(test_idx))
        fold_params = params
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, params.copy())
        bst = Booster(params=fold_params, train_set=tr, device=device)
        bst.add_valid(te, "valid")
        bst._cv_test_set = te
        cvbooster.append(bst)

    callbacks = sorted(callbacks or [], key=lambda cb: getattr(cb, "order", 0))
    cb_before = [cb for cb in callbacks
                 if getattr(cb, "before_iteration", False)]
    cb_after = [cb for cb in callbacks
                if not getattr(cb, "before_iteration", False)]

    results = collections.defaultdict(list)
    for i in range(num_boost_round):
        for cb in cb_before:
            cb(callback_mod.CallbackEnv(model=cvbooster, params=params,
                                        iteration=i, begin_iteration=0,
                                        end_iteration=num_boost_round,
                                        evaluation_result_list=None))
        agg = collections.defaultdict(list)
        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            for name, mname, v, bigger in bst.eval_valid():
                agg[(name, mname, bigger)].append(v)
            if feval is not None:
                res = feval(bst._gbdt.raw_scores("valid"), bst._cv_test_set)
                for _nm, mname, v, bigger in _normalize_feval(res, "valid"):
                    agg[("valid", mname, bigger)].append(v)
        merged = {}
        agg_list = []
        for (name, mname, bigger), vals in agg.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[mname + "-mean"].append(mean)
            results[mname + "-stdv"].append(std)
            merged[(name, mname, bigger)] = (mean, std)
            agg_list.append(("cv_agg", mname, mean, bigger, std))
        if verbose_eval:
            log.info("[%d]\t%s", i + 1, "\t".join(
                "cv_agg's %s: %g%s" % (mn, results[mn + "-mean"][-1],
                                       " + %g" % results[mn + "-stdv"][-1]
                                       if show_stdv else "")
                for (_, mn, _b) in merged))
        try:
            for cb in cb_after:
                cb(callback_mod.CallbackEnv(model=cvbooster, params=params,
                                            iteration=i, begin_iteration=0,
                                            end_iteration=num_boost_round,
                                            evaluation_result_list=agg_list))
        except callback_mod.EarlyStopException as es:
            cvbooster.best_iteration = es.best_iteration + 1
            for k in results:
                results[k] = results[k][:es.best_iteration + 1]
            return dict(results)
        if early_stopping_rounds is not None and early_stopping_rounds > 0 \
                and i > 0:
            for (name, mname, bigger), (mean, _std) in merged.items():
                hist = results[mname + "-mean"]
                best_idx = int(np.argmax(hist) if bigger else np.argmin(hist))
                if i - best_idx >= early_stopping_rounds:
                    for k in results:
                        results[k] = results[k][:best_idx + 1]
                    return dict(results)
    return dict(results)


class CVBooster:
    """The folds' boosters of a `cv` run (engine.py:391-397)."""

    def __init__(self):
        self.boosters = []
        self.best_iteration = -1

    def append(self, booster):
        self.boosters.append(booster)


# Copied from lightgbm_tpu/engine.py:400-442.
def _make_folds(folds, nfold, n, label, group, stratified, shuffle, seed,
                params):
    if folds is not None:
        if hasattr(folds, "split"):
            group_info = group.astype(int) if group is not None else None
            flatted_group = (np.repeat(range(len(group_info)), repeats=group_info)
                             if group_info is not None else np.zeros(n, int))
            return list(folds.split(X=np.zeros(n), y=label,
                                    groups=flatted_group))
        return list(folds)
    if group is not None:
        # group-aware folds (engine.py _make_n_folds group path)
        group_boundaries = np.concatenate([[0], np.cumsum(group)])
        ngroups = len(group)
        rng = np.random.RandomState(seed)
        gidx = rng.permutation(ngroups) if shuffle else np.arange(ngroups)
        out = []
        fold_sizes = np.full(nfold, ngroups // nfold)
        fold_sizes[:ngroups % nfold] += 1
        start = 0
        for fs in fold_sizes:
            test_groups = gidx[start:start + fs]
            test_idx = np.concatenate(
                [np.arange(group_boundaries[g], group_boundaries[g + 1])
                 for g in test_groups]) if fs else np.array([], int)
            train_idx = np.setdiff1d(np.arange(n), test_idx)
            out.append((train_idx, test_idx))
            start += fs
        return out
    if stratified and label is not None and len(np.unique(label)) > 1:
        try:
            from sklearn.model_selection import StratifiedKFold
            skf = StratifiedKFold(n_splits=nfold, shuffle=shuffle,
                                  random_state=seed if shuffle else None)
            return list(skf.split(np.zeros(n), label))
        except ImportError:
            log.warning("sklearn not available; falling back to plain folds")
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    out = []
    fold_sizes = np.full(nfold, n // nfold)
    fold_sizes[:n % nfold] += 1
    start = 0
    for fs in fold_sizes:
        test_idx = idx[start:start + fs]
        train_idx = np.setdiff1d(np.arange(n), test_idx)
        out.append((train_idx, test_idx))
        start += fs
    return out
