"""Training entry point: port of lightgbm_tpu/engine.py `train` (:29-271)
with validation sets, training metrics, evaluation callbacks and early
stopping.  Custom objectives and evaluation functions, continued training,
checkpoint resume, learning-rate schedules and `cv` are not ported yet and
raise."""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError
from .config import ALIAS_TABLE
from .metric import metrics_from_config


def _pop_param(params: Dict[str, Any], canonical: str, default):
    """Pop a parameter under any of its config-table aliases."""
    out = default
    for name in [canonical] + [a for a, c in ALIAS_TABLE.items()
                               if c == canonical]:
        if name in params:
            out = params.pop(name)
    return out


def _not_ported(what: str, item: str = "queue 1, item 7b") -> None:
    raise NotImplementedError("%s is not ported yet (ROADMAP.md %s)"
                              % (what, item))


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          early_stopping_rounds: Optional[int] = None, evals_result=None,
          verbose_eval=True, learning_rates=None, callbacks=None,
          resume_from: Optional[str] = None, device=None) -> Booster:
    """Train a booster for num_boost_round rounds (fewer when no leaf can
    split any more, or when early stopping ends it) on `device`: the CUDA
    card unless device="cpu".  valid_sets are evaluated after every round
    with the config's metrics (the training set among them gives training
    metrics, as `is_provide_training_metric` does); evals_result collects
    the values and `best_iteration` the early-stopping round."""
    params = dict(params) if params else {}
    num_boost_round = int(_pop_param(params, "num_iterations", num_boost_round))
    esr = _pop_param(params, "early_stopping_round", early_stopping_rounds)
    early_stopping_rounds = int(esr) if esr is not None else None
    if num_boost_round <= 0:
        raise LightGBMError("num_boost_round should be greater than zero.")
    if fobj is not None or feval is not None:
        _not_ported("custom objectives and evaluation functions (fobj, feval)")
    if init_model is not None:
        _not_ported("continued training (init_model)")
    if resume_from is not None:
        _not_ported("checkpoint resume (resume_from)", "queue 1, item 14")
    if learning_rates is not None:
        _not_ported("learning-rate schedules (learning_rates)")
    callbacks = set(callbacks) if callbacks else set()
    if any(getattr(cb, "before_iteration", False) for cb in callbacks):
        _not_ported("callbacks that run before an iteration "
                    "(reset_parameter, preemption)")

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

    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if verbose_eval is True:
        callbacks.add(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        callbacks.add(callback_mod.print_evaluation(verbose_eval))
    if evals_result is not None:
        callbacks.add(callback_mod.record_evaluation(evals_result))
    cb_after = sorted(callbacks, key=lambda cb: getattr(cb, "order", 0))

    for i in range(num_boost_round):
        finished = booster.update()
        evaluation_result_list = []
        if valid_sets is not None or booster._gbdt.train_metrics:
            if is_valid_contain_train or booster._gbdt.train_metrics:
                for _, mname, v, bigger in booster.eval_train():
                    evaluation_result_list.append(
                        (train_data_name, mname, v, bigger))
            evaluation_result_list.extend(booster.eval_valid())
        try:
            for cb in cb_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            booster.best_score = collections.defaultdict(dict)
            for name, metric, v, _ in es.best_score or ():
                booster.best_score[name][metric] = v
            break
        if finished:
            break
    # the deferred trees drained before the count (lightgbm_tpu/engine.py:
    # 257-267): a drain may still trim trailing degenerate rounds
    booster._gbdt._sync_model()
    if booster.best_iteration <= 0:
        booster.best_iteration = (booster.num_trees()
                                  // booster.num_model_per_iteration())
    return booster


def cv(*args, **kwargs):
    """Cross-validation is not ported yet."""
    _not_ported("cv")
