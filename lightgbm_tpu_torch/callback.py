# Copied from lightgbm_tpu/callback.py, lines 1-69 and 150-266 (CallbackEnv,
# EarlyStopException, _format_eval_result, print_evaluation,
# record_evaluation, _resolve_schedule, reset_parameter, _MetricTracker,
# early_stopping); kept in step with it by tests/test_torch_bagging.py.  Its
# telemetry, checkpoint and preemption callbacks are not ported (ROADMAP.md
# queue 1, item 14).
"""Training callbacks.

The public surface (CallbackEnv fields, factory signatures, `order` /
`before_iteration` attributes, EarlyStopException) is shared API with the
reference's python-package/lightgbm/callback.py — bindings and user code
depend on it verbatim.  The implementations are this framework's own.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .utils import log


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


# (dataset_name, metric_name, value, bigger_is_better[, stdv]) tuples ride
# in evaluation_result_list; the namedtuple name and field order are ABI.
CallbackEnv = collections.namedtuple(
    "LightGBMCallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    name, metric, score = value[0], value[1], value[2]
    if len(value) == 5 and show_stdv:
        return "%s's %s: %g + %g" % (name, metric, score, value[4])
    if len(value) in (4, 5):
        return "%s's %s: %g" % (name, metric, score)
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log the evaluation results every `period` iterations."""

    def _callback(env: CallbackEnv) -> None:
        if period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % period:
            return
        log.info("[%d]\t%s", env.iteration + 1,
                 "\t".join(_format_eval_result(v, show_stdv)
                           for v in env.evaluation_result_list))

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: dict) -> Callable:
    """Append every metric value into eval_result[dataset][metric]."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")

    def _callback(env: CallbackEnv) -> None:
        for v in env.evaluation_result_list:
            series = eval_result.setdefault(
                v[0], collections.OrderedDict())
            series.setdefault(v[1], []).append(v[2])

    _callback.order = 20
    return _callback


def _resolve_schedule(key: str, spec, round_idx: int, num_rounds: int):
    """A per-round parameter value from a list (one entry per round) or a
    callable round_idx -> value."""
    if isinstance(spec, list):
        if len(spec) != num_rounds:
            raise ValueError("Length of list %s has to equal to "
                             "'num_boost_round'." % key)
        return spec[round_idx]
    if callable(spec):
        return spec(round_idx)
    raise ValueError("Only list and callable values are supported as a "
                     "mapping from boosting round index to new parameter "
                     "value.")


def reset_parameter(**kwargs) -> Callable:
    """Schedule parameter changes per boosting round (lists or callables
    keyed by parameter name)."""

    def _callback(env: CallbackEnv) -> None:
        round_idx = env.iteration - env.begin_iteration
        num_rounds = env.end_iteration - env.begin_iteration
        updates = {k: _resolve_schedule(k, v, round_idx, num_rounds)
                   for k, v in kwargs.items()}
        if not updates:
            return
        # EVERY scheduled parameter goes through Booster.reset_parameter
        # (-> LGBM_BoosterResetParameter), not just learning_rate: the
        # growth params (lambda_l2, min_data_in_leaf, ...) only act via
        # the booster's split-param refresh, so a bare env.params update
        # would silently schedule nothing
        targets = getattr(env.model, "boosters", None) or [env.model]
        for bst in targets:
            bst.reset_parameter(updates)
        env.params.update(updates)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


@dataclass
class _MetricTracker:
    """Best-so-far state of one (dataset, metric) series."""
    bigger_is_better: bool
    best_score: float = field(default=None)  # type: ignore[assignment]
    best_iter: int = 0
    best_results: Optional[list] = None

    def improved(self, score: float) -> bool:
        if self.best_results is None:
            return True
        if self.bigger_is_better:
            return score > self.best_score
        return score < self.best_score

    def update(self, score: float, iteration: int, results) -> None:
        self.best_score = score
        self.best_iter = iteration
        self.best_results = results


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop when no tracked validation metric improved for
    `stopping_rounds` iterations; raises EarlyStopException carrying the
    best iteration (train() catches it, engine.py)."""
    state: Dict[str, Any] = {"trackers": None, "enabled": True}

    def _start(env: CallbackEnv) -> None:
        dart = any(env.params.get(alias, "") == "dart"
                   for alias in ("boosting", "boosting_type", "boost"))
        state["enabled"] = not dart
        if dart:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            log.info("Training until validation scores don't improve for %d "
                     "rounds.", stopping_rounds)
        state["trackers"] = [_MetricTracker(bigger_is_better=bool(v[3]))
                            for v in env.evaluation_result_list]

    def _finish(tracker: _MetricTracker, stopped_early: bool) -> None:
        if verbose:
            head = ("Early stopping, best iteration is:" if stopped_early
                    else "Did not meet early stopping. Best iteration is:")
            log.info("%s\n[%d]\t%s", head, tracker.best_iter + 1,
                     "\t".join(_format_eval_result(v)
                               for v in tracker.best_results))
        raise EarlyStopException(tracker.best_iter, tracker.best_results)

    def _callback(env: CallbackEnv) -> None:
        if state["trackers"] is None and state["enabled"]:
            _start(env)
        if not state["enabled"]:
            return
        train_name = getattr(env.model, "_train_data_name", "training")
        for tracker, value in zip(state["trackers"],
                                  env.evaluation_result_list):
            if tracker.improved(value[2]):
                tracker.update(value[2], env.iteration,
                               env.evaluation_result_list)
            if value[0] == train_name:
                # training-set metrics never trigger the stop
                continue
            if env.iteration - tracker.best_iter >= stopping_rounds:
                _finish(tracker, stopped_early=True)
            if env.iteration == env.end_iteration - 1:
                _finish(tracker, stopped_early=False)
            if first_metric_only:
                break

    _callback.order = 30
    return _callback
