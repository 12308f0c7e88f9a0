"""Cross-validation in the port against the JAX package, on the CPU.

- `_make_folds`: equal to the JAX package's index for index, stratified
  (scikit-learn's StratifiedKFold), shuffled or not, by query group,
  plain, and from a splitter object or a list of folds;
- `cv`: 3 folds of 1,500 binary rows (7 leaves of at least 40 rows, 3
  rounds) with `auc` and a custom eval function, on the label engine
  (the fold boosters' rounds are `train`'s): the result dict's keys
  equal and every mean and
  standard deviation within 1e-6 of the JAX package's (f32 scores); each
  fold's training set a `subset` of the binned set, its bins the full
  set's rows; early stopping cuts both at the same round.  A fold's
  held-out rows are no training rows, so where a node's training rows
  leave bins empty between two thresholds of equal gain they may land in
  other leaves in the two packages (ROADMAP.md queue 3); the features here
  take 5 values each, a bin each, and every node holds rows of each.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.engine import _make_folds as jax_folds
from lightgbm_tpu_torch.engine import _make_folds

PARAMS = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.3,
          "max_bin": 63, "min_data_in_leaf": 40, "verbose": -1,
          "metric": "auc"}


def levels(n=1500, seed=3):
    """8 features of 5 equally likely levels; a noisy linear label."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 5, size=(n, 8)).astype(np.float64)
    score = X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * (X[:, 3] > 2) - 1.0
    return X, (score + rng.randn(n) > 0).astype(np.float64)


def _splitter():
    from sklearn.model_selection import KFold
    return KFold(n_splits=4, shuffle=True, random_state=2)


FOLDS = {
    "stratified_shuffled": dict(stratified=True, shuffle=True, seed=3),
    "stratified": dict(stratified=True, shuffle=False, seed=0),
    "plain_shuffled": dict(stratified=False, shuffle=True, seed=5),
    "plain": dict(stratified=False, shuffle=False, seed=0),
    "group": dict(group=True, stratified=True, shuffle=True, seed=7),
    "group_unshuffled": dict(group=True, stratified=False, shuffle=False,
                             seed=0),
    "splitter": dict(folds=_splitter, stratified=True, shuffle=True, seed=0),
    "list": dict(folds=lambda: [(np.arange(10, 100), np.arange(10)),
                                (np.arange(90), np.arange(90, 100))],
                 stratified=True, shuffle=True, seed=0),
}


@pytest.mark.parametrize("case", sorted(FOLDS))
def test_make_folds_match_jax(case):
    kw = dict(FOLDS[case])
    n = 100
    label = (np.random.RandomState(1).rand(n) < 0.3).astype(np.float64)
    group = np.array([7, 13, 10, 20, 5, 9, 11, 25]) if kw.pop(
        "group", False) else None
    make = kw.pop("folds", None)
    args = (5, n, label, group, kw["stratified"], kw["shuffle"], kw["seed"],
            {})
    want = jax_folds(make() if make else None, *args)
    got = _make_folds(make() if make else None, *args)
    assert len(got) == len(want)
    for (a_tr, a_te), (b_tr, b_te) in zip(got, want):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)


def _feval(preds, ds):
    y = ds.get_label()
    return ("my_error", float(np.mean((preds > 0) != (y > 0.5))), False)


def test_cv_matches_jax():
    X, y = levels()
    params = dict(PARAMS, tpu_tree_engine="label")
    want = jlgb.cv(params, jlgb.Dataset(X, y), num_boost_round=3, nfold=3,
                   feval=_feval, seed=4)
    got = tlgb.cv(params, tlgb.Dataset(X, y, device="cpu"),
                  num_boost_round=3, nfold=3, feval=_feval, seed=4,
                  device="cpu")
    assert sorted(got) == sorted(want) == ["auc-mean", "auc-stdv",
                                           "my_error-mean", "my_error-stdv"]
    for key, vals in want.items():
        assert len(got[key]) == len(vals) == 3
        np.testing.assert_allclose(got[key], vals, rtol=0, atol=1e-6,
                                   err_msg=key)


def test_cv_folds_are_binned_subsets_and_stop_early():
    """A fold's training set is a subset of the constructed set, cut from
    its binned rows; early stopping on a metric that stops improving cuts
    the port's rounds where the JAX package cuts its own."""
    X, y = levels()
    y = np.where(np.random.RandomState(0).rand(len(y)) < 0.4, 1 - y, y)
    ds = tlgb.Dataset(X, y, device="cpu")
    seen = []

    def keep(tr, te, params):
        seen.append((tr, te))
        return tr, te, params
    params = dict(PARAMS, tpu_tree_engine="label", learning_rate=0.8)
    got = tlgb.cv(params, ds, num_boost_round=8, nfold=3, seed=4,
                  fpreproc=keep, early_stopping_rounds=1, device="cpu")
    want = jlgb.cv(params, jlgb.Dataset(X, y), num_boost_round=8, nfold=3,
                   seed=4, early_stopping_rounds=1)
    assert len(got["auc-mean"]) == len(want["auc-mean"]) < 8
    np.testing.assert_allclose(got["auc-mean"], want["auc-mean"], rtol=0,
                               atol=1e-6)
    bins = ds._binned.bins
    for tr, te in seen:
        assert tr.reference is ds and tr.used_indices is not None
        np.testing.assert_array_equal(tr._binned.bins, bins[tr.used_indices])
        assert len(tr.used_indices) + len(te.used_indices) == len(y)
