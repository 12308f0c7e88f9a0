"""The scikit-learn wrappers and plotting in the port against the JAX
package, on the CPU.

- With scikit-learn: LGBMClassifier (three classes named by strings, a
  class weight), LGBMRegressor with an eval set and early stopping, and
  LGBMRanker, 2 rounds of 15-leaf trees on 900 rows on the label engine
  (`max_bin` 63): `get_params` equal to the JAX package's but for the
  port's `device`, predictions within tests/test_torch_bagging.py's rtol
  1e-4, atol 1e-6, classes, best iteration and split importances equal; a
  custom objective and eval metric (sklearn's calling convention) too.
  The seeds hold no exact tie between two thresholds with no training
  row between them (ROADMAP.md queue 3).
  tests/test_torch_sklearn_fallback.py holds the wrappers without
  scikit-learn, and plotting.
"""
import numpy as np

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_goss import data

KW = dict(num_leaves=15, n_estimators=2, learning_rate=0.3, max_bin=63,
          tpu_tree_engine="label")
N = 900


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _pair(name, **kw):
    j = getattr(jlgb, name)(**KW, **kw)
    t = getattr(tlgb, name)(**KW, device="cpu", **kw)
    want = dict(j.get_params(), device="cpu")
    assert t.get_params() == want
    return j, t


def test_classifier_matches_jax():
    X, y = data("multiclass", n=N, seed=2)
    labels = np.array(["no", "yes", "maybe"])[y.astype(int)]
    j, t = _pair("LGBMClassifier", class_weight={"yes": 2.0})
    j.fit(X, labels)
    t.fit(X, labels)
    assert list(t.classes_) == list(j.classes_) and t.n_classes_ == j.n_classes_
    _close(t.predict_proba(X), j.predict_proba(X))
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)
    assert t.booster_.num_trees() == 2 * 3


def test_regressor_with_eval_set_matches_jax():
    X, y = data("regression", n=N, seed=5)
    j, t = _pair("LGBMRegressor")
    fit = dict(eval_set=[(X[::3], y[::3])], early_stopping_rounds=2,
               verbose=False)
    j.fit(X, y, **fit)
    t.fit(X, y, **fit)
    assert t.best_iteration_ == j.best_iteration_
    _close(t.predict(X), j.predict(X))
    for metric, want in j.evals_result_["valid_0"].items():
        np.testing.assert_allclose(t.evals_result_["valid_0"][metric], want,
                                   rtol=0, atol=1e-6)


def test_ranker_and_custom_objective_match_jax():
    X, y = data("regression", n=N, seed=5)
    rel = np.digitize(y, [-1.0, 0.0, 1.0]).astype(np.float64)
    group = np.full(30, 30)
    j, t = _pair("LGBMRanker")
    j.fit(X, rel, group=group)
    t.fit(X, rel, group=group)
    _close(t.predict(X), j.predict(X))

    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_pred)

    def mae(y_true, y_pred):
        return "mae", float(np.mean(np.abs(y_true - y_pred))), False
    j, t = _pair("LGBMRegressor", objective=l2)
    for m in (j, t):
        m.fit(X, y, eval_set=[(X[::3], y[::3])], eval_metric=mae,
              verbose=False)
    _close(t.predict(X), j.predict(X))
    np.testing.assert_allclose(t.evals_result_["valid_0"]["mae"],
                               j.evals_result_["valid_0"]["mae"], rtol=0,
                               atol=1e-6)
