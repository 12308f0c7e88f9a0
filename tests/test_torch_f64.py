"""`tpu_double_precision`: the port's label engine in f64 against the JAX
package's, on the CPU (the conftest's x64 mode, which JAX's f64 path
needs).

The port threads its dtype as JAX does (lightgbm_tpu/models/gbdt.py:155
and on): f64 scores and gradients, K7's f64 payload (its plain version
here), the plain scan in f64 (JAX's XLA route: its Pallas scan serves f32
only), f64 split rows and tree tables, the trees' f64 leaf values and the
walks' f64 adds (KP2's f64 score).  Cases: binary, a bagged run with
feature_fraction, and 3-class softmax, each 4 rounds with the deferred
pipeline's drains (`_DRAIN_EVERY` 2 in both packages):

- the trees are identical: split features, thresholds, counts, every
  row's leaf (the data have no tie at f64);
- split gains and leaf values agree to rtol 1e-9 (both sum the same f64
  values, in another order);
- the training score and predict's raw score agree within 1e-10 of the
  score's scale, and the score is f64;
- the partition engine stays f32 as in JAX: `tpu_tree_engine=partition`
  warns and takes the label engine, and `tpu_quantized_grad` warns and is
  dropped.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu_torch.models import gbdt as tgbdt

from test_torch_label import PARAMS, _data

CASES = {
    "binary": dict(objective="binary"),
    "bagged": dict(objective="binary", bagging_fraction=0.8, bagging_freq=1,
                   feature_fraction=0.7),
    "multiclass": dict(objective="multiclass", num_class=3),
}


def _inputs(name):
    X, y = _data(2)
    if name == "multiclass":
        rng = np.random.RandomState(5)
        s = X[:, 0] + 0.5 * np.sin(2 * X[:, 1]) + 0.3 * rng.randn(len(X))
        y = np.digitize(s, [-0.5, 0.5]).astype(np.float64)
    return X, y


def _assert_trees_equal(jm, tm, X):
    assert len(tm) == len(jm) > 0
    for a, b in zip(tm, jm):
        assert a.num_leaves == b.num_leaves > 1
        k = a.num_leaves - 1
        for name in ("split_feature", "threshold_in_bin", "decision_type",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, name)[:k],
                                          getattr(b, name)[:k], name)
        np.testing.assert_array_equal(a.threshold[:k], b.threshold[:k])
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        np.testing.assert_allclose(a.split_gain[:k], b.split_gain[:k],
                                   rtol=1e-9)
        np.testing.assert_allclose(a.leaf_value[:k + 1],
                                   b.leaf_value[:k + 1], rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_label_engine_matches_jax(name, monkeypatch):
    monkeypatch.setattr(jgbdt, "_DRAIN_EVERY", 2)
    monkeypatch.setattr(tgbdt, "_DRAIN_EVERY", 2)
    X, y = _inputs(name)
    params = dict(PARAMS, tpu_double_precision=True, **CASES[name])
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=4)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=4, device="cpu")
    g, jg = tb._gbdt, jb._gbdt
    assert not g._use_partition_engine and not jg._use_partition_engine
    assert g.dtype == g.scores.dtype == g._shrink_dev.dtype
    assert str(g.dtype) == "torch.float64"
    assert g._drains == 2 and g._tree_fetches == 0
    _assert_trees_equal(jg.models, g.models, X)
    ts = g.scores.numpy()
    js = np.asarray(jg.train_state.score)
    assert js.dtype == np.float64
    np.testing.assert_allclose(ts, js, rtol=0,
                               atol=1e-10 * float(np.abs(js).max()))
    raw_t = tb.predict(X, raw_score=True)
    raw_j = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(raw_t, raw_j, rtol=0,
                               atol=1e-10 * float(np.abs(raw_j).max()))


def test_partition_engine_stays_f32():
    from lightgbm_tpu_torch.utils import log as tlog
    X, y = _data(2, n=800)
    params = dict(PARAMS, objective="binary", tpu_double_precision=True,
                  tpu_tree_engine="partition", tpu_quantized_grad=True)
    lines = []
    tlog.set_callback(lines.append)
    try:
        tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                        num_boost_round=2, device="cpu")
    finally:
        tlog.set_callback(None)
    g = tb._gbdt
    assert not g._use_partition_engine and not g._quantized
    assert any("tpu_tree_engine=partition not applicable" in s
               for s in lines)
    assert any("tpu_quantized_grad requires the partition engine" in s
               for s in lines)
    assert str(g.score.dtype) == "torch.float64"
