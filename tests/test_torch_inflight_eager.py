"""The eager path's deferred rounds (a bag, or the label engine, with no
validation set or training metric) against the JAX package's, with both
packages' `_DRAIN_EVERY` 2 here (3 in tests/test_torch_inflight_eager_drain3.py): bagged f32 and quantized on the partition
engine, the label engine unbagged and bagged, 5 rounds: no tree fetched in
its round, the drains where the cadence puts them, the model and training
score as JAX's (each engine held to the standard its own tests hold it
to).  The helpers here serve those files and
tests/test_torch_inflight_eager_stops.py; the model helpers are
tests/test_torch_inflight.py's.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu_torch.models import gbdt as tgbdt

from test_torch_inflight import _assert_same_model

# --------------------------------------------------------------------------- #
# the eager path's deferred rounds: a bag, or the label engine
# --------------------------------------------------------------------------- #
BAG = {"bagging_fraction": 0.8, "bagging_freq": 1}
EAGER_CASES = {
    "bagged_f32": dict(BAG),
    "bagged_quantized": dict(BAG, tpu_quantized_grad=True),
    "label_f32": dict(tpu_tree_engine="label"),
    "label_bagged_f32": dict(BAG, tpu_tree_engine="label"),
}


def _eager_inputs(name, drain, monkeypatch, **extra):
    """The inputs the port's tests already hold to JAX on each engine:
    tests/test_torch_bagging.py's on the partition engine (seed 2: no
    exact tie between thresholds with an out-of-bag row between them),
    tests/test_torch_label.py's on the label engine (on the former, two
    features' gains in the first tree tie to 5e-6 and f32 reassociation
    picks either); both packages' _DRAIN_EVERY set to `drain`."""
    import test_torch_bagging
    import test_torch_label
    monkeypatch.setattr(jgbdt, "_DRAIN_EVERY", drain)
    monkeypatch.setattr(tgbdt, "_DRAIN_EVERY", drain)
    if EAGER_CASES[name].get("tpu_tree_engine") == "label":
        X, y = test_torch_label._data(2)
        base = test_torch_label.PARAMS
    else:
        X, y = test_torch_bagging._data("binary", seed=2)
        base = dict(test_torch_bagging.PARAMS, tpu_tree_engine="partition")
    params = dict(base, objective="binary", **EAGER_CASES[name], **extra)
    return X, y, params


def _assert_engine_model(jb, tb, X):
    """The model by the standard of the tests that hold each engine to
    JAX: the model text on the partition engine (`_assert_same_model`);
    tests/test_torch_label.py's `_assert_trees_match` on the label engine,
    whose f32 gains and leaf values agree to rtol 1e-4."""
    if tb._gbdt._use_partition_engine:
        _assert_same_model(jb, tb, X)
        return
    import test_torch_label
    assert tb.num_trees() == jb.num_trees()
    assert tb.current_iteration == jb.current_iteration
    jm, tm = jb._gbdt.models, tb._gbdt.models
    if [t.num_leaves for t in tm] == [1]:
        # a degenerate first round: the prior as a constant tree
        assert jm[0].num_leaves == 1
        assert tm[0].leaf_value[0] == jm[0].leaf_value[0] != 0.0
        return
    test_torch_label._assert_trees_match(jm, tm, X, [None] * len(tm))


def _train_eager_both(X, y, params, rounds):
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=rounds, device="cpu")
    return jb, tb


def _assert_scores_close(tb, jb):
    """The training scores by the standard of the tests that hold each
    engine to JAX: within 1e-6 of their scale on the partition engine
    (tests/test_torch_bagging.py), rtol 1e-4 and atol 1e-6 on the label
    engine, whose f32 leaf values agree to rtol 1e-4
    (tests/test_torch_label.py)."""
    ts = tb._gbdt.score.numpy()
    js = np.asarray(jb._gbdt.train_state.score)[0]
    if tb._gbdt._use_partition_engine:
        np.testing.assert_allclose(ts, js, rtol=0,
                                   atol=1e-6 * float(np.abs(js).max()))
    else:
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-6)



@pytest.mark.parametrize("drain", [2])
@pytest.mark.parametrize("name", sorted(EAGER_CASES))
def test_eager_deferred_run_matches_jax(name, drain, monkeypatch):
    """Five rounds of a bagged or label-engine run (no validation set, no
    training metric): no tree is fetched in its round; the drains come at
    rounds 3 and 5 and at the end of train (_DRAIN_EVERY 2), or at round
    4 and the end (3); the model, tree count, iteration and training score
    equal the JAX package's."""
    X, y, params = _eager_inputs(name, drain, monkeypatch)
    jb, tb = _train_eager_both(X, y, params, 5)
    g = tb._gbdt
    assert not g._carried_active and not jb._gbdt._carried_active
    partition = params["tpu_tree_engine"] == "partition"
    assert g._use_partition_engine is partition
    assert bool(jb._gbdt._use_partition_engine) is partition
    assert g._tree_fetches == 0 and g._drains == {2: 3, 3: 2}[drain]
    assert not g._inflight and None not in g.models
    _assert_engine_model(jb, tb, X)
    _assert_scores_close(tb, jb)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)
