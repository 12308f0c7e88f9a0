"""The fused paths' deferred tree pipeline against the JAX package's, on the
CPU (its Pallas kernels in interpret mode, `tpu_tree_engine=partition`).

Both packages defer each fused round's tree and drain the pending trees
every `_DRAIN_EVERY` rounds and wherever the model is read.  Here both
modules' `_DRAIN_EVERY` is 2 (monkeypatched; the packages keep 48), so a
few rounds of a small model cross several drains:

- binary on the carried arena and, weighted, on the pristine root, f32 and
  quantized, 5 rounds: the same model text (token by token: names and
  integers equal, reals within rtol 1e-4 and atol 1e-6, as the trees'
  leaf values agree in tests/test_torch_carried.py; `tree_sizes`, the
  texts' lengths, follow the reals' digits and are left out; thresholds
  and their missing-value directions as tests/test_torch_carried.py holds
  thresholds: equal but at exact ties, where two choices split the node's
  rows alike and the gains agree to rtol 1e-5, every training row in the
  same leaf), tree count and
  current_iteration; the port drains at rounds 3 and 5 and at the end of
  training, and fetches no tree in its round;
- runs that stop on a degenerate round (a large min_gain_to_split): found
  by the first drain before any tree was drained, by a later drain, and by
  the drain at the end of `train`; and a degenerate first round, which
  keeps the prior as a constant tree: the same text, tree count and
  current_iteration as JAX, and the next round refuses to train;
- predict, model_to_string, num_trees, current_iteration and
  feature_importance read in the middle of training drain first and agree
  with the same read of a booster trained to that round by `train`, and
  with the JAX booster's read at that round; training on after the read
  ends where an unread run ends;
- the eager path's deferred rounds (a bag, or the label engine, with no
  validation set or training metric), with _DRAIN_EVERY 2 and 3: bagged
  f32 and quantized on the partition engine, the label engine unbagged
  and bagged, 5 rounds: no tree fetched in its round, the drains where
  the cadence puts them, the model and training score as JAX's (each
  engine held to the standard its own tests hold it to); and a bagged run
  stopping on a degenerate round, at a later round or the first: the same
  rollback as JAX's and the training score rebuilt from the model.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu_torch.models import gbdt as tgbdt

from test_torch_carried import PARAMS, _data

DRAIN = 2
CASES = {
    "carried_f32": (False, False),
    "carried_quantized": (True, False),
    "pristine_f32": (False, True),
    "pristine_quantized": (True, True),
}


@pytest.fixture
def drain_every(monkeypatch):
    monkeypatch.setattr(jgbdt, "_DRAIN_EVERY", DRAIN)
    monkeypatch.setattr(tgbdt, "_DRAIN_EVERY", DRAIN)


def _inputs(quantized, weighted, **extra):
    X, y = _data("binary")
    w = np.random.RandomState(3).rand(len(y)) + 0.5 if weighted else None
    params = dict(PARAMS, objective="binary", tpu_quantized_grad=quantized,
                  **extra)
    return X, y, w, params


def _boosters(X, y, w, params):
    jb = jlgb.Booster(params=dict(params, tpu_tree_engine="partition"),
                      train_set=jlgb.Dataset(X, y, weight=w))
    tb = tlgb.Booster(params=params,
                      train_set=tlgb.Dataset(X, y, weight=w, device="cpu"),
                      device="cpu")
    return jb, tb


def _train_both(X, y, w, params, rounds):
    jb = jlgb.train(dict(params, tpu_tree_engine="partition"),
                    jlgb.Dataset(X, y, weight=w), num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, y, weight=w, device="cpu"),
                    num_boost_round=rounds, device="cpu")
    return jb, tb


def assert_texts_match(got: str, want: str) -> None:
    """Model texts line by line: the same keys and tokens, names and
    integers equal, reals within rtol 1e-4 and atol 1e-6; `tree_sizes`
    only by count, thresholds and decision types by count
    (`_assert_same_model` holds them)."""
    gl, wl = got.split("\n"), want.split("\n")
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        ka, _, va = a.partition("=")
        kb, _, vb = b.partition("=")
        assert ka == kb
        ta, tb = va.split(" "), vb.split(" ")
        assert len(ta) == len(tb), ka
        if ka in ("tree_sizes", "threshold", "decision_type"):
            continue
        for x, y in zip(ta, tb):
            if x != y:
                assert abs(float(x) - float(y)) <= 1e-6 + 1e-4 * abs(
                    float(y)), (ka, x, y)


def _assert_same_model(jb, tb, X):
    assert tb.num_trees() == jb.num_trees()
    assert tb.current_iteration == jb.current_iteration
    assert_texts_match(tb.model_to_string(), jb.model_to_string())
    for a, b in zip(tb._gbdt.models, jb._gbdt.models):
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        same = ((a.threshold_in_bin[:k] == b.threshold_in_bin[:k])
                & (a.decision_type[:k] == b.decision_type[:k]))
        np.testing.assert_array_equal(a.threshold[:k][same],
                                      b.threshold[:k][same])
        np.testing.assert_allclose(a.split_gain[:k][~same],
                                   b.split_gain[:k][~same], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_run_matches_jax(name, drain_every):
    quantized, weighted = CASES[name]
    X, y, w, params = _inputs(quantized, weighted)
    jb, tb = _train_both(X, y, w, params, 5)
    g = tb._gbdt
    assert bool(g._carried_active) is not weighted
    assert g._quantized is quantized
    # rounds 3 and 5 found DRAIN trees pending; train's end drained round 5
    assert g._drains == 3 and g._tree_fetches == 0
    assert not g._inflight and None not in g.models
    _assert_same_model(jb, tb, X)
    assert tb.num_trees() == 5
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)


# min_gain_to_split -> the round (from 0) whose tree cannot split, on
# every fused path of these inputs
STOPS = {
    "first_drain": (250.0, 1, 10),     # found by round 2's drain
    "later_drain": (130.0, 3, 10),     # round 3, found by round 4's drain
    "train_end": (130.0, 3, 4),        # round 3, pending when train ends
    "first_round": (1e6, 0, 10),       # the prior as a constant tree
}


@pytest.mark.parametrize("stop", sorted(STOPS))
@pytest.mark.parametrize("name", ["carried_f32", "pristine_quantized"])
def test_degenerate_stop_matches_jax(name, stop, drain_every):
    min_gain, stopped_at, rounds = STOPS[stop]
    quantized, weighted = CASES[name]
    X, y, w, params = _inputs(quantized, weighted,
                              min_gain_to_split=min_gain)
    jb, tb = _train_both(X, y, w, params, rounds)
    g = tb._gbdt
    assert g._deferred_stopped and jb._gbdt._deferred_stopped
    assert g.iter == jb._gbdt.iter == stopped_at
    _assert_same_model(jb, tb, X)
    leaves = [m.num_leaves for m in g.models]
    if stopped_at == 0:
        assert leaves == [1]
        prior = g.models[0].leaf_value[0]
        assert prior == jb._gbdt.models[0].leaf_value[0] != 0.0
    else:
        assert len(leaves) == stopped_at and min(leaves) > 1
    # the stop holds: a further round trains nothing
    assert tb.update() is True
    assert tb.num_trees() == jb.num_trees()


READS = {
    "predict": lambda b, X: b.predict(X, raw_score=True),
    "model_to_string": lambda b, X: b.model_to_string(),
    "num_trees": lambda b, X: b.num_trees(),
    "current_iteration": lambda b, X: b.current_iteration,
    "feature_importance": lambda b, X: b._gbdt.feature_importance(),
}


@pytest.mark.parametrize("read", sorted(READS))
def test_read_in_training_drains_first(read):
    """Three rounds of the carried quantized path with the packages' own
    drain cadence (no drain before round 48), then one read."""
    X, y, w, params = _inputs(True, False)
    jb, tb = _boosters(X, y, w, params)
    for _ in range(3):
        jb.update()
        tb.update()
    g = tb._gbdt
    assert len(g._inflight) == 3 and g.models == [None] * 3
    got = READS[read](tb, X)
    assert not g._inflight and None not in g.models and g._drains == 1
    ref = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                     num_boost_round=3, device="cpu")
    want = READS[read](ref, X)
    jax_read = READS[read](jb, X)
    if read == "model_to_string":
        assert got == want
        assert_texts_match(got, jax_read)
        _assert_same_model(jb, tb, X)
    elif read == "predict":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, jax_read, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_read)
    # training on after the read ends where a run without it ends
    for _ in range(2):
        tb.update()
    five = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                      num_boost_round=5, device="cpu")
    assert tb.model_to_string() == five.model_to_string()


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


@pytest.mark.parametrize("drain", [2, 3])
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


@pytest.mark.parametrize("min_gain", [100.0, 1e6])
@pytest.mark.parametrize("name", ["bagged_f32", "label_bagged_f32"])
def test_eager_degenerate_stop_matches_jax(name, min_gain, monkeypatch):
    """A bagged run that stops on a degenerate round (min_gain_to_split
    100: a later round; 1e6: the first, which keeps the prior as a
    constant tree), found by a drain with _DRAIN_EVERY 2: the rollback
    leaves the same model, tree count and iteration as JAX's, the
    training score rebuilt from that model as JAX rebuilds it, and the
    next round refuses to train."""
    X, y, params = _eager_inputs(name, 2, monkeypatch,
                                 min_gain_to_split=min_gain)
    jb, tb = _train_eager_both(X, y, params, 10)
    g = tb._gbdt
    assert g._deferred_stopped and jb._gbdt._deferred_stopped
    assert g.iter == jb._gbdt.iter
    assert (g.iter == 0) is (min_gain == 1e6)
    assert g._tree_fetches == 0
    _assert_engine_model(jb, tb, X)
    _assert_scores_close(tb, jb)
    assert tb.update() is True
    assert tb.num_trees() == jb.num_trees()
