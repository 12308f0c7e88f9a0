"""The port's training against the JAX package's partition engine, on the
CPU (its Pallas kernels in interpret mode): binary and L2, f32 and
quantized gradients, on the carried arena, and weighted binary quantized on
the non-carried path.  Each case trains one JAX booster and one port booster
of 3 rounds, stepping both with update() so the carried arena can be read
after every tree; every assertion reuses them.

- both packages choose the same path (`_carried_active`, `_quantized`);
- the carried row order (the JAX arena's rowid planes at the live root slot,
  the port's `rid` there) is equal after every tree;
- the trees are equal: split features, leaf counts, every training row's
  leaf, thresholds (in quantized mode always on these inputs: its
  histograms are exact integers; in f32 mode except at exact ties, where
  the gains agree to rtol 1e-5), leaf values rtol 1e-4;
- the training score: JAX's carried score adds a cumsum of leaf-value
  differences in f32 (gbdt.py:968-976), which rounds, where the port writes
  each row's leaf value; the two agree within 1e-6 of the score's scale;
- truncation: the carried geometry leaves a bump region of 3 align(n) + 13
  tiles, which 160-leaf trees on 800 rows outgrow; both packages stop the
  same trees at the same leaf count, warn, and carry the same row order.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import partition_pallas as pp

ROUNDS = 3
PARAMS = {"num_leaves": 15, "learning_rate": 0.2, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}
CASES = {
    "binary_f32": ("binary", False, False),
    "binary_quantized": ("binary", True, False),
    "l2_f32": ("regression", False, False),
    "l2_quantized": ("regression", True, False),
    "weighted_binary_quantized": ("binary", True, True),
}
CARRIED = sorted(k for k, v in CASES.items() if not v[2])


def _data(task, n=800, F=8, seed=7):
    """tests/test_torch_train.py's generator: a NaN-bearing column, zeros,
    a column of few values."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[rng.rand(n) < 0.03, 3] = 0.0
    X[:, 4] = np.round(X[:, 4] * 2)
    score = X[:, 0] + 0.7 * np.sin(2 * X[:, 1]) * X[:, 5] + 0.3 * X[:, 6]
    score = score + 0.5 * rng.randn(n)
    y = (score > 0).astype(np.float64) if task == "binary" else score
    return X, y


def _jax_carried_rid(g, n):
    Fp = pp.feature_channels(g._bins_t.shape[0])
    s = g._carry_slots[g._carry_parity]
    a = np.asarray(g._arena[Fp + 6:Fp + 9, s:s + n], np.float32)
    a = a.astype(np.int64)
    return a[0] * 65536 + a[1] * 256 + a[2]


def _port_carried_rid(g, n):
    s = g._carry_slots[g._carry_parity]
    return g.arena.rid[s:s + n].numpy().astype(np.int64)


@pytest.fixture(scope="module")
def trained():
    out = {}
    for name, (task, quantized, weighted) in CASES.items():
        X, y = _data(task)
        w = (np.random.RandomState(3).rand(len(y)) + 0.5 if weighted
             else None)
        params = dict(PARAMS, objective=task, tpu_quantized_grad=quantized)
        jb = jlgb.Booster(params=dict(params, tpu_tree_engine="partition"),
                          train_set=jlgb.Dataset(X, y, weight=w))
        tb = tlgb.Booster(params=params,
                          train_set=tlgb.Dataset(X, y, weight=w, device="cpu"),
                          device="cpu")
        rids = []
        for _ in range(ROUNDS):
            jb.update()
            tb.update()
            if tb._gbdt._carried_active:
                rids.append((_jax_carried_rid(jb._gbdt, len(y)),
                             _port_carried_rid(tb._gbdt, len(y))))
        pj = jb.predict(X, raw_score=True)      # drains JAX's pending trees
        out[name] = dict(X=X, jb=jb, tb=tb, rids=rids, pj=pj,
                         pt=tb.predict(X, raw_score=True),
                         quantized=quantized, carried=not weighted)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_paths_agree(trained, name):
    c = trained[name]
    jg, tg = c["jb"]._gbdt, c["tb"]._gbdt
    assert bool(getattr(jg, "_carried_active", False)) is tg._carried_active
    assert bool(jg._quantized) is tg._quantized
    assert tg._carried_active is c["carried"]
    assert tg._quantized is c["quantized"]


@pytest.mark.parametrize("name", CARRIED)
def test_carried_row_order_after_every_tree(trained, name):
    rids = trained[name]["rids"]
    assert len(rids) == ROUNDS
    for it, (want, got) in enumerate(rids):
        np.testing.assert_array_equal(got, want, err_msg="tree %d" % it)
        np.testing.assert_array_equal(np.sort(got), np.arange(len(got)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_trees_match(trained, name):
    c = trained[name]
    X = c["X"]
    jt, tt = c["jb"]._gbdt.models, c["tb"]._gbdt.models
    assert len(tt) == len(jt) == ROUNDS
    for a, b in zip(tt, jt):
        assert a.num_leaves == b.num_leaves > 1
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        same = a.threshold_in_bin[:k] == b.threshold_in_bin[:k]
        if c["quantized"]:
            assert same.all()
        np.testing.assert_array_equal(a.threshold[:k][same],
                                      b.threshold[:k][same])
        np.testing.assert_allclose(a.split_gain[:k][~same],
                                   b.split_gain[:k][~same], rtol=1e-5)
        np.testing.assert_allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                                   rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scores_match(trained, name):
    c = trained[name]
    np.testing.assert_allclose(c["pt"], c["pj"], rtol=1e-4, atol=1e-6)
    ts = c["tb"]._gbdt.score.numpy()
    js = np.asarray(c["jb"]._gbdt.train_state.score)[0]
    np.testing.assert_allclose(ts, js, rtol=0,
                               atol=1e-6 * float(np.abs(js).max()))


def test_carried_truncation_matches_jax():
    """At the default tpu_arena_factor=6 and n=800 the carried bump region
    holds 120 allocation units of 256 columns, and 160-leaf trees outgrow
    it.  L2 on labels in steps of 1/8 without boost_from_average makes the
    first tree's histogram sums exact in f32, so its near-ties cannot part
    the packages; the second tree is held as test_trees_match holds f32
    trees.  Both packages stop both trees at the same leaf, warn, and leave
    the same carried row order."""
    X, y = _data("regression")
    y = np.clip(np.round(y * 8), -40, 40) / 8
    params = dict(PARAMS, objective="regression", num_leaves=160,
                  min_data_in_leaf=2, boost_from_average=False)
    jb = jlgb.Booster(params=dict(params, tpu_tree_engine="partition"),
                      train_set=jlgb.Dataset(X, y))
    tb = tlgb.Booster(params=params,
                      train_set=tlgb.Dataset(X, y, device="cpu"), device="cpu")
    for _ in range(2):
        jb.update()
        tb.update()
        np.testing.assert_array_equal(_port_carried_rid(tb._gbdt, len(y)),
                                      _jax_carried_rid(jb._gbdt, len(y)))
    for b in (jb, tb):
        b.predict(X[:1])                    # drains the pending trees
    jg, tg = jb._gbdt, tb._gbdt
    assert jg._carried_active and tg._carried_active
    assert jg._truncation_warned and tg._truncation_warned
    for it, (a, b) in enumerate(zip(tg.models, jg.models)):
        assert 1 < a.num_leaves == b.num_leaves < 160
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        same = a.threshold_in_bin[:k] == b.threshold_in_bin[:k]
        assert same.all() or it > 0
        np.testing.assert_allclose(a.split_gain[:k][~same],
                                   b.split_gain[:k][~same], rtol=1e-5)
