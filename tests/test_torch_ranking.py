"""The port's ranking slice against the JAX package, on the CPU: query
metadata, lambdarank gradients, NDCG and MAP, and lambdarank training.

- `QueryBuckets` equal to the JAX package's (row indices and query ids);
- lambdarank gradients and hessians (ops/ranking.DeviceLambdarank, f32)
  against the JAX package's `DeviceLambdarank` and against the numpy
  oracle `get_gradients_host`, on queries of 1 to 70 documents (buckets of
  8 to 128 slots), all-negative queries, tied scores, with and without
  weights: within 1e-5 of each vector's largest magnitude (the [chunk, S,
  S] pair sums are f32 here, reassociated as each library reduces; the
  JAX package computes them in f64 under the tests' x64 and the oracle in
  f64); the port's oracle equal to JAX's (rtol 1e-12);
- the stable descending sort ties -0.0 with 0.0 and keeps slot order;
- NDCG (f32 on the score's device) against JAX's device NDCG and its
  per-query host oracle, at several eval_at lists, weighted, with empty
  and all-negative queries: rtol 1e-6; a tensor score and a numpy score
  alike; MAP (host numpy in both): rtol 1e-12;
- `Dataset(group=)`, `set_group` and `get_group` as in JAX: equal query
  boundaries and query weights;
- 3 rounds of 15-leaf lambdarank at 300 queries of 20 documents, the port
  fused (no metric) and eager (a training metric), unweighted and
  weighted, against the JAX partition engine's eager path: equal split
  features, leaf counts and leaves of every row, leaf values within 1e-4
  of the tree's largest |leaf value| (the gradients' error is relative to
  their largest magnitude, so a small leaf's relative error is larger),
  predictions rtol 1e-4 (atol 1e-6);
- a validation set with eval_at [1, 3, 10] and early stopping: evals_result
  holds one `ndcg` value per eval_at position a round, as JAX's does,
  within 1e-6 of JAX's, and the same best iteration; the default metric
  of lambdarank is ndcg;
- a JAX lambdarank model loads through `interop.booster_from_model_string`
  and predicts the same values; the port's model text loads in JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as jlgb
from lightgbm_tpu import config as jconfig
from lightgbm_tpu import metric as jmetric
from lightgbm_tpu import objective as jobjective
from lightgbm_tpu.io import metadata as jmetadata
from lightgbm_tpu.ops import ranking as jranking
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch import objective as tobjective
from lightgbm_tpu_torch.io import metadata as tmetadata
from lightgbm_tpu_torch.ops import ranking as tranking
from lightgbm_tpu_torch.utils.log import LightGBMError

# grades by a query's top positions (bench.py:214), as fractions of 120
GRADES = ((2, 4), (6, 3), (15, 2), (40, 1))


def rank_data(sizes, F=10, seed=11):
    """bench.py's MSLR-shaped generator (bench.py:197-222) over queries of
    the given sizes: a sparse linear utility, graded 4..0 by each query's
    ranking of it at bench's top-k cutoffs scaled to the query's size."""
    sizes = np.asarray(sizes, np.int64)
    rng = np.random.RandomState(seed)
    n = int(sizes.sum())
    X = rng.randn(n, F)
    w = np.zeros(F)
    w[:5] = rng.randn(5)
    util = X @ w + 0.3 * rng.randn(n)
    y = np.zeros(n)
    start = 0
    for sz in sizes:
        order = np.argsort(-util[start:start + sz])
        prev = 0
        for cut, grade in GRADES:
            c = max(prev, int(round(cut * sz / 120)))
            y[start + order[prev:c]] = grade
            prev = c
        start += sz
    return X, y, sizes


# queries across buckets of 8 to 128 slots, singletons, and two
# all-negative queries (their labels zeroed)
MIXED = [1, 3, 8, 9, 16, 17, 33, 70, 1, 5, 40, 12, 64, 65, 2, 7]


def _mixed(seed=11):
    X, y, g = rank_data(MIXED * 3, seed=seed)
    b = np.concatenate([[0], np.cumsum(g)])
    for q in (5, 20):
        y[b[q]:b[q + 1]] = 0.0
    return X, y, g


def _metadata(mod, y, g, w=None):
    meta = mod.Metadata(len(y))
    meta.set_label(y)
    if w is not None:
        meta.set_weights(w)
    meta.set_query(g)
    return meta


def _weights(n, seed=4):
    return np.random.RandomState(seed).rand(n) + 0.5


# --------------------------------------------------------------------------- #
# buckets and gradients
# --------------------------------------------------------------------------- #
def test_query_buckets_match():
    _, y, g = _mixed()
    qb = np.concatenate([[0], np.cumsum(g)])
    jb = jranking.QueryBuckets(qb, len(y))
    tb = tranking.QueryBuckets(qb, len(y))
    assert len(tb.buckets) == len(jb.buckets) == 5
    for (ti, tq), (ji, jq) in zip(tb.buckets, jb.buckets):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tq, jq)
    for Q, S in ((1, 8), (300, 128), (18_900, 128), (5, 1024)):
        assert tranking._chunk(Q, S) == jranking._chunk(Q, S)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("scores", ["random", "tied"])
def test_lambdarank_gradients_match(weighted, scores):
    _, y, g = _mixed()
    w = _weights(len(y)) if weighted else None
    rng = np.random.RandomState(5)
    score = rng.randn(len(y)).astype(np.float32)
    if scores == "tied":
        score = np.round(score * 2) / 2          # many ties, zeros of both signs
        score[::7] = -0.0
    params = {"objective": "lambdarank", "verbose": -1}
    jobj = jobjective.create_objective("lambdarank", jconfig.Config(params))
    tobj = tobjective.create_objective("lambdarank", tconfig.Config(params))
    jobj.init(_metadata(jmetadata, y, g, w), len(y))
    tobj.init(_metadata(tmetadata, y, g, w), len(y), "cpu")
    tg, th = tobj.get_gradients(torch.from_numpy(score))
    assert tg.dtype == th.dtype == torch.float32
    jg, jh = (np.asarray(a) for a in jobj.get_gradients(jnp.asarray(score)))
    hg, hh = jobj.get_gradients_host(score)
    for got, want in ((tg, jg), (th, jh), (tg, hg), (th, hh)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # the port's numpy oracle is the JAX package's
    pg, ph = tobj.get_gradients_host(score)
    np.testing.assert_allclose(pg, hg, rtol=1e-12)
    np.testing.assert_allclose(ph, hh, rtol=1e-12)
    # singleton and all-negative queries get no gradient
    b = np.concatenate([[0], np.cumsum(g)])
    for q in (0, 8, 5, 20):
        assert not tg[b[q]:b[q + 1]].any() and not th[b[q]:b[q + 1]].any()
    assert tobj.boost_from_score(0) == 0.0
    assert tobj.to_string() == jobj.to_string() == "lambdarank"


def test_descending_ties_zero_signs():
    s = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0, 1.0, 5.0]])
    real = torch.tensor([[True] * 7 + [False]])
    got = tranking._descending(s, real)
    key = np.where(real.numpy(), s.numpy(), -np.inf)
    want = np.argsort(-key, axis=1, kind="stable")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0], [2, 6, 0, 1, 3, 4, 5, 7])


def test_lambdarank_needs_queries():
    X, y, _ = _mixed()
    with pytest.raises(LightGBMError, match="query"):
        tlgb.train({"objective": "lambdarank", "verbose": -1},
                   tlgb.Dataset(X, y, device="cpu"), num_boost_round=1,
                   device="cpu")


# --------------------------------------------------------------------------- #
# NDCG and MAP
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("eval_at", [[1, 2, 3, 4, 5], [10], [3, 1000]])
@pytest.mark.parametrize("weighted", [False, True])
def test_ndcg_matches(eval_at, weighted):
    _, y, g = _mixed()
    g = np.insert(g, 4, 0)                       # an empty query
    w = _weights(len(y)) if weighted else None
    score = np.round(np.random.RandomState(6).randn(len(y)), 1)
    cfg = {"objective": "lambdarank", "eval_at": eval_at, "verbose": -1}
    jm = jmetric.create_metric("ndcg", jconfig.Config(cfg))
    tm = tmetric.create_metric("ndcg", tconfig.Config(cfg))
    jm.init(_metadata(jmetadata, y, g, w), len(y))
    tm.init(_metadata(tmetadata, y, g, w), len(y))
    got = tm.eval(score)
    assert len(got) == len(eval_at)
    np.testing.assert_allclose(got, jm.eval(score), rtol=1e-6)
    np.testing.assert_allclose(got, jm.eval_host(score), rtol=1e-6)
    np.testing.assert_allclose(tm.eval_host(score), jm.eval_host(score),
                               rtol=1e-12)
    # a device score (a CPU tensor here) gives the same values
    assert tm.eval(torch.from_numpy(score.astype(np.float32))) == got


@pytest.mark.parametrize("weighted", [False, True])
def test_map_matches(weighted):
    _, y, g = _mixed()
    w = _weights(len(y)) if weighted else None
    score = np.round(np.random.RandomState(7).randn(len(y)), 1)
    cfg = {"eval_at": [1, 3, 10], "verbose": -1}
    jm = jmetric.create_metric("map", jconfig.Config(cfg))
    tm = tmetric.create_metric("map", tconfig.Config(cfg))
    jm.init(_metadata(jmetadata, y, g, w), len(y))
    tm.init(_metadata(tmetadata, y, g, w), len(y))
    np.testing.assert_allclose(tm.eval(score), jm.eval(score), rtol=1e-12)


# --------------------------------------------------------------------------- #
# the Dataset's queries
# --------------------------------------------------------------------------- #
def test_dataset_group_as_in_jax():
    X, y, g = _mixed()
    w = _weights(len(y))
    td = tlgb.Dataset(X, y, weight=w, group=g, device="cpu")
    jd = jlgb.Dataset(X, y, weight=w, group=g)
    np.testing.assert_array_equal(td.get_group(), g)
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    tm, jm = td._binned.metadata, jd._binned.metadata
    np.testing.assert_array_equal(tm.query_boundaries, jm.query_boundaries)
    np.testing.assert_array_equal(tm.query_weights, jm.query_weights)
    # set_group on a constructed dataset, and on a lazy one
    g2 = np.full(len(y) // 4, 4)
    g2[-1] += len(y) - g2.sum()
    td.set_group(g2)
    jd.set_group(g2)
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    lazy = tlgb.Dataset(X, y, device="cpu").set_group(g)
    np.testing.assert_array_equal(lazy.get_group(), g)
    assert tlgb.Dataset(X, y, device="cpu").get_group() is None
    # a validation set binned on the training mappers keeps its own queries
    Xv, yv, gv = rank_data([20] * 5, seed=12)
    tv = tlgb.Dataset(Xv, yv, group=gv, reference=td, device="cpu")
    np.testing.assert_array_equal(tv.get_group(), gv)
    with pytest.raises(LightGBMError):
        tlgb.Dataset(X, y, group=[3, 4], device="cpu").construct()


# --------------------------------------------------------------------------- #
# training against the JAX partition engine
# --------------------------------------------------------------------------- #
PARAMS = {"objective": "lambdarank", "num_leaves": 15, "learning_rate": 0.1,
          "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1}
ROUNDS = 3


def _train_both(path, weighted):
    X, y, g = rank_data([20] * 300)
    w = _weights(len(y)) if weighted else None
    jb = jlgb.train(dict(PARAMS, tpu_tree_engine="partition",
                         is_provide_training_metric=True),
                    jlgb.Dataset(X, y, weight=w, group=g),
                    num_boost_round=ROUNDS)
    tb = tlgb.train(dict(PARAMS, is_provide_training_metric=path == "eager"),
                    tlgb.Dataset(X, y, weight=w, group=g, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    return X, jb, tb


@pytest.mark.parametrize("path", ["fused", "eager"])
@pytest.mark.parametrize("weighted", [False, True])
def test_lambdarank_training_matches_jax(path, weighted):
    X, jb, tb = _train_both(path, weighted)
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(tt) == len(jt) == ROUNDS
    for a, b in zip(tt, jt):
        assert a.num_leaves == b.num_leaves > 1
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        np.testing.assert_allclose(
            a.leaf_value[:k + 1], b.leaf_value[:k + 1], rtol=0,
            atol=1e-4 * np.abs(b.leaf_value[:k + 1]).max())
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
    g = tb._gbdt
    # fused: the pristine root (no carried arena), every fetch deferred
    assert g._carried_active is (None if path == "eager" else False)
    assert g._tree_fetches == (ROUNDS if path == "eager" else 0)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4,
                               atol=1e-6)


def test_lambdarank_valid_set_and_early_stopping():
    X, y, g = rank_data([20] * 300)
    Xv, yv, gv = rank_data([20] * 60, seed=12)
    params = dict(PARAMS, eval_at=[1, 3, 10])
    out = {}
    for lib, kw, extra in ((jlgb, {}, {"tpu_tree_engine": "partition"}),
                           (tlgb, {"device": "cpu"}, {})):
        ds = lib.Dataset(X, y, group=g, **kw)
        dv = lib.Dataset(Xv, yv, group=gv, reference=ds, **kw)
        evals = {}
        bst = lib.train(dict(params, **extra), ds, num_boost_round=8,
                        valid_sets=[dv], valid_names=["v"], evals_result=evals,
                        early_stopping_rounds=2, verbose_eval=False, **kw)
        out[lib.__name__] = (bst, evals)
    (tb, te), (jb, je) = out["lightgbm_tpu_torch"], out["lightgbm_tpu"]
    assert list(te["v"]) == list(je["v"]) == ["ndcg"]
    assert len(te["v"]["ndcg"]) == len(je["v"]["ndcg"]) == \
        3 * tb.current_iteration
    np.testing.assert_allclose(te["v"]["ndcg"], je["v"]["ndcg"], rtol=0,
                               atol=1e-6)
    assert tb.best_iteration == jb.best_iteration
    # the last value at 10 is the NDCG@10 of the port's own prediction
    m = tmetric.create_metric("ndcg", tconfig.Config(params))
    m.init(_metadata(tmetadata, yv, gv), len(yv))
    np.testing.assert_allclose(te["v"]["ndcg"][-1],
                               m.eval(tb.predict(Xv, raw_score=True))[-1],
                               rtol=0, atol=1e-6)
    # no metric given: lambdarank's default is ndcg at eval_at's default
    evals = {}
    ds = tlgb.Dataset(X, y, group=g, device="cpu")
    tlgb.train(PARAMS, ds, num_boost_round=2, device="cpu",
               valid_sets=[tlgb.Dataset(Xv, yv, group=gv, reference=ds,
                                        device="cpu")],
               evals_result=evals, verbose_eval=False)
    assert list(evals["valid_0"]) == ["ndcg"]
    assert len(evals["valid_0"]["ndcg"]) == 2 * 5


def test_lambdarank_model_carries_across():
    X, jb, tb = _train_both("fused", False)
    carried = interop.booster_from_model_string(jb.model_to_string(),
                                                device="cpu")
    assert carried._gbdt.objective.name == "lambdarank"
    np.testing.assert_allclose(carried.predict(X), jb.predict(X), rtol=1e-12)
    np.testing.assert_allclose(carried.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-12)
    text = tb.model_to_string()
    assert "objective=lambdarank" in text
    np.testing.assert_allclose(jlgb.Booster(model_str=text).predict(X),
                               tb.predict(X), rtol=1e-12)
