"""The port's pointwise objectives, leaf refits and metrics against the JAX
package, on the CPU: the same numpy inputs go through both.

- regression_l1, huber, fair, poisson, quantile, mape, gamma, tweedie,
  xentropy and xentlambda, unweighted and weighted: gradients and hessians
  rtol 1e-6 of each vector's largest magnitude (one ulp of exp() in
  either library), init scores rtol 1e-12 (both f64 on the host), the
  converted output rtol 1e-12, the model-text objective line equal;
- the percentile helpers (copied) equal; `renew_leaf_percentiles`, plain
  and weighted, at alpha 0.5 and 0.9, on leaves of 0, 1, 2 and many rows
  and with rows out of the bag, against lightgbm_tpu.ops.quantile in f32:
  plain rtol 1e-6; weighted within 4 f32 ulps of the total weight over
  the least row weight, times the residuals' 0.1 step (the CDF is one f32
  cumulative sum over all rows, whose rounding each library accrues in
  its own order; the interpolation divides it by a row's weight and
  scales it by the step between two residuals);
- l1, quantile, huber, fair, poisson, mape, gamma, gamma_deviance,
  tweedie, binary_error, cross_entropy, cross_entropy_lambda and
  kullback_leibler, unweighted and weighted: rtol 1e-12 (host numpy in
  both); is_bigger_better and the default metric of every objective;
- 3 rounds of 7-leaf training at 2,000 rows for each objective, the port
  on its fused path (the deferred pipeline; for L1, quantile and MAPE the
  eager path with a fetch and a refit a round) and on its eager path (a
  training metric), against the JAX partition engine's eager path (a
  training metric): equal split features, leaf counts and leaves of every
  row, leaf values rtol 1e-4, raw and converted predictions rtol 1e-4;
  also weighted, bagged and on the label engine for the refitting ones;
- a JAX L1, Poisson or xentropy model loads through
  `interop.booster_from_model_string` and predicts the same raw and
  converted values; the port's model text loads in both packages.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import jax.numpy as jnp
from lightgbm_tpu import config as jconfig
from lightgbm_tpu import metric as jmetric
from lightgbm_tpu import objective as jobjective
from lightgbm_tpu.io import metadata as jmetadata
from lightgbm_tpu.ops import quantile as jquantile
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch import objective as tobjective
from lightgbm_tpu_torch.io import metadata as tmetadata
from lightgbm_tpu_torch.ops import quantile as tquantile
from lightgbm_tpu_torch.utils.log import LightGBMError

# objective -> the label kind it takes
OBJECTIVES = {"regression_l1": "real", "huber": "real", "fair": "real",
              "poisson": "count", "quantile": "real", "mape": "positive",
              "gamma": "positive", "tweedie": "count", "xentropy": "prob",
              "xentlambda": "prob"}
RENEWING = ("regression_l1", "quantile", "mape")


def _data(kind, n=2000, F=8, seed=7):
    """tests/test_torch_train.py's features (a NaN-bearing column, zeros, a
    column of few values) with a label of the objective's kind."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[rng.rand(n) < 0.03, 3] = 0.0
    X[:, 4] = np.round(X[:, 4] * 2)
    s = X[:, 0] + 0.7 * np.sin(2 * X[:, 1]) * X[:, 5] + 0.3 * X[:, 6]
    s = s + 0.5 * rng.randn(n)
    y = {"real": s, "positive": np.exp(0.5 * s),
         "count": rng.poisson(np.exp(0.3 * s)).astype(np.float64),
         "prob": 1.0 / (1.0 + np.exp(-s))}[kind]
    return X, y


def _metadata(mod, y, w):
    meta = mod.Metadata(len(y))
    meta.set_label(y)
    if w is not None:
        meta.set_weights(w)
    return meta


def _weights(n, seed=4):
    return np.random.RandomState(seed).rand(n) + 0.5


# --------------------------------------------------------------------------- #
# objectives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match(objective, weighted):
    _, y = _data(OBJECTIVES[objective])
    w = _weights(len(y)) if weighted else None
    rng = np.random.RandomState(5)
    score = (rng.randn(len(y)) * 0.7).astype(np.float32)
    params = {"objective": objective, "verbose": -1, "alpha": 0.7,
              "fair_c": 1.3, "tweedie_variance_power": 1.4}
    jobj = jobjective.create_objective(objective, jconfig.Config(params))
    tobj = tobjective.create_objective(objective, tconfig.Config(params))
    jobj.init(_metadata(jmetadata, y, w), len(y))
    tobj.init(_metadata(tmetadata, y, w), len(y), "cpu")
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    tg, th = tobj.get_gradients(torch.from_numpy(score))
    for got, want in ((tg, jg), (th, jh)):
        want = np.asarray(want)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(tobj.boost_from_score(0),
                               jobj.boost_from_score(0), rtol=1e-12)
    raw = score.astype(np.float64)
    np.testing.assert_allclose(tobj.convert_output(raw),
                               np.asarray(jobj.convert_output(raw)),
                               rtol=1e-12)
    assert tobj.to_string() == jobj.to_string()
    assert tobj.is_renew_tree_output() is jobj.is_renew_tree_output()
    assert tobj.carry_ok() is False


def test_aliases_reach_the_same_objectives():
    cfg = tconfig.Config({})
    for alias, cls in jobjective._REGISTRY.items():
        assert type(tobjective.create_objective(alias, cfg)).__name__ == \
            cls.__name__, alias
    for name in ("lambdarank", "rank", "xentropy", "cross_entropy",
                 "xentlambda", "cross_entropy_lambda"):
        assert type(tobjective.create_objective(name, cfg)).__name__ == \
            type(jobjective.create_objective(name, jconfig.Config({}))
                 ).__name__
    assert tobjective.create_objective("none", cfg) is None
    mc = tconfig.Config({"num_class": 3})
    for name in ("multiclass", "softmax", "multiclassova", "ova"):
        assert type(tobjective.create_objective(name, mc)).__name__ == \
            type(jobjective.create_objective(
                name, jconfig.Config({"num_class": 3}))).__name__
    with pytest.raises(LightGBMError):
        tobjective.create_objective("no_such_objective", cfg)


@pytest.mark.parametrize("objective,label", [
    ("poisson", [1.0, -0.5, 2.0]), ("gamma", [1.0, -0.5, 2.0]),
    ("xentropy", [0.2, 1.5, 0.0]), ("xentlambda", [-0.1, 0.5, 1.0])])
def test_label_checks_are_fatal(objective, label):
    y = np.asarray(label)
    obj = tobjective.create_objective(objective, tconfig.Config({}))
    with pytest.raises(LightGBMError):
        obj.init(_metadata(tmetadata, y, None), len(y), "cpu")


# --------------------------------------------------------------------------- #
# percentiles and leaf refits
# --------------------------------------------------------------------------- #
def test_percentile_helpers_match():
    rng = np.random.RandomState(8)
    for n in (0, 1, 2, 3, 10, 101):
        d = rng.randn(n)
        w = rng.rand(n) + 0.1
        for a in (0.1, 0.5, 0.9):
            assert tobjective.percentile(d, a) == jobjective.percentile(d, a)
            assert tobjective.weighted_percentile(d, w, a) == \
                jobjective.weighted_percentile(d, w, a)


def _leaf_case(seed=9, n=3000, L=15):
    """Residuals with ties, leaves of 0, 1, 2 and many rows, and rows out
    of the bag (-1)."""
    rng = np.random.RandomState(seed)
    res = np.round(rng.randn(n) * 3, 1).astype(np.float32)
    lids = rng.randint(3, L - 1, n).astype(np.int32)
    lids[rng.rand(n) < 0.1] = -1
    lids[:5] = 0                 # leaf 1 stays empty
    lids[5] = 2                  # one row
    lids[6:8] = L - 1            # two rows
    w = (rng.rand(n) + 0.2).astype(np.float32)
    return res, lids, w, L


@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("weighted", [False, True])
def test_renew_leaf_percentiles_match(alpha, weighted):
    res, lids, w, L = _leaf_case()
    jw = jnp.asarray(w) if weighted else None
    want = np.asarray(jquantile.renew_leaf_percentiles(
        jnp.asarray(res), jnp.asarray(lids), jnp.asarray(alpha, jnp.float32),
        L=L, weights=jw))
    got = tquantile.renew_leaf_percentiles(
        torch.from_numpy(res), torch.from_numpy(lids), alpha, L,
        torch.from_numpy(w) if weighted else None)
    assert got.dtype == torch.float32 and got.shape == (L,)
    atol = (4 * np.finfo(np.float32).eps * w.sum() / w.min() * 0.1
            if weighted else 1e-7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    assert got[1] == 0.0                              # the empty leaf
    assert got[2] == res[5]                           # the one-row leaf
    # against the per-leaf host helpers in f64
    for leaf in range(L):
        rows = np.flatnonzero(lids == leaf)
        if len(rows) < 2:
            continue
        ref = (tobjective.weighted_percentile(res[rows], w[rows], alpha)
               if weighted else tobjective.percentile(res[rows], alpha))
        np.testing.assert_allclose(float(got[leaf]), ref, rtol=1e-5,
                                   atol=max(atol, 1e-6))


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #
METRICS = {"l1": ("regression_l1", "real"), "quantile": ("quantile", "real"),
           "huber": ("huber", "real"), "fair": ("fair", "real"),
           "poisson": ("poisson", "count"), "mape": ("mape", "positive"),
           "gamma": ("gamma", "positive"),
           "gamma_deviance": ("gamma", "positive"),
           "tweedie": ("tweedie", "count"),
           "binary_error": ("binary", "binary"),
           "cross_entropy": ("xentropy", "prob"),
           "cross_entropy_lambda": ("xentlambda", "prob"),
           "kullback_leibler": ("xentropy", "prob")}


@pytest.mark.parametrize("name", sorted(METRICS))
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match(name, weighted):
    objective, kind = METRICS[name]
    if kind == "binary":
        _, y = _data("real", n=1500, seed=5)
        y = (y > 0).astype(np.float64)
    else:
        _, y = _data(kind, n=1500, seed=5)
    w = _weights(len(y), seed=6) if weighted else None
    score = np.random.RandomState(7).randn(len(y)) * 0.5
    cfg = {"objective": objective, "verbose": -1, "alpha": 0.7,
           "fair_c": 1.3, "tweedie_variance_power": 1.4}
    jm = jmetric.create_metric(name, jconfig.Config(cfg))
    tm = tmetric.create_metric(name, tconfig.Config(cfg))
    assert type(tm).__name__ == type(jm).__name__ and tm.name == jm.name
    jm.init(_metadata(jmetadata, y, w), len(y))
    tm.init(_metadata(tmetadata, y, w), len(y))
    jobj = jobjective.create_objective(objective, jconfig.Config(cfg))
    tobj = tobjective.create_objective(objective, tconfig.Config(cfg))
    jobj.init(_metadata(jmetadata, y, w), len(y))
    tobj.init(_metadata(tmetadata, y, w), len(y), "cpu")
    np.testing.assert_allclose(tm.eval(score, tobj), jm.eval(score, jobj),
                               rtol=1e-12)
    np.testing.assert_allclose(tm.eval(score), jm.eval(score), rtol=1e-12)


def test_metric_directions_and_defaults():
    names = list(jmetric._ALIASES) + [
        "ndcg", "map", "ndcg@10", "map@5", "lambdarank",
        "mean_average_precision", "xentropy", "cross_entropy", "xentlambda",
        "cross_entropy_lambda", "kldiv", "kullback_leibler", "multi_logloss",
        "multi_error"]
    for name in names:
        assert tmetric.is_bigger_better(name) is \
            jmetric.is_bigger_better(name), name
    for obj in list(jobjective._REGISTRY) + [
            "lambdarank", "xentropy", "xentlambda", "multiclass", "softmax",
            "multiclassova", "ova", "unknown"]:
        assert tmetric.default_metric_for_objective(obj) == \
            jmetric.default_metric_for_objective(obj), obj
    for name in ("xentropy", "xentlambda", "kldiv", "ndcg", "map",
                 "multi_logloss", "multi_error", "multiclass", "ova"):
        assert type(tmetric.create_metric(name, tconfig.Config({}))
                    ).__name__ == type(jmetric.create_metric(
                        name, jconfig.Config({}))).__name__


# --------------------------------------------------------------------------- #
# training against the JAX partition engine
# --------------------------------------------------------------------------- #
PARAMS = {"num_leaves": 7, "learning_rate": 0.2, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1, "alpha": 0.7,
          "tweedie_variance_power": 1.4}
ROUNDS = 3
# objective -> the extra parameters of each training case
CASES = {"%s-%s" % (o, path): (o, path, {}) for o in OBJECTIVES
         for path in ("fused", "eager")}
CASES.update({
    "regression_l1-weighted": ("regression_l1", "fused", {"weighted": True}),
    "quantile-weighted": ("quantile", "fused", {"weighted": True}),
    "poisson-weighted": ("poisson", "fused", {"weighted": True}),
    "xentlambda-weighted": ("xentlambda", "fused", {"weighted": True}),
    "regression_l1-bagged": ("regression_l1", "fused", {
        "bagging_fraction": 0.8, "bagging_freq": 1, "bagging_seed": 3}),
    "mape-bagged": ("mape", "fused", {
        "bagging_fraction": 0.7, "bagging_freq": 2, "bagging_seed": 4}),
    "regression_l1-label": ("regression_l1", "fused",
                            {"tpu_tree_engine": "label"}),
    "poisson-label": ("poisson", "fused", {"tpu_tree_engine": "label"}),
})


def _train_both(objective, path, extra):
    extra = dict(extra)
    weighted = extra.pop("weighted", False)
    X, y = _data(OBJECTIVES[objective])
    w = _weights(len(y)) if weighted else None
    params = dict(PARAMS, objective=objective, **extra)
    # the JAX side on its eager path (a training metric): its compiled
    # grower serves every objective
    jparams = dict(params, is_provide_training_metric=True)
    jparams.setdefault("tpu_tree_engine", "partition")
    jb = jlgb.train(jparams, jlgb.Dataset(X, y, weight=w),
                    num_boost_round=ROUNDS)
    tparams = dict(params, is_provide_training_metric=path == "eager")
    tb = tlgb.train(tparams, tlgb.Dataset(X, y, weight=w, device="cpu"),
                    num_boost_round=ROUNDS, device="cpu")
    return X, jb, tb


def _assert_models_match(jb, tb, X):
    """Equal split features, leaf counts and leaves of every row; leaf
    values rtol 1e-4 (f32 sums in another order, one ulp of exp())."""
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(tt) == len(jt) == ROUNDS
    for a, b in zip(tt, jt):
        assert a.num_leaves == b.num_leaves > 1
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        np.testing.assert_allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_matches_jax(case):
    objective, path, extra = CASES[case]
    X, jb, tb = _train_both(objective, path, extra)
    _assert_models_match(jb, tb, X)
    g = tb._gbdt
    # without a training metric every fetch is deferred but a refit's,
    # which fetches its tree in its round
    renew = objective in RENEWING
    assert g._tree_fetches == (ROUNDS if renew or path == "eager" else 0)
    assert g._carried_active is not True
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4,
                               atol=1e-6)


def test_refit_leaves_are_percentiles_of_residuals():
    """An L1 tree's leaf values before shrinkage are the medians of its
    rows' residuals against the score before it."""
    X, y = _data("real")
    tb = tlgb.train(dict(PARAMS, objective="regression_l1"),
                    tlgb.Dataset(X, y, device="cpu"), num_boost_round=1,
                    device="cpu")
    tree = tb._gbdt.models[0]
    init = tobjective.percentile(y.astype(np.float32), 0.5)
    leaves = tree.predict_leaf_index(X)
    for leaf in range(tree.num_leaves):
        rows = leaves == leaf
        med = tobjective.percentile(
            (y[rows].astype(np.float32) - np.float32(init)).astype(np.float32),
            0.5)
        np.testing.assert_allclose(tree.leaf_value[leaf] - init,
                                   med * PARAMS["learning_rate"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("objective", ["regression_l1", "poisson",
                                       "xentropy"])
def test_models_carry_across(objective):
    X, jb, tb = _train_both(objective, "fused", {})
    carried = interop.booster_from_model_string(jb.model_to_string(),
                                                device="cpu")
    assert carried._gbdt.objective.name == jb._gbdt.objective.name
    np.testing.assert_allclose(carried.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-12)
    np.testing.assert_allclose(carried.predict(X), jb.predict(X),
                               rtol=1e-12)
    text = tb.model_to_string()
    assert "objective=%s" % jb._gbdt.objective.to_string() in text
    again = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(again.predict(X), tb.predict(X))
    in_jax = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(in_jax.predict(X), tb.predict(X), rtol=1e-12)
