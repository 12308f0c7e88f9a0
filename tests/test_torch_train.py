"""The port's data layer, objectives, metrics and whole training slice
against the JAX package, on the CPU: the same numpy inputs go through both.

- bin boundaries and the binned matrix equal bit for bit;
- binary and L2 gradients rtol 1e-6;
- metrics rtol 1e-12 (both are host numpy);
- 3 rounds of lightgbm_tpu_torch.train(device="cpu") against
  lightgbm_tpu.train with the label engine: equal split features and
  thresholds per tree, leaf values and raw predictions rtol 1e-4;
- a JAX model carried into the port predicts the same raw scores;
- the modules the port copies from the JAX package stay in step with them.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import config as jconfig
from lightgbm_tpu import metric as jmetric
from lightgbm_tpu import objective as jobjective
from lightgbm_tpu.io import dataset as jdataset
from lightgbm_tpu.io import metadata as jmetadata
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch import objective as tobjective
from lightgbm_tpu_torch.io import dataset as tdataset
from lightgbm_tpu_torch.io import metadata as tmetadata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed, n=3000, F=8, task="binary"):
    """Dense features with a NaN-bearing column and a few zeros; a label
    from a nonlinear score."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[rng.rand(n) < 0.03, 3] = 0.0
    X[:, 4] = np.round(X[:, 4] * 2)          # few distinct values
    score = X[:, 0] + 0.7 * np.sin(2 * X[:, 1]) * X[:, 5] + 0.3 * X[:, 6]
    score = score + 0.5 * rng.randn(n)
    y = (score > 0).astype(np.float64) if task == "binary" else score
    return X, y


PARAMS = {"num_leaves": 15, "learning_rate": 0.2, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}


# --------------------------------------------------------------------------- #
# data layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("params", [
    {"max_bin": 255},
    {"max_bin": 63, "min_data_in_bin": 10, "use_missing": False},
    {"max_bin": 15, "zero_as_missing": True, "bin_construct_sample_cnt": 1000},
])
def test_bins_match_bit_for_bit(params):
    X, y = _data(0)
    p = dict(params, verbose=-1, enable_bundle=False)
    jds = jdataset.BinnedDataset.construct(X, jconfig.Config(p))
    tds = tdataset.BinnedDataset.construct(X, tconfig.Config(p))
    assert tds.used_feature_map == jds.used_feature_map
    assert len(tds.bin_mappers) == len(jds.bin_mappers)
    for tm, jm in zip(tds.bin_mappers, jds.bin_mappers):
        assert (tm.num_bin, tm.missing_type, tm.default_bin) == \
            (jm.num_bin, jm.missing_type, jm.default_bin)
        np.testing.assert_array_equal(np.asarray(tm.bin_upper_bound),
                                      np.asarray(jm.bin_upper_bound))
    np.testing.assert_array_equal(tds.bins, np.asarray(jds.bins))
    # the device tensor is the same matrix
    np.testing.assert_array_equal(tds.device_bins("cpu").numpy(), tds.bins)


def test_validation_set_reuses_bin_mappers():
    X, _ = _data(1)
    Xv, _ = _data(2, n=500)
    cfg = {"max_bin": 63, "verbose": -1}
    jref = jdataset.BinnedDataset.construct(X, jconfig.Config(cfg))
    tref = tdataset.BinnedDataset.construct(X, tconfig.Config(cfg))
    jv = jdataset.BinnedDataset.construct(Xv, jconfig.Config(cfg),
                                          reference=jref)
    tv = tdataset.BinnedDataset.construct(Xv, tconfig.Config(cfg),
                                          reference=tref)
    np.testing.assert_array_equal(tv.bins, np.asarray(jv.bins))


# --------------------------------------------------------------------------- #
# objectives and metrics
# --------------------------------------------------------------------------- #
def _metadata(mod, y, w):
    meta = mod.Metadata(len(y))
    meta.set_label(y)
    if w is not None:
        meta.set_weights(w)
    return meta


@pytest.mark.parametrize("objective,extra", [
    ("binary", {}), ("binary", {"is_unbalance": True}),
    ("binary", {"sigmoid": 1.7, "scale_pos_weight": 2.0}),
    ("regression", {}), ("regression", {"reg_sqrt": True})])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match(objective, extra, weighted):
    task = "binary" if objective == "binary" else "regression"
    _, y = _data(3, n=2000, task=task)
    rng = np.random.RandomState(4)
    w = rng.rand(len(y)) + 0.5 if weighted else None
    score = rng.randn(len(y)).astype(np.float32)
    params = dict(extra, objective=objective, verbose=-1)
    jobj = jobjective.create_objective(objective, jconfig.Config(params))
    tobj = tobjective.create_objective(objective, tconfig.Config(params))
    jobj.init(_metadata(jmetadata, y, w), len(y))
    tobj.init(_metadata(tmetadata, y, w), len(y), "cpu")
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    tg, th = tobj.get_gradients(torch.from_numpy(score))
    # rtol 1e-6 against each vector's largest magnitude: the hessian's
    # sigmoid - |response| cancels, so one ulp of exp() in either library
    # shows larger relative to a small hessian
    for got, want in ((tg, jg), (th, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(tobj.boost_from_score(0),
                               jobj.boost_from_score(0), rtol=1e-12)
    np.testing.assert_allclose(
        tobj.convert_output(score.astype(np.float64)),
        np.asarray(jobj.convert_output(score.astype(np.float64))),
        rtol=1e-12)
    assert tobj.to_string() == jobj.to_string()


@pytest.mark.parametrize("name", ["binary_logloss", "auc", "l2", "rmse"])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match(name, weighted):
    _, y = _data(5, n=1500)
    rng = np.random.RandomState(6)
    w = rng.rand(len(y)) + 0.5 if weighted else None
    score = np.round(rng.randn(len(y)), 1)          # ties for the AUC
    cfg = {"objective": "binary", "verbose": -1}
    jm = jmetric.create_metric(name, jconfig.Config(cfg))
    tm = tmetric.create_metric(name, tconfig.Config(cfg))
    jm.init(_metadata(jmetadata, y, w), len(y))
    tm.init(_metadata(tmetadata, y, w), len(y))
    jobj = jobjective.create_objective("binary", jconfig.Config(cfg))
    tobj = tobjective.create_objective("binary", tconfig.Config(cfg))
    conv = name == "binary_logloss"
    np.testing.assert_allclose(
        tm.eval(score, tobj if conv else None),
        jm.eval(score, jobj if conv else None), rtol=1e-12)


# --------------------------------------------------------------------------- #
# the whole slice
# --------------------------------------------------------------------------- #
def _train_both(task, rounds=3, **extra):
    X, y = _data(7, task=task)
    params = dict(PARAMS, objective=task, **extra)
    jb = jlgb.train(dict(params, tpu_tree_engine="label"),
                    jlgb.Dataset(X, y), num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=rounds, device="cpu")
    return X, jb, tb


def _assert_models_match(jb, tb, X):
    """Equal split features; every training row in the same leaf; equal
    thresholds except at exact ties.  Two thresholds with no training row
    of the node between them split it alike, so their gains are equal in
    exact arithmetic and the pick rests on the last bit of each engine's
    prefix sums (the port's follows the Pallas scan's order, the label
    engine's XLA's cumsum).  Such a node keeps its gain within rtol 1e-5."""
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert a.num_leaves == b.num_leaves
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        same = a.threshold_in_bin[:k] == b.threshold_in_bin[:k]
        np.testing.assert_array_equal(a.threshold[:k][same],
                                      b.threshold[:k][same])
        np.testing.assert_allclose(a.split_gain[:k][~same],
                                   b.split_gain[:k][~same], rtol=1e-5)
        np.testing.assert_allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])


@pytest.mark.parametrize("task,extra", [
    ("binary", {}),
    ("regression", {"lambda_l2": 1.0, "max_depth": 4}),
    ("binary", {"feature_fraction": 0.6, "min_data_in_leaf": 40}),
])
def test_training_matches_jax(task, extra):
    X, jb, tb = _train_both(task, **extra)
    _assert_models_match(jb, tb, X)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4,
                               atol=1e-6)


def test_model_text_round_trip_and_interop():
    X, jb, tb = _train_both("binary")
    # a JAX model carried into the port predicts the same raw scores
    carried = interop.booster_from_model_string(jb.model_to_string(),
                                                device="cpu")
    np.testing.assert_allclose(carried.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-12)
    # the port's own model text loads in both packages
    text = tb.model_to_string()
    again = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(again.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True))
    in_jax = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(in_jax.predict(X, raw_score=True),
                               tb.predict(X, raw_score=True), rtol=1e-12)


def test_tree_arrays_from_numpy():
    rng = np.random.RandomState(8)
    n, F, B = 2000, 5, 32
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    tree, _ = jgrow.grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.zeros(n, jnp.int32), jnp.ones(F, bool), jnp.full(F, B, jnp.int32),
        jnp.zeros(F, jnp.int32), jnp.zeros(F, jnp.int32),
        jgrow.SplitParams(min_data_in_leaf=10), max_leaves=7, max_bin=B,
        hist_impl="scatter")
    host = jgrow.fetch_tree_arrays(tree)
    got = interop.tree_arrays_from_numpy(host._asdict(), device="cpu")
    for name in host._fields:
        a, b = getattr(got, name), np.asarray(getattr(host, name))
        assert isinstance(a, torch.Tensor) and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype))


# --------------------------------------------------------------------------- #
# copied modules stay in step with their sources
# --------------------------------------------------------------------------- #
def _body(path):
    with open(os.path.join(REPO, path)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("path", ["utils/log.py", "io/bin_mapper.py",
                                  "io/metadata.py", "models/tree.py"])
def test_copied_modules_are_verbatim(path):
    port = _body("lightgbm_tpu_torch/" + path)
    assert port[0] == "# Copied from lightgbm_tpu/%s; kept in step with it " \
                      "by tests/test_torch_train.py." % path
    assert port[1:] == _body("lightgbm_tpu/" + path)


def test_efb_copy_is_the_grouping_decision():
    port = _body("lightgbm_tpu_torch/io/efb.py")
    src = _body("lightgbm_tpu/io/efb.py")
    assert port[1:] == src[:len(port) - 1]


def test_config_schema_matches():
    assert tconfig.ALIAS_TABLE == jconfig.ALIAS_TABLE
    tcfg, jcfg = tconfig.Config({}), jconfig.Config({})
    assert vars(tcfg).keys() == vars(jcfg).keys()
    params = {"num_leaves": 63, "eta": 0.05, "min_child_samples": 7,
              "max_bin": 127, "objective": "binary", "tpu_tree_engine":
              "partition", "monotone_constraints": "1,0,-1"}
    assert vars(tconfig.Config(params)) == vars(jconfig.Config(params))
