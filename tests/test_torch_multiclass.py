"""The port's multiclass objectives, metrics, training, model text and
prediction early stop against the JAX package, on the CPU: the same numpy
inputs go through both (the JAX side with `tpu_tree_engine=partition`, its
Pallas kernels in interpret mode, as its own tests run it).

- softmax and one-vs-all gradients and hessians of one [k, n] score,
  unweighted and weighted and with a class that has no rows: within 2e-6;
  init scores and `class_need_train` of every class, the converted output
  (rtol 1e-12) and the model-text objective line equal;
- multi_logloss and multi_error over class-major [k*n] scores with tied
  scores: rtol 1e-6;
- 3 classes, 7 leaves, 2 rounds of training at 600 rows (`CASES`; each
  JAX run compiles for about 12 s, so the cases are shared out over this
  file, tests/test_torch_multiclass_paths.py and
  tests/test_torch_multiclass_drains.py, 70-80 s each): softmax and
  OVA on the fused pristine path here, every tree with the same split
  features, leaf counts and leaf of every row, leaf values rtol 1e-5, raw
  predictions within 5e-6 of their scale, probabilities within 5e-6 (a
  softmax row sums to 1 within 1e-12), the training score within 1e-5;
- a class with no rows (the eager path, its prior a constant tree);
- model text both ways: a JAX multiclass model through
  `interop.booster_from_model_string` predicts what JAX predicts within
  5e-6 of the scale, and the port's text loads in the JAX package;
- prediction early stop with k = 5 (the interop fixture mc50): the host
  walk, the device path (KP1's plain version) and both plain walks of KP1
  equal the JAX host loop bit for bit at freq below k, equal to k and not
  a multiple of it.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as jlgb
from lightgbm_tpu import config as jconfig
from lightgbm_tpu import metric as jmetric
from lightgbm_tpu import objective as jobjective
from lightgbm_tpu.io import metadata as jmetadata
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import config as tconfig
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch import objective as tobjective
from lightgbm_tpu_torch.io import metadata as tmetadata
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.ops import predict_kernel as tpk

from test_torch_inflight import assert_texts_match

K = 3
ROUNDS = 2
PARAMS = {"num_class": K, "num_leaves": 7, "learning_rate": 0.2,
          "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1}
INTEROP = os.path.join(os.path.dirname(__file__), "fixtures", "interop")
PRED_ATOL = 5e-6


def _data(n=600, F=6, k=K, seed=7, empty_class=None):
    """Rows with a NaN-bearing column, exact zeros and a column of few
    values; labels the argmax of k noisy linear scores (a class left out
    with empty_class)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[rng.rand(n) < 0.03, 3] = 0.0
    X[:, 4] = np.round(X[:, 4] * 2)
    s = np.nan_to_num(X[:, :k]) + 0.4 * np.sin(2 * X[:, [5]]) \
        + 0.5 * rng.randn(n, k)
    if empty_class is not None:
        s[:, empty_class] = -np.inf
    return X, np.argmax(s, axis=1).astype(np.float64)


def _weights(n, seed=4):
    return np.random.RandomState(seed).rand(n) + 0.5


def _metadata(mod, y, w):
    meta = mod.Metadata(len(y))
    meta.set_label(y)
    if w is not None:
        meta.set_weights(w)
    return meta


# --------------------------------------------------------------------------- #
# objectives and metrics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("case", ["plain", "weighted", "empty_class"])
def test_gradients_match(objective, case):
    _, y = _data(empty_class=1 if case == "empty_class" else None)
    w = _weights(len(y)) if case == "weighted" else None
    score = (np.random.RandomState(5).randn(K, len(y)) * 0.8).astype(
        np.float32)
    params = {"objective": objective, "num_class": K, "verbose": -1}
    jobj = jobjective.create_objective(objective, jconfig.Config(params))
    tobj = tobjective.create_objective(objective, tconfig.Config(params))
    jobj.init(_metadata(jmetadata, y, w), len(y))
    tobj.init(_metadata(tmetadata, y, w), len(y), "cpu")
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    tg, th = tobj.get_gradients(torch.from_numpy(score))
    for got, want in ((tg, jg), (th, jh)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (K, len(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)
    for kk in range(K):
        np.testing.assert_allclose(tobj.boost_from_score(kk),
                                   jobj.boost_from_score(kk), rtol=1e-12)
        assert tobj.class_need_train(kk) == jobj.class_need_train(kk)
    assert tobj.class_need_train(1) is (case != "empty_class")
    raw = score.T.astype(np.float64)
    np.testing.assert_allclose(tobj.convert_output_multi(raw),
                               np.asarray(jobj.convert_output_multi(raw)),
                               rtol=1e-12)
    assert tobj.num_model_per_iteration == jobj.num_model_per_iteration == K
    assert tobj.to_string() == jobj.to_string()
    assert tobj.carry_ok() is False


def test_objective_aliases_and_label_check():
    cfg = tconfig.Config({"num_class": K})
    for alias in ("multiclass", "softmax", "multiclassova", "multiclass_ova",
                  "ova", "ovr"):
        assert type(tobjective.create_objective(alias, cfg)).__name__ == \
            type(jobjective.create_objective(
                alias, jconfig.Config({"num_class": K}))).__name__
    obj = tobjective.create_objective("multiclass", cfg)
    with pytest.raises(Exception, match="Label must be in"):
        obj.init(_metadata(tmetadata, np.array([0.0, 3.0]), None), 2, "cpu")
    with pytest.raises(Exception, match="greater than 1"):
        tobjective.create_objective("multiclass", tconfig.Config({}))


@pytest.mark.parametrize("metric", ["multi_logloss", "multi_error"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_metrics_match(metric, weighted, objective):
    _, y = _data()
    w = _weights(len(y)) if weighted else None
    rng = np.random.RandomState(9)
    score = np.round(rng.randn(K, len(y)), 1)        # ties between classes
    score[:, :50] = 0.25                              # every class tied
    params = {"objective": objective, "num_class": K, "verbose": -1}
    jm = jmetric.create_metric(metric, jconfig.Config(params))
    tm = tmetric.create_metric(metric, tconfig.Config(params))
    jobj = jobjective.create_objective(objective, jconfig.Config(params))
    tobj = tobjective.create_objective(objective, tconfig.Config(params))
    jm.init(_metadata(jmetadata, y, w), len(y))
    tm.init(_metadata(tmetadata, y, w), len(y))
    jobj.init(_metadata(jmetadata, y, w), len(y))
    tobj.init(_metadata(tmetadata, y, w), len(y), "cpu")
    flat = score.reshape(-1)
    np.testing.assert_allclose(tm.eval(flat, tobj), jm.eval(flat, jobj),
                               rtol=1e-6)
    assert tm.name == jm.name
    assert tmetric.is_bigger_better(metric) is jmetric.is_bigger_better(
        metric) is False


# --------------------------------------------------------------------------- #
# training against the JAX partition engine
# --------------------------------------------------------------------------- #
# case -> (objective, the port's path, extra parameters)
CASES = {
    "softmax-fused": ("multiclass", "fused", {}),
    "softmax-fused-quantized": ("multiclass", "fused",
                                {"tpu_quantized_grad": True}),
    "ova-fused": ("multiclassova", "fused", {}),
    "ova-fused-quantized": ("multiclassova", "fused",
                            {"tpu_quantized_grad": True}),
    "softmax-valid": ("multiclass", "valid", {}),
    "softmax-bagged": ("multiclass", "fused", {
        "bagging_fraction": 0.7, "bagging_freq": 1, "bagging_seed": 3}),
    "softmax-feature-fraction": ("multiclass", "fused",
                                 {"feature_fraction": 0.6}),
    "softmax-label-init-score": ("multiclass", "fused", {
        "tpu_tree_engine": "label", "init_score": True}),
}
# the cases of this file; the others run in tests/test_torch_multiclass_
# paths.py and _drains.py, so that no one file holds every JAX run
MAIN_CASES = ("softmax-fused", "ova-fused")
_TRAINED = {}


def _init_score(y):
    return np.random.RandomState(6).randn(K * len(y)) * 0.3


def _train_both(objective, path, extra, data=None, rounds=ROUNDS):
    extra = dict(extra)
    X, y = _data() if data is None else data
    init = _init_score(y) if extra.pop("init_score", False) else None
    Xv, yv = _data(200, seed=8)
    params = dict(PARAMS, objective=objective, **extra)
    jparams = dict(params)
    jparams.setdefault("tpu_tree_engine", "partition")
    jds = jlgb.Dataset(X, y, init_score=init)
    tds = tlgb.Dataset(X, y, init_score=init, device="cpu")
    jkw, tkw = {}, {}
    jev, tev = {}, {}
    if path == "valid":
        params["metric"] = jparams["metric"] = ["multi_logloss",
                                                "multi_error"]
        jkw = dict(valid_sets=[jlgb.Dataset(Xv, yv, reference=jds)],
                   evals_result=jev, verbose_eval=False)
        tkw = dict(valid_sets=[tlgb.Dataset(Xv, yv, reference=tds,
                                            device="cpu")],
                   evals_result=tev, verbose_eval=False)
    jb = jlgb.train(jparams, jds, num_boost_round=rounds, **jkw)
    tb = tlgb.train(params, tds, num_boost_round=rounds, device="cpu", **tkw)
    return X, jb, tb, (jev, tev)


def _assert_models_match(jb, tb, X, n_trees=ROUNDS * K):
    """Equal split features, leaf counts and leaves of every row, leaf
    values rtol 1e-5."""
    jt, tt = jb._gbdt.models, tb._gbdt.models
    assert len(tt) == len(jt) == n_trees
    for a, b in zip(tt, jt):
        assert a.num_leaves == b.num_leaves
        n = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:n], b.split_feature[:n])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        np.testing.assert_allclose(a.leaf_value[:n + 1], b.leaf_value[:n + 1],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(a.leaf_count[:n + 1],
                                      b.leaf_count[:n + 1])


def _assert_predictions_match(jb, tb, X):
    want = jb.predict(X, raw_score=True)
    got = tb.predict(X, raw_score=True)
    assert got.shape == want.shape == (len(X), K)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PRED_ATOL * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(got, tb.predict(X, raw_score=True,
                                                  device=False))
    prob = tb.predict(X)
    np.testing.assert_allclose(prob, jb.predict(X), rtol=0, atol=PRED_ATOL)
    if tb._gbdt.objective.name == "multiclass":
        np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0, atol=1e-12)


def trained_case(case):
    """(X, JAX booster, port booster, (JAX evals, port evals)) of a case of
    CASES, trained once a process."""
    if case not in _TRAINED:
        objective, path, extra = CASES[case]
        _TRAINED[case] = _train_both(objective, path, extra)
    return _TRAINED[case]


def check_training_case(case):
    """A case of CASES against JAX: the trees, predictions, scores, fetches,
    iteration counts and, with a validation set, both metrics."""
    objective, path, extra = CASES[case]
    X, jb, tb, (jev, tev) = trained_case(case)
    _assert_models_match(jb, tb, X)
    _assert_predictions_match(jb, tb, X)
    g = tb._gbdt
    assert g.num_tree_per_iteration == K and g._carried_active is not True
    assert tuple(g.score.shape) == (K, len(X))
    np.testing.assert_allclose(g.score.numpy(),
                               np.asarray(jb._gbdt.train_state.score),
                               rtol=0, atol=1e-5)
    assert g._quantized is bool(extra.get("tpu_quantized_grad", False))
    # the valid-set run fetches each tree in its round; every other run
    # defers its fetches to a drain
    assert g._tree_fetches == (ROUNDS * K if path == "valid" else 0)
    assert tb.current_iteration == ROUNDS == tb.best_iteration
    if path == "valid":
        for m in ("multi_logloss", "multi_error"):
            got, want = tev["valid_0"][m], jev["valid_0"][m]
            assert len(got) == ROUNDS
            np.testing.assert_allclose(got, want, rtol=1e-6)
        assert tev["valid_0"]["multi_logloss"][-1] < \
            tev["valid_0"]["multi_logloss"][0]


@pytest.mark.parametrize("case", MAIN_CASES)
def test_training_matches_jax(case):
    check_training_case(case)


def test_a_class_with_no_rows_matches_jax():
    """Class 1 has no rows: it needs no training, so every iteration runs
    the eager path, and its first tree is a constant at its prior."""
    data = _data(empty_class=1)
    X, jb, tb, _ = _train_both("multiclass", "fused", {}, data=data)
    _assert_models_match(jb, tb, X)
    _assert_predictions_match(jb, tb, X)
    trees = tb._gbdt.models
    assert trees[1].num_leaves == 1 and trees[1 + K].num_leaves == 1
    assert trees[1].leaf_value[0] == pytest.approx(np.log(1e-15))
    assert trees[1 + K].leaf_value[0] == 0.0


# --------------------------------------------------------------------------- #
# model text both ways
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_models_carry_across(objective):
    X, jb, tb, _ = trained_case({"multiclass": "softmax-fused",
                                 "multiclassova": "ova-fused"}[objective])
    carried = interop.booster_from_model_string(jb.model_to_string(),
                                                device="cpu")
    g = carried._gbdt
    assert (g.num_class, g.num_tree_per_iteration) == (K, K)
    assert g.objective.to_string() == jb._gbdt.objective.to_string()
    want = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(carried.predict(X, raw_score=True), want,
                               rtol=0, atol=PRED_ATOL * np.abs(want).max())
    np.testing.assert_allclose(carried.predict(X), jb.predict(X), rtol=0,
                               atol=PRED_ATOL)
    leaves = carried.predict(X, pred_leaf=True)
    assert leaves.shape == (len(X), ROUNDS * K)
    np.testing.assert_array_equal(leaves, jb.predict(X, pred_leaf=True))
    text = tb.model_to_string()
    assert "num_class=%d\nnum_tree_per_iteration=%d" % (K, K) in text
    in_jax = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(in_jax.predict(X), tb.predict(X), rtol=0,
                               atol=1e-12)
    again = tlgb.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(again.predict(X, raw_score=True),
                                  tb.predict(X, raw_score=True))


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_model_text_counts_whole_iterations(objective):
    """num_iteration counts iterations of k trees: the text of the first
    iteration and the split counts that go into it equal JAX's, and a
    loaded model's iteration is its trees over k."""
    X, jb, tb, _ = trained_case({"multiclass": "softmax-fused",
                                 "multiclassova": "ova-fused"}[objective])
    g, jg = tb._gbdt, jb._gbdt
    for it in (1, ROUNDS, ROUNDS + 1):
        np.testing.assert_array_equal(g.feature_importance("split", it),
                                      jg.feature_importance("split", it))
        text = tb.model_to_string(num_iteration=it)
        assert_texts_match(text, jb.model_to_string(num_iteration=it))
        want = K * min(it, ROUNDS)
        assert text.count("\nTree=") == want
        again = tlgb.Booster(model_str=text, device="cpu")
        assert again.num_trees() == want
        assert again.current_iteration == again._gbdt.iter == min(it, ROUNDS)
        assert jlgb.Booster(model_str=text)._gbdt.iter == min(it, ROUNDS)
    assert g.feature_importance("split", 1).sum() < \
        g.feature_importance().sum()


# --------------------------------------------------------------------------- #
# prediction early stop with k > 1
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mc50():
    test = np.loadtxt(os.path.join(INTEROP, "multiclass.test"))[:200]
    path = os.path.join(INTEROP, "mc50.txt")
    return (jlgb.Booster(model_file=path),
            tlgb.Booster(model_file=path, device="cpu"), test[:, 1:])


@pytest.mark.parametrize("freq,margin", [(1, 0.5), (2, 1.0), (4, 0.25),
                                         (5, 1.0), (7, 1.5), (3, 1e-9)])
def test_multiclass_early_stop_matches_jax_host(freq, margin, mc50):
    jb, tb, X = mc50
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    want = jb.predict(X, **kw)
    assert want.shape == (len(X), 5)
    np.testing.assert_array_equal(tb.predict(X, device=False, **kw), want)
    np.testing.assert_array_equal(tb.predict(X, **kw), want)
    full = tb.predict(X, raw_score=True)
    stopped = (want != full).any(axis=1)
    # a share of the rows stops; at the least margin every row does
    assert stopped.any() and bool(stopped.all()) == (margin < 1e-6)
    if freq in (2, 7):
        # KP1's plain walks, the row tiles' and the small batch's (the
        # device path above took the small batch's)
        ens = tb._gbdt._device_ensemble()
        Xt = torch.from_numpy(np.ascontiguousarray(X))
        for small in (False, True):
            out = torch.full((5, len(X)), 7.0, dtype=torch.float64)
            tpk.predict_ensemble(ens.tables, Xt, ens.num_trees, 5, out,
                                 small=small,
                                 mode=tpredict.MODE_SUM_EARLY_STOP,
                                 freq=freq, margin=margin)
            np.testing.assert_array_equal(out.numpy().T, want)


def test_early_stop_tests_iterations_by_the_host_counter():
    """The test comes before the first tree of every ceil(freq / k)-th
    iteration, as the host loop's counter of k trees an iteration puts
    it."""
    got = [t for t in range(40) if tpredict.early_stop_test(t, 5, 7)]
    assert got == [10, 20, 30]
    assert [t for t in range(12) if tpredict.early_stop_test(t, 3, 2)] == \
        [3, 6, 9]
    assert [t for t in range(12) if tpredict.early_stop_test(t, 1, 4)] == \
        [4, 8]
    sums = torch.tensor([[1.0, 2.0, 0.5], [0.25, 2.0, 0.375],
                         [0.75, -1.0, 0.125]], dtype=torch.float64)
    # margins: row 0 1.0 - 0.75, row 1 a tie, row 2 0.5 - 0.375
    assert tpredict.walks_on(sums, 0.5).tolist() == [True, True, True]
    assert tpredict.walks_on(sums, 0.2).tolist() == [False, True, True]
    assert tpredict.walks_on(sums, 0.125).tolist() == [False, True, False]
