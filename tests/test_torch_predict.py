"""Device prediction of the port (ops/predict.py, KP1's plain version)
against the JAX package and the reference's interop fixtures, on the CPU.

- models of the reference CLI and of the JAX package
  (`tests/fixtures/interop/{ref50,reg50,cat50,mc50}.txt` and `repo_*.txt`)
  loaded into the port predict their recorded predictions within
  INTEROP_ATOL x scale (5e-6, tests/test_engine.py:155), and the device
  path equals the port's host walk bit for bit;
- raw sums of the port's DeviceEnsemble equal JAX's DeviceEnsemble
  (x64 on, as the tests run it) within 5e-6 x scale, and the port's host
  walk bit for bit, on a trained 31-leaf binary model over NaNs and exact
  zeros, the same with zero_as_missing and with use_missing off, cat50
  (multi-word bitsets), and mc50's 250 trees as a k=5 and a k=3 ensemble;
  each row's leaf equals JAX's host `predict_leaf_index`;
- early stop (k = 1) equals JAX's host early stop bit for bit (k > 1:
  tests/test_torch_multiclass.py);
- pred_leaf exactly and pred_contrib within 1e-10 equal JAX's
  `Booster.predict`, on a numpy array, a DataFrame and a CSR matrix;
- `predict_bucketed`, `pow2_buckets` and `bucket_rows` equal JAX's;
- `estimate_device_bytes` equals `device_bytes()` of the built ensemble;
- KP1's packed tables hold every tree field by field (preorder items, the
  left child next, the right child's item), in groups of at most a
  stage's items, by fours; the small-batch walk's plain version (leaf
  values per tree, then an ordered sum) equals the row walk and the host
  walk bit for bit, with early stop;
- f32 rows reach the device walk as f32 and predict, bit for bit, what
  the host walk predicts from the same values as f64;
- the ensemble cache is rebuilt after `load_model_from_string`;
- rows narrower than the model raise on every path (host walk, device
  sums, leaves, SHAP), and KP1's wrapper refuses an X that lacks a
  feature its tables split on;
- sparse input reaches the score and the leaf paths densified in chunks;
- a `boosting=rf` model of the JAX package predicts the mean of its trees
  in the port too (its `average_output` line is read and written back);
- DART and GOSS models of the JAX package, carried across by
  `interop.booster_from_model_string`, predict JAX's raw scores within
  INTEROP_ATOL x scale on both walks.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.ops import predict_kernel as tpk
from lightgbm_tpu_torch.utils.log import LightGBMError

INTEROP = os.path.join(os.path.dirname(__file__), "fixtures", "interop")
INTEROP_ATOL = 5e-6
SUITES = {"ref50": "binary.test", "reg50": "regression.test",
          "cat50": "cat.test", "mc50": "multiclass.test"}


def _test_rows(name):
    test = np.loadtxt(os.path.join(INTEROP, SUITES[name]))
    return test[:, 1:], max(1.0, float(np.max(np.abs(test[:, 0]))))


def _text(name):
    with open(os.path.join(INTEROP, "%s.txt" % name)) as f:
        return f.read()


def _port_trees(text):
    """The trees of a model text, parsed by the port's Tree.from_string as
    its loader splits them."""
    trees = []
    for blk in text.split("Tree=")[1:]:
        body = blk.split("\n\n")[0]
        body = body[body.index("\n") + 1:]
        if "end of trees" in body:
            body = body[:body.index("end of trees")]
        trees.append(Tree.from_string(body))
    return trees


def _assert_close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=INTEROP_ATOL * scale)


# --------------------------------------------------------------------------- #
# interop fixtures
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model,pred", [
    ("ref50", "ref50_pred"), ("reg50", "reg50_pred"), ("cat50", "cat50_pred"),
    ("mc50", "mc50_pred"), ("repo_mc50", "repo_mc50_ref_pred"),
    ("repo_ref50", "repo_ref50_ref_pred"),
    ("repo_reg50", "repo_reg50_ref_pred"),
    ("repo_cat50", "repo_cat50_ref_pred")])
def test_fixture_models_predict_the_reference(model, pred):
    X, scale = _test_rows(model.replace("repo_", ""))
    bst = tlgb.Booster(model_file=os.path.join(INTEROP, model + ".txt"),
                       device="cpu")
    ref = np.loadtxt(os.path.join(INTEROP, pred + ".txt"))
    got = bst.predict(X)
    assert got.shape == ref.shape
    _assert_close(got, ref, scale)
    # the device path (the plain version here) is the host walk, bit for bit
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_array_equal(raw, bst.predict(X, raw_score=True,
                                                   device=False))
    np.testing.assert_array_equal(bst.predict(X), bst.predict(X, device=False))


# --------------------------------------------------------------------------- #
# against JAX's DeviceEnsemble
# --------------------------------------------------------------------------- #
def _nan_zero_data(n, F=8, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.08] = np.nan
    X[rng.rand(n, F) < 0.08] = 0.0
    X[:, 5] = np.round(X[:, 5])           # many exact zeros and ties
    X[rng.rand(n) < 0.05, 6] = 1e-36       # "zero" by K_ZERO_THRESHOLD
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) * X[:, 5]
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


TRAINED = {
    "nan_zero": {},
    "zero_as_missing": {"zero_as_missing": True},
    "no_missing": {"use_missing": False},
}


@pytest.fixture(scope="module")
def trained():
    """31-leaf binary models trained by the JAX package on data with NaNs
    and exact zeros, with the rows to predict (unseen, same generator)."""
    X, y = _nan_zero_data(2000)
    Xp, _ = _nan_zero_data(700, seed=4)
    out = {}
    for name, extra in TRAINED.items():
        params = dict({"objective": "binary", "num_leaves": 31,
                       "learning_rate": 0.2, "min_data_in_leaf": 10,
                       "verbose": -1}, **extra)
        jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=12)
        out[name] = (jb, Xp)
    return out


def _case(name, trained):
    """(JAX trees, port trees, k, rows, scale) of an ensemble case."""
    if name in TRAINED:
        jb, X = trained[name]
        text = jb.model_to_string()
        return jb._gbdt.models, _port_trees(text), 1, X
    model, k = {"cat50": ("cat50", 1), "mc50_k5": ("mc50", 5),
                "mc50_k3": ("mc50", 3)}[name]
    X, _ = _test_rows(model)
    jb = jlgb.Booster(model_file=os.path.join(INTEROP, model + ".txt"))
    return jb._gbdt.models, _port_trees(_text(model)), k, X


ENSEMBLES = sorted(TRAINED) + ["cat50", "mc50_k5", "mc50_k3"]


@pytest.mark.parametrize("name", ENSEMBLES)
def test_ensemble_matches_jax_and_the_host_walk(name, trained):
    jtrees, ttrees, k, X = _case(name, trained)
    assert len(jtrees) == len(ttrees)
    jens = jpredict.DeviceEnsemble(jtrees, k)
    tens = tpredict.DeviceEnsemble(ttrees, k, device="cpu")
    assert tens.ok and tens.k == k and tens.num_trees == len(ttrees)
    iters_all = -(-len(ttrees) // k)
    for iters in (iters_all, max(iters_all // 3, 1)):
        got = tens.predict_sum(X, iters)
        want = jens.predict_sum(X, iters)
        assert got.shape == want.shape == (k, len(X))
        assert got.dtype == np.float64
        _assert_close(got, want, max(1.0, float(np.abs(want).max())))
        # the host walk of the same trees, tree t to class t % k
        host = np.zeros((k, len(X)))
        for t in range(min(iters * k, len(ttrees))):
            host[t % k] += ttrees[t].predict(X)
        np.testing.assert_array_equal(got, host)
    # every row's leaf in every tree: JAX's host walk
    leaves = tens.predict_leaf(X, iters_all)
    assert leaves.dtype == np.int32 and leaves.shape == (len(X),
                                                         len(ttrees))
    for t, tree in enumerate(jtrees):
        np.testing.assert_array_equal(leaves[:, t],
                                      tree.predict_leaf_index(X))


@pytest.mark.parametrize("name", ENSEMBLES)
def test_device_bytes_equal_the_estimate(name, trained):
    _, ttrees, k, _ = _case(name, trained)
    ens = tpredict.DeviceEnsemble(ttrees, k, device="cpu")
    assert ens.device_bytes() == tpredict.estimate_device_bytes(ttrees, k)
    lay = tpredict.ensemble_layout(ttrees, k)
    assert lay["ok"] and lay["T"] == len(ttrees)
    assert lay["N"] == sum(t.num_leaves - 1 for t in ttrees)
    assert lay["I"] == lay["N"] + lay["L"]
    assert (lay["W"] > 0) is (name == "cat50")


def test_empty_and_one_leaf_ensembles():
    """No trees, and a constant tree: zeros, and the constant."""
    X = np.random.RandomState(0).randn(9, 3)
    ens = tpredict.DeviceEnsemble([], 1, device="cpu")
    np.testing.assert_array_equal(ens.predict_sum(X, 5), np.zeros((1, 9)))
    assert ens.predict_leaf(X, 5).shape == (9, 0)
    assert ens.device_bytes() == tpredict.estimate_device_bytes([], 1)
    t = Tree(1)
    t.as_constant(0.25)
    ens = tpredict.DeviceEnsemble([t, t], 1, device="cpu")
    np.testing.assert_array_equal(ens.predict_sum(X, 2), np.full((1, 9), 0.5))
    np.testing.assert_array_equal(ens.predict_leaf(X, 2),
                                  np.zeros((9, 2), np.int32))


# --------------------------------------------------------------------------- #
# early stop
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("freq,margin", [(1, 0.5), (3, 2.0), (10, 10.0),
                                         (4, 1e-9)])
def test_early_stop_matches_jax_host(freq, margin, trained):
    jb, X = trained["nan_zero"]
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    want = jb.predict(X, **kw)
    got = tb.predict(X, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb.predict(X, device=False, **kw), want)
    full = tb.predict(X, raw_score=True)
    stopped = got != full
    assert stopped.any() or margin >= 10.0


# --------------------------------------------------------------------------- #
# the Booster's prediction options and inputs
# --------------------------------------------------------------------------- #
def _inputs(kind, X):
    if kind == "numpy":
        return X
    if kind == "dataframe":
        pd = pytest.importorskip("pandas")
        return pd.DataFrame(X, columns=["f%d" % i for i in range(X.shape[1])])
    return sp.csr_matrix(np.nan_to_num(X))


@pytest.mark.parametrize("kind", ["numpy", "dataframe", "csr"])
def test_booster_predict_options_match_jax(kind, trained):
    jb, X = trained["nan_zero"]
    X = X[:120]
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    data = _inputs(kind, X)
    for kw in ({}, {"raw_score": True}, {"num_iteration": 5}):
        _assert_close(tb.predict(data, **kw), jb.predict(data, **kw), 1.0)
    np.testing.assert_array_equal(tb.predict(data, pred_leaf=True),
                                  jb.predict(data, pred_leaf=True))
    np.testing.assert_array_equal(
        tb.predict(data, pred_leaf=True, num_iteration=3),
        jb.predict(data, pred_leaf=True, num_iteration=3))
    np.testing.assert_allclose(tb.predict(data, pred_contrib=True),
                               jb.predict(data, pred_contrib=True),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("method,kw", [
    ("predict_raw", {"raw_score": True}),
    ("predict_leaf_index", {"pred_leaf": True})])
def test_sparse_input_is_densified_in_chunks(method, kw, trained,
                                             monkeypatch):
    jb, X = trained["nan_zero"]
    X = np.nan_to_num(X)
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    seen = []
    real = getattr(tb._gbdt, method)

    def spy(X, *a, **kw):
        seen.append(type(X))
        return real(X, *a, **kw)
    monkeypatch.setattr(tb._gbdt, method, spy)
    got = tb.predict(sp.csr_matrix(X), **kw)
    np.testing.assert_array_equal(got, tb.predict(X, **kw))
    assert seen[0] is sp.csr_matrix and seen[1] is np.ndarray


@pytest.mark.parametrize("kw", [
    {"raw_score": True}, {"raw_score": True, "device": False},
    {"pred_leaf": True}, {"pred_leaf": True, "device": False},
    {"pred_contrib": True}])
def test_too_few_features_raise(kw, trained):
    """Every prediction path refuses rows narrower than the model, as the
    host walk does, before a kernel could read past a row."""
    jb, X = trained["nan_zero"]
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    F = tb._gbdt.max_feature_idx + 1
    with pytest.raises(LightGBMError, match="number of features"):
        tb.predict(X[:20, :F - 1], **kw)


# --------------------------------------------------------------------------- #
# serving hooks
# --------------------------------------------------------------------------- #
def test_bucket_helpers_match_jax():
    for n in (0, 1, 2, 3, 7, 8, 1000, 4097, 1 << 20, (1 << 20) + 1):
        for cap in (1, 256, 1 << 20):
            assert tpredict.bucket_rows(n, cap) == jpredict.bucket_rows(n, cap)
    for m in (0, 1, 5, 64, 1000):
        assert tpredict.pow2_buckets(m) == jpredict.pow2_buckets(m)


def test_predict_bucketed_matches_jax(trained):
    jb, X = trained["zero_as_missing"]
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    g = tb._gbdt
    full = g.predict(X, raw_score=True)
    for n, cap in ((1, 1 << 20), (7, 1 << 20), (300, 256), (700, 1024)):
        got = g.predict_bucketed(X[:n], raw_score=True, max_bucket=cap)
        np.testing.assert_array_equal(got, full[:n])
        want = jb._gbdt.predict_bucketed(X[:n], raw_score=True,
                                         max_bucket=cap)
        _assert_close(got, want, max(1.0, float(np.abs(want).max())))
    ens = tpredict.DeviceEnsemble(g.models, 1, device="cpu")
    np.testing.assert_array_equal(
        g.predict_bucketed(X[:9], ensemble=ens), g.predict(X[:9]))
    assert ens.warmup_buckets(X.shape[1], [4, 1, 0, 4], 3) == [1, 4]


def test_ensemble_cache_follows_the_model(trained):
    jb, X = trained["nan_zero"]
    other, _ = trained["no_missing"]
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    g = tb._gbdt
    first = tb.predict(X, raw_score=True)
    ens = g._device_ensemble()
    assert g._device_ensemble() is ens
    g.load_model_from_string(other.model_to_string())
    assert g._device_ensemble() is not ens
    got = tb.predict(X, raw_score=True)
    np.testing.assert_array_equal(got, tb.predict(X, raw_score=True,
                                                  device=False))
    _assert_close(got, other.predict(X, raw_score=True), 1.0)
    assert not np.array_equal(got, first)


# --------------------------------------------------------------------------- #
# boosting=rf: the mean of the trees
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("raw_score", [False, True])
def test_rf_model_predicts_the_mean_of_its_trees(raw_score):
    X, y = _nan_zero_data(1500, seed=6)
    params = {"objective": "binary", "boosting": "rf", "num_leaves": 15,
              "bagging_fraction": 0.8, "bagging_freq": 1,
              "feature_fraction": 0.8, "verbose": -1}
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=4)
    text = jb.model_to_string()
    assert "\naverage_output\n" in text
    tb = tlgb.Booster(model_str=text, device="cpu")
    assert tb._gbdt.average_output
    want = jb.predict(X, raw_score=raw_score)
    scale = max(1.0, float(np.abs(want).max()))
    for device in (None, False):
        _assert_close(tb.predict(X, raw_score=raw_score, device=device),
                      want, scale)
    _assert_close(tb._gbdt.predict_bucketed(X[:5], raw_score=raw_score),
                  want[:5], scale)
    # early stop is off for an averaged model
    np.testing.assert_array_equal(
        tb.predict(X, raw_score=True, pred_early_stop=True,
                   pred_early_stop_margin=1e-9),
        tb.predict(X, raw_score=True))
    # the line survives the port's save
    again = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    assert again._gbdt.average_output
    np.testing.assert_array_equal(again.predict(X, raw_score=raw_score),
                                  tb.predict(X, raw_score=raw_score))


@pytest.mark.parametrize("boosting", ["dart", "goss"])
def test_boosting_mode_models_carry_across(boosting):
    """A JAX DART model (trees rescaled by its drops) and a JAX GOSS model
    (trees of sampled rounds) load into the port as plain GBDTs, as the
    JAX package loads them, and predict its raw scores."""
    X, y = _nan_zero_data(1500, seed=9)
    params = {"objective": "binary", "boosting": boosting, "num_leaves": 15,
              "learning_rate": 0.5, "drop_rate": 0.5, "skip_drop": 0.0,
              "verbose": -1}
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=6)
    carried = interop.booster_from_model_string(jb.model_to_string(),
                                                device="cpu")
    assert type(carried._gbdt).__name__ == "GBDT"
    want = jb.predict(X, raw_score=True)
    scale = max(1.0, float(np.abs(want).max()))
    for device in (None, False):
        _assert_close(carried.predict(X, raw_score=True, device=device),
                      want, scale)


# --------------------------------------------------------------------------- #
# KP1's packed tables, its small-batch sum and its f32 feed
# --------------------------------------------------------------------------- #
def _assert_items_are_the_tree(tb, ti, tree):
    """Tree ti's items, field by field: a preorder walk of the host tree
    and of its items side by side (the left child the next item, the
    right child at the item's right field)."""
    lanes = tb.items.numpy()
    value = tb.items.view(torch.float64)[:, 0].numpy()
    base = int(tb.tree_off[ti])
    assert int(tb.tree_off[ti + 1]) - base == 2 * max(tree.num_leaves, 1) - 1
    stack = [(0, 0)] if tree.num_leaves > 1 else [(-1, 0)]
    while stack:
        node, item = stack.pop()
        meta, right = int(lanes[base + item, 2]), int(lanes[base + item, 3])
        if node < 0:
            assert meta < 0 and meta & 0xFFFFFF == ~node
            assert value[base + item] == tree.leaf_value[~node]
            continue
        assert meta >= 0 and meta & 0xFFFFFF == tree.split_feature[node]
        assert meta >> 24 == tree.decision_type[node]
        assert value[base + item] == tree.threshold[node]
        stack.append((int(tree.right_child[node]), right))
        stack.append((int(tree.left_child[node]), item + 1))


@pytest.mark.parametrize("name", ENSEMBLES)
def test_packed_items_hold_every_tree(name, trained):
    _, ttrees, k, X = _case(name, trained)
    tb = tpredict.build_tables(ttrees, "cpu")
    for ti, tree in enumerate(ttrees):
        _assert_items_are_the_tree(tb, ti, tree)
    groups = tb.group_off.tolist()
    assert groups[0] == 0 and groups[-1] == len(ttrees)
    assert groups == tpredict.tree_groups(
        [2 * t.num_leaves - 1 for t in ttrees])
    assert 0 < tb.stage_items <= tpredict._STAGE_ITEMS
    lay = tpredict.ensemble_layout(ttrees, k)
    assert lay["I"] == len(tb.items) and lay["G"] == len(groups) - 1


def test_tree_groups_fill_a_stage_by_fours():
    """Groups of consecutive trees up to the stage's items, a group of 4
    trees or more cut to a multiple of 4 unless it is the last; a tree
    larger than a stage alone."""
    assert tpredict.tree_groups([509] * 13) == [0, 4, 8, 13]
    assert tpredict.tree_groups([61] * 9 + [3999] + [61] * 3) == \
        [0, 8, 9, 10, 13]
    assert tpredict.tree_groups([1] * 5, stage_items=3) == [0, 3, 5]
    assert tpredict.tree_groups([]) == [0]


@pytest.mark.parametrize("name", ["nan_zero", "cat50", "mc50_k3"])
def test_small_batch_sum_is_the_row_walk(name, trained):
    """The small-batch walk's plain version (each tree's leaf value, then
    each row's values added in tree order) equals the row walk and the
    host walk bit for bit: all trees, a third, and early stop."""
    _, ttrees, k, X = _case(name, trained)
    tb = tpredict.build_tables(ttrees, "cpu")
    Xt = torch.from_numpy(np.ascontiguousarray(X))
    T = len(ttrees)
    vals = tpredict.tree_values_plain(tb, Xt, T)
    for t_used in (T, T // 3):
        got = tpredict.ordered_sum_plain(vals[:t_used], k)
        assert torch.equal(got,
                           tpredict.predict_ensemble_plain(tb, Xt, t_used, k))
        host = np.zeros((k, len(X)))
        for t in range(t_used):
            host[t % k] += ttrees[t].predict(X)
        np.testing.assert_array_equal(got.numpy(), host)
    if k == 1:
        for freq, margin in ((3, 1.0), (5, 0.5)):
            es = tpredict.MODE_SUM_EARLY_STOP
            assert torch.equal(
                tpredict.ordered_sum_plain(vals, 1, es, freq, margin),
                tpredict.predict_ensemble_plain(tb, Xt, T, 1, es, freq,
                                                margin))
    out = {}
    for small in (False, True):
        out[small] = torch.full((k, len(X)), 7.0, dtype=torch.float64)
        tpk.predict_ensemble(tb, Xt, T, k, out[small], small=small)
    assert torch.equal(out[False], out[True])
    assert tpk.small_batch(1, 500) and tpk.small_batch(4097, 500)
    assert not tpk.small_batch(100_000, 500)
    assert tpk.small_batch(65_536, 500) and not tpk.small_batch(65_537, 500)
    assert not tpk.small_batch(65_536, 513)


def test_f32_rows_predict_their_values_as_f64(trained):
    """Booster.predict on f32 rows walks them as f32 (the device path
    widens each value where it compares it): bit for bit the host walk of
    the same values as f64, and JAX's host prediction within the interop
    tolerance; leaves and the serving path alike."""
    jb, X = trained["nan_zero"]
    X32 = X.astype(np.float32)
    X64 = X32.astype(np.float64)
    tb = tlgb.Booster(model_str=jb.model_to_string(), device="cpu")
    g = tb._gbdt
    seen = []
    real = g._device_ensemble().predict_sum

    def spy(X, *a, **kw):
        seen.append(X.dtype)
        return real(X, *a, **kw)
    g._device_ensemble().predict_sum = spy
    raw = tb.predict(X32, raw_score=True)
    assert seen == [np.float32]
    np.testing.assert_array_equal(raw, tb.predict(X64, raw_score=True,
                                                  device=False))
    np.testing.assert_array_equal(raw, tb.predict(X32, raw_score=True,
                                                  device=False))
    _assert_close(raw, jb.predict(X64, raw_score=True), 1.0)
    np.testing.assert_array_equal(tb.predict(X32, pred_leaf=True),
                                  tb.predict(X64, pred_leaf=True,
                                             device=False))
    np.testing.assert_array_equal(g.predict_bucketed(X32[:7], raw_score=True),
                                  raw[:7])
    # any other dtype reaches the walk as f64
    assert g._check_features(X32.astype(np.float16), float32=True).dtype \
        == np.float64
    assert g._check_features(X32).dtype == np.float64


# --------------------------------------------------------------------------- #
# KP1's and KP2's plain versions through their wrappers
# --------------------------------------------------------------------------- #
def test_predict_ensemble_wrapper_checks_and_chunks(trained):
    jb, X = trained["nan_zero"]
    ens = tpredict.DeviceEnsemble(_port_trees(jb.model_to_string()), 1,
                                  device="cpu")
    Xt = torch.from_numpy(np.ascontiguousarray(X))
    whole = torch.zeros((1, len(X)), dtype=torch.float64)
    tpk.predict_ensemble(ens.tables, Xt, 12, 1, whole)
    parts = torch.zeros((1, len(X)), dtype=torch.float64)
    for a in range(0, len(X), 97):
        tpk.predict_ensemble(ens.tables, Xt[a:a + 97], 12, 1, parts, a)
    assert torch.equal(whole, parts)
    # f32 rows compare their values widened to f64: the sums of the f64
    # rows that hold the same values
    x32 = Xt.float()
    tpk.predict_ensemble(ens.tables, x32, 12, 1, parts)
    tpk.predict_ensemble(ens.tables, x32.double(), 12, 1, whole)
    assert torch.equal(whole, parts)
    with pytest.raises(TypeError):
        tpk.predict_ensemble(ens.tables, Xt.to(torch.int32), 12, 1, whole)
    with pytest.raises(ValueError):
        tpk.predict_ensemble(ens.tables, Xt, 13, 1, whole)
    with pytest.raises(ValueError):
        tpk.predict_ensemble(ens.tables, Xt, 12, 1, whole,
                             mode=tpredict.MODE_SUM_EARLY_STOP, freq=0)
    # a node reads a feature X lacks: the kernel would read past each row
    cut = ens.tables.max_feature
    assert cut == max(int(t.split_feature[:t.num_leaves - 1].max())
                      for t in _port_trees(jb.model_to_string())
                      if t.num_leaves > 1)
    with pytest.raises(ValueError, match="features"):
        tpk.predict_ensemble(ens.tables, Xt[:, :cut].contiguous(), 12, 1,
                             whole)


def test_walk_binned_plain_modes():
    """Leaf mode is predict_leaf_inner; add mode adds lv at the walked
    leaf; masked add takes the given leaf id where it is >= 0."""
    from lightgbm_tpu_torch.ops.grow import predict_leaf_inner
    from test_torch_graphs import _tree
    tree, _, _ = _tree()
    rng = np.random.RandomState(8)
    n, F = 500, 5
    bins = torch.from_numpy(rng.randint(0, 32, (n, F)).astype(np.uint8))
    nb = torch.full((F,), 32, dtype=torch.int32)
    db = torch.from_numpy(rng.randint(0, 32, F).astype(np.int32))
    leaf = tpk.walk_binned(bins, tree, nb, db)
    assert torch.equal(leaf, predict_leaf_inner(bins, tree, nb, db))
    lv = torch.from_numpy(rng.randn(15).astype(np.float32))
    score = torch.from_numpy(rng.randn(n).astype(np.float32))
    want = score + lv[leaf.long()]
    got = score.clone()
    assert tpk.walk_binned(bins, tree, nb, db, lv=lv, score=got) is None
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ids = torch.from_numpy(np.where(rng.rand(n) < 0.8,
                                    rng.randint(0, 15, n), -1)
                           .astype(np.int32))
    want = score + lv[torch.where(ids >= 0, ids, leaf).long()]
    got = score.clone()
    tpk.walk_binned(bins, tree, nb, db, lv=lv, score=got, leaf_ids=ids)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        tpk.walk_binned(bins, tree, nb, db, lv=lv)
    with pytest.raises(TypeError):
        tpk.walk_binned(bins.int(), tree, nb, db)
