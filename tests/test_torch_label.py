"""The port's label engine and K7 against the JAX package, on the CPU.

- K7's plain versions against `histogram_pallas.leaf_histogram` and
  `leaf_histogram_quantized` in interpret mode: f32 within rtol and atol
  1e-4 (tests/test_histogram.py's tolerance; the JAX kernel sums in f32 on
  its matrix unit, the plain version in f64 rounded once) and against a
  numpy bincount; int8 code sums exactly equal; max_bin 16, 63, 255 and
  256, F 3, 11 and 28, n not a multiple of the kernel's 2048-row tile,
  leaf ids with -1 (out of the bag);
- `ops/histogram.leaf_histogram` equal for every `tpu_histogram_impl`, and
  `subtract`;
- `grow_tree_label` against `grow_ops.grow_tree` (hist_impl scatter, and
  one small pallas case in interpret mode) with a bag mask, max_depth,
  monotone constraints and a feature mask, on K1's route and on the XLA
  route's scan: equal split features, counts and leaf ids, thresholds
  equal except at exact ties, leaf values rtol 1e-4;
- `train` with `tpu_tree_engine=label` against the JAX package's label
  engine: binary, L2, bagged, a validation set with early stopping, and
  `tpu_quantized_grad`, which both packages clear with a warning; models
  as tests/test_torch_train.py holds them (rows out of the bag may take
  another leaf only in a tree where a threshold moved across bins that
  hold no row of the bag: ROADMAP.md queue 3); the model text loads in
  the JAX Booster and predicts the same;
- the engine choice of `_setup_tree_engine` on a table of inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu_torch.models.gbdt import choose_tree_engine
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import histogram_kernel as hk
from lightgbm_tpu_torch.ops.split import SplitParams


# --------------------------------------------------------------------------- #
# K7
# --------------------------------------------------------------------------- #
def _hist_inputs(seed, n, F, B, quantized=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    if quantized:
        g = rng.randint(-127, 128, n).astype(np.int8)
        h = rng.randint(0, 128, n).astype(np.int8)
        ids = rng.randint(0, 5, n).astype(np.uint8)
    else:
        g = rng.randn(n).astype(np.float32)
        h = (rng.rand(n) + 0.05).astype(np.float32)
        ids = rng.randint(-1, 4, n).astype(np.int32)
    return bins, g, h, ids


def _bincount(bins, g, h, sel, B):
    F = bins.shape[1]
    out = np.zeros((F, B, 3))
    for f in range(F):
        b = bins[sel, f]
        out[f, :, 0] = np.bincount(b, g[sel].astype(np.float64), minlength=B)
        out[f, :, 1] = np.bincount(b, h[sel].astype(np.float64), minlength=B)
        out[f, :, 2] = np.bincount(b, minlength=B)
    return out


@pytest.mark.parametrize("F", [3, 11, 28])
@pytest.mark.parametrize("max_bin", [16, 63, 255, 256])
def test_leaf_histogram_plain_matches_pallas(max_bin, F):
    n = 2500                      # past one 2048-row tile, not a multiple
    bins, g, h, ids = _hist_inputs(max_bin + F, n, F, max_bin)
    leaf = 2
    want = np.asarray(hp.leaf_histogram(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(ids),
        leaf, max_bin, interpret=True))
    got = hk.leaf_histogram(torch.from_numpy(bins), torch.from_numpy(g),
                            torch.from_numpy(h), torch.from_numpy(ids),
                            torch.tensor(leaf, dtype=torch.int32), max_bin)
    assert got.dtype == torch.float32 and got.shape == (F, max_bin, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               _bincount(bins, g, h, ids == leaf, max_bin),
                               rtol=1e-5, atol=1e-5)
    # the out-of-bag rows form no leaf of their own that K7 is asked for
    # here, but -1 is a leaf id like any other to the function
    oob = hk.leaf_histogram(torch.from_numpy(bins), torch.from_numpy(g),
                            torch.from_numpy(h), torch.from_numpy(ids), -1,
                            max_bin)
    assert int(oob[0, :, 2].sum()) == int((ids == -1).sum())


@pytest.mark.parametrize("F", [3, 28])
@pytest.mark.parametrize("max_bin", [16, 255, 256])
def test_leaf_histogram_quantized_plain_matches_pallas(max_bin, F):
    n = 2300
    bins, g, h, ids = _hist_inputs(7 * max_bin + F, n, F, max_bin,
                                   quantized=True)
    leaf = 3
    want = np.asarray(hp.leaf_histogram_quantized(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(ids),
        leaf, max_bin, interpret=True))
    got = hk.leaf_histogram_quantized(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(ids), leaf, max_bin)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_leaf_histogram_refuses_bad_inputs():
    bins, g, h, ids = (torch.from_numpy(a) for a in
                       _hist_inputs(1, 100, 4, 16))
    with pytest.raises(TypeError):
        hk.leaf_histogram(bins, g.double(), h, ids, 0, 16)
    with pytest.raises(TypeError):
        hk.leaf_histogram(bins, g, h, ids.long(), 0, 16)
    with pytest.raises(ValueError):
        hk.leaf_histogram(bins, g, h, ids, 0, 257)
    with pytest.raises(ValueError):
        hk.leaf_histogram(bins, g, h, ids, torch.zeros(2, dtype=torch.int32),
                          16)
    assert hk.leaf_histogram_bytes(100, 10, 28, 255) == \
        400 + 10 * 36 + 12 * 28 * 255
    assert hk.leaf_histogram_bytes(100, 10, 28, 255, quantized=True) == \
        100 + 10 * 30 + 12 * 28 * 255


def test_every_impl_is_k7_and_subtract():
    bins, g, h, ids = (torch.from_numpy(a) for a in
                       _hist_inputs(2, 3000, 6, 40))
    want = hk.leaf_histogram_plain(bins, g, h, ids, 1, 40)
    for impl in thist.IMPLS:
        got = thist.leaf_histogram(bins, g, h, ids, 1, 40, impl)
        assert torch.equal(got, want), impl
    with pytest.raises(ValueError, match="unknown histogram impl"):
        thist.leaf_histogram(bins, g, h, ids, 1, 40, "gather")
    # leaves 1 and 2 as one parent: the parent less leaf 2 is leaf 1
    parent = thist.leaf_histogram(bins, g, h, torch.where(ids == 2, 1, ids),
                                  1, 40)
    child = thist.leaf_histogram(bins, g, h, ids, 2, 40)
    torch.testing.assert_close(thist.subtract(parent, child), want,
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# grow_tree_label against grow_ops.grow_tree
# --------------------------------------------------------------------------- #
GROW_CASES = {
    "plain": dict(),
    "bag_depth": dict(bag=True, max_depth=4),
    "monotone_mask": dict(monotone=True, feature_mask=True, bag=True),
    # the scan of 2^24 rows and more, on a small input
    "xla_scan": dict(xla_scan=True, bag=True, monotone=True),
    "pallas": dict(hist_impl="pallas", n=1500, bag=True),
}


def _grow_inputs(seed, n, F=6, B=40):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    bins = np.clip((X + 3) / 6 * B, 0, B - 1).astype(np.uint8)
    grad = (np.tanh(X[:, 0] + 0.5 * X[:, 1] * X[:, 2])
            + 0.3 * rng.randn(n)).astype(np.float32)
    hess = (rng.rand(n) * 0.5 + 0.1).astype(np.float32)
    return rng, bins, grad, hess


@pytest.mark.parametrize("name", sorted(GROW_CASES))
def test_grow_tree_label_matches_jax(name, monkeypatch):
    case = GROW_CASES[name]
    if case.get("xla_scan"):
        monkeypatch.setattr(tgrow, "KERNEL_SCAN_ROWS", 0)
    n, F, B, L = case.get("n", 4000), 6, 40, 15
    rng, bins, grad, hess = _grow_inputs(sum(map(ord, name)), n, F, B)
    row0 = (np.where(rng.rand(n) < 0.8, 0, -1).astype(np.int32)
            if case.get("bag") else np.zeros(n, np.int32))
    nb = np.full(F, B, np.int32)
    db = rng.randint(0, B, F).astype(np.int32)
    mt = (np.arange(F) % 3).astype(np.int32)
    fm = np.ones(F, bool)
    if case.get("feature_mask"):
        fm[1] = False
    mono = (np.array([1, 0, -1, 0, 1, 0], np.int8)
            if case.get("monotone") else None)
    depth = case.get("max_depth", -1)
    impl = case.get("hist_impl", "scatter")
    params = dict(min_data_in_leaf=20, lambda_l2=0.5)
    jt, jl = jgrow.grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(row0), jnp.asarray(fm), jnp.asarray(nb), jnp.asarray(db),
        jnp.asarray(mt), jgrow.SplitParams(**params),
        None if mono is None else jnp.asarray(mono), max_leaves=L,
        max_depth=depth, max_bin=B, hist_impl=impl)
    want = jgrow.fetch_tree_arrays(jt)
    got, ids = tgrow.grow_tree_label(
        torch.from_numpy(bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.from_numpy(row0), torch.from_numpy(fm), torch.from_numpy(nb),
        torch.from_numpy(db), torch.from_numpy(mt), SplitParams(**params),
        None if mono is None else torch.from_numpy(mono.astype(np.int32)),
        max_leaves=L, max_depth=depth, max_bin=B, hist_impl=impl)
    nl = int(want.num_leaves)
    assert int(got.num_leaves) == nl > 3
    k = nl - 1
    np.testing.assert_array_equal(got.split_feature.numpy()[:k],
                                  want.split_feature[:k])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jl))
    for f in ("leaf_count", "internal_count", "left_child", "right_child",
              "leaf_parent", "leaf_depth", "missing_type"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    # an exact tie: another threshold, or the other default direction for
    # a missing bin that holds no row of the node, splits it alike
    same = ((got.threshold_bin.numpy()[:k] == want.threshold_bin[:k])
            & (got.default_left.numpy()[:k] == want.default_left[:k]))
    np.testing.assert_allclose(got.split_gain.numpy()[:k][~same],
                               want.split_gain[:k][~same], rtol=1e-5)
    np.testing.assert_allclose(got.leaf_value.numpy()[:nl],
                               want.leaf_value[:nl], rtol=1e-4, atol=1e-7)
    if depth > 0:
        assert int(got.leaf_depth[:nl].max()) <= depth
    assert int(got.leaf_count[:nl].sum()) == int((row0 == 0).sum())
    assert bool((ids[torch.from_numpy(row0) < 0] == -1).all())
    if mono is not None:
        # every monotone split keeps its children's outputs in order
        for node in range(k):
            m = mono[got.split_feature[node]]
            lc, rc = int(got.left_child[node]), int(got.right_child[node])
            if m and lc < 0 and rc < 0:
                lv, rv = got.leaf_value[~lc], got.leaf_value[~rc]
                assert (lv <= rv) if m > 0 else (lv >= rv)


def test_grow_tree_label_stops_without_splits():
    """A leaf count the data cannot fill: the done flag masks every later
    step, and K7 then histograms a leaf no row holds."""
    rng, bins, grad, hess = _grow_inputs(4, 300)
    F, B = 6, 40
    tree, ids = tgrow.grow_tree_label(
        torch.from_numpy(bins), torch.from_numpy(grad), torch.from_numpy(hess),
        torch.zeros(300, dtype=torch.int32), torch.ones(F, dtype=torch.bool),
        torch.full((F,), B, dtype=torch.int32),
        torch.zeros(F, dtype=torch.int32), torch.zeros(F, dtype=torch.int32),
        SplitParams(min_data_in_leaf=60), max_leaves=63, max_bin=B)
    nl = int(tree.num_leaves)
    assert 1 < nl <= 5
    assert sorted(set(ids.tolist())) == list(range(nl))
    assert int(tree.leaf_count[:nl].sum()) == 300
    assert int(tree.leaf_count[nl:].abs().sum()) == 0


# --------------------------------------------------------------------------- #
# train(tpu_tree_engine=label) against the JAX label engine
# --------------------------------------------------------------------------- #
PARAMS = {"num_leaves": 15, "learning_rate": 0.2, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1, "tpu_tree_engine": "label"}
ROUNDS = 3


def _data(seed, n=3000, F=8, task="binary"):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[rng.rand(n) < 0.03, 3] = 0.0
    X[:, 4] = np.round(X[:, 4] * 2)
    score = X[:, 0] + 0.7 * np.sin(2 * X[:, 1]) * X[:, 5] + 0.3 * X[:, 6]
    score = score + 0.5 * rng.randn(n)
    y = (score > 0).astype(np.float64) if task == "binary" else score
    return X, y


def _assert_trees_match(jmodels, tmodels, X, bags):
    """Equal split features, leaf counts and leaves of every row in the
    tree's bag; thresholds and default directions equal except at exact
    ties; rows out of the bag in another leaf only where a threshold or a
    default direction moved.  The JAX label engine sums its f32 histograms
    by a scatter in f32, the plain K7 in f64 rounded once, so a tie's two
    gains agree to rtol 1e-4 (each is a difference of sums that cancel),
    and leaf values to rtol 1e-4 with an atol of 1e-4 of the tree's
    largest |value| (a small value is a cancelled sum too)."""
    assert len(tmodels) == len(jmodels) > 0
    for a, b, bag in zip(tmodels, jmodels, bags):
        assert a.num_leaves == b.num_leaves > 1
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        same = ((a.threshold_in_bin[:k] == b.threshold_in_bin[:k])
                & (a.decision_type[:k] == b.decision_type[:k]))
        np.testing.assert_array_equal(a.threshold[:k][same],
                                      b.threshold[:k][same])
        np.testing.assert_allclose(a.split_gain[:k][~same],
                                   b.split_gain[:k][~same], rtol=1e-4)
        differ = a.predict_leaf_index(X) != b.predict_leaf_index(X)
        in_bag = np.ones(len(X), bool) if bag is None else bag == 0
        assert not differ[in_bag].any()
        assert not differ.any() or not same.all()
        scale = float(np.abs(b.leaf_value[:k + 1]).max())
        np.testing.assert_allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                                   rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        np.testing.assert_array_equal(a.internal_count[:k],
                                      b.internal_count[:k])


TRAIN_CASES = {
    "binary": dict(objective="binary"),
    "l2": dict(objective="regression", lambda_l2=1.0, max_depth=4),
    "bagged_binary": dict(objective="binary", bagging_fraction=0.8,
                          bagging_freq=1, feature_fraction=0.7),
    "bagged_l2": dict(objective="regression", bagging_fraction=0.7,
                      bagging_freq=2),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_label_training_matches_jax(name):
    extra = TRAIN_CASES[name]
    task = "binary" if extra["objective"] == "binary" else "regression"
    X, y = _data(2, task=task)
    params = dict(PARAMS, **extra)
    jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, y))
    tb = tlgb.Booster(params=params, train_set=tlgb.Dataset(X, y, device="cpu"),
                      device="cpu")
    bags = []
    for _ in range(ROUNDS):
        jb.update()
        tb.update()
        tmask = tb._gbdt._bag_mask
        jmask = jb._gbdt._bag_mask
        assert (tmask is None) == (jmask is None)
        if tmask is not None:
            np.testing.assert_array_equal(tmask, np.asarray(jmask))
        bags.append(None if tmask is None else tmask.copy())
    jb.predict(X[:1])                    # drains JAX's pending trees
    tb.num_trees()                       # drains the port's
    tg, jg = tb._gbdt, jb._gbdt
    assert tg._tree_fetches == 0 and tg._drains == 1
    assert not tg._use_partition_engine and not jg._use_partition_engine
    assert tg.arena is None and tg._carried_active is None
    _assert_trees_match(jg.models, tg.models, X, bags)
    np.testing.assert_allclose(tg.score.numpy(),
                               np.asarray(jg.train_state.score)[0], rtol=1e-4,
                               atol=1e-6)
    raw = tb.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)
    # the model text loads in the JAX package and predicts the same
    in_jax = jlgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(in_jax.predict(X, raw_score=True), raw,
                               rtol=1e-12)


def test_label_validation_and_early_stopping_match_jax():
    """A disjoint 600-row holdout, early stopping after 2 rounds without
    gain: equal stopping point and metrics.  A holdout row between two
    thresholds that tie on the node's training rows would part the
    packages (ROADMAP.md queue 3); seed 5 holds no such row."""
    X, y = _data(5)
    params = dict(PARAMS, objective="binary", metric="binary_logloss,auc",
                  learning_rate=0.8)
    runs = {}
    for name, pkg, kw in (("jax", jlgb, {}), ("torch", tlgb,
                                              {"device": "cpu"})):
        ds = pkg.Dataset(X[:2400], y[:2400], **kw)
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=30,
                        valid_sets=[pkg.Dataset(X[2400:], y[2400:],
                                                reference=ds, **kw)],
                        valid_names=["holdout"], early_stopping_rounds=2,
                        evals_result=ev, verbose_eval=False, **kw)
        runs[name] = (bst, ev)
    (jb, jev), (tb, tev) = runs["jax"], runs["torch"]
    assert tb.best_iteration == jb.best_iteration < 30
    assert tb._gbdt.current_iteration == jb._gbdt.current_iteration
    for metric in ("binary_logloss", "auc"):
        np.testing.assert_allclose(tev["holdout"][metric],
                                   jev["holdout"][metric], rtol=1e-6)
    _assert_trees_match(jb._gbdt.models, tb._gbdt.models, X,
                        [None] * len(tb._gbdt.models))


def test_label_quantized_flag_is_cleared_with_a_warning(capsys):
    X, y = _data(3)
    params = dict(PARAMS, objective="binary", tpu_quantized_grad=True,
                  verbose=0)
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=2)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=2, device="cpu")
    err = capsys.readouterr().err
    assert err.count("tpu_quantized_grad requires the partition engine; "
                     "training unquantized on the label engine") == 2
    assert not tb._gbdt._quantized and not jb._gbdt._quantized
    _assert_trees_match(jb._gbdt.models, tb._gbdt.models, X, [None, None])


# --------------------------------------------------------------------------- #
# the engine choice (gbdt.py:1209-1345, serial learner)
# --------------------------------------------------------------------------- #
GIB = 1 << 30


@pytest.mark.parametrize("requested,n,max_bin,arena,budget,want,warns", [
    ("auto", 10_500_000, 255, 3 * GIB, 48 * GIB, "partition", False),
    ("auto", 1 << 24, 255, 5 * GIB, 48 * GIB, "label", False),
    ("auto", 20_000, 511, GIB, 48 * GIB, "label", False),
    ("auto", 100_000_000, 255, 60 * GIB, 48 * GIB, "label", False),
    ("auto", 4_000_000, 255, 9 * GIB, 8 * GIB, "label", False),
    ("label", 10_500_000, 255, 3 * GIB, 48 * GIB, "label", False),
    ("partition", 10_500_000, 255, 60 * GIB, 48 * GIB, "partition", False),
    ("partition", 1 << 24, 255, GIB, 48 * GIB, "label", True),
    ("partition", 20_000, 511, GIB, 48 * GIB, "label", True),
])
def test_engine_choice(requested, n, max_bin, arena, budget, want, warns,
                       capsys):
    from lightgbm_tpu_torch.utils import log
    level = log.get_level()
    log.set_level(log.WARNING)
    try:
        base_ok = max_bin <= 256 and n < (1 << 24)
        assert choose_tree_engine(requested, base_ok, arena, budget) == want
    finally:
        log.set_level(level)
    assert ("using label engine" in capsys.readouterr().err) is warns
    with pytest.raises(ValueError):
        choose_tree_engine("arena", True, 0, 1)
