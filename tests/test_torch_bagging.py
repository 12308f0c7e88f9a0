"""Bagging and validation sets in the port against the JAX package, on the
CPU (its Pallas kernels in interpret mode, `tpu_tree_engine="partition"`).

- K3 in pred mode with the fused hist_stream histogram: the plain version
  against `partition_pallas.partition_segment(..., pred, hist_stream)`:
  counts and both streams' planes exact; the histogram exact for codes,
  within rtol 1e-5 for f32 (the JAX kernel sums bf16 residue planes in f32,
  the plain version in f64 rounded once);
- the binned tree walk `predict_leaf_inner` equal to JAX's on the same
  TreeArrays and bins, with every missing type and default direction;
- end to end, 3 rounds: bagged binary (f32 and quantized), bagged L2,
  bagging_freq=2, and a validation-set run with a training metric and
  early stopping.  The bag masks are equal every round; both packages stay
  off the carried arena; the trees are equal as
  tests/test_torch_train.py's `_assert_models_match` holds them; the
  training scores agree within 1e-6 of their scale, the evals_result values
  within 1e-6, and best_iteration is equal.  f32 histograms agree only to
  reassociation, so at an exact tie between thresholds with no in-bag row
  of the node between them the two packages may pick different ones; the
  out-of-bag rows between them then land in different leaves (the data of
  tests/test_torch_carried.py, seed 7, holds one such row in its first
  bagged binary tree; ROADMAP.md queue 3).  The bagged inputs here (seed
  2) hold no such tie; quantized histograms are exact integers and never
  tie differently;
- a validation set given no reference is binned on its own mappers in
  both packages: equal bins and equal metrics;
- the lifecycle: a validation set added after two carried rounds moves
  both packages off the carried arena for good, and the later trees and
  validation metrics stay equal;
- the port's callback module stays a copy of the JAX package's.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import partition_pallas as pp
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import partition_kernel as pk

TILE = pp.TILE
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------- #
# K3 pred mode + hist_stream
# --------------------------------------------------------------------------- #
def _kernel_data(seed, n=3000, F=5, B=40, quantized=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, F)).astype(np.uint8)
    if quantized:
        g = rng.randint(-127, 128, n).astype(np.int8)
        h = rng.randint(0, 128, n).astype(np.int8)
    else:
        g = rng.randn(n).astype(np.float32)
        h = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    return bins, g, h, (rng.rand(n) < 0.8).astype(np.uint8)


def _jax_arena(bins, g, h, cap, quantized):
    """Pristine-layout arena: bins, the payload planes (six f32 residue
    planes or two code planes) and the rowid byte planes."""
    n, F = bins.shape
    Fp = pp.feature_channels(F)
    arena = pp.init_pristine(jnp.zeros((pp.arena_channels(F), cap),
                                       pp.ARENA_DT),
                             jnp.asarray(bins.T, pp.ARENA_DT))
    if quantized:
        planes = pp.pack_code_planes(jnp.asarray(g, jnp.float32),
                                     jnp.asarray(h, jnp.float32))
    else:
        planes = jnp.concatenate(
            [c[None] for c in pp.split_f32(jnp.asarray(g))]
            + [c[None] for c in pp.split_f32(jnp.asarray(h))])
    return arena.at[Fp:Fp + planes.shape[0], :n].set(planes)


def _jax_planes(arena, F, start, cnt, quantized):
    a = np.asarray(arena[:, start:start + cnt], np.float32)
    Fp = pp.feature_channels(F)
    if quantized:
        g, h = a[Fp], a[Fp + 1]
    else:
        g = a[Fp] + a[Fp + 1] + a[Fp + 2]
        h = a[Fp + 3] + a[Fp + 4] + a[Fp + 5]
    rid = (a[Fp + 6].astype(np.int64) * 65536
           + a[Fp + 7].astype(np.int64) * 256 + a[Fp + 8].astype(np.int64))
    return a[:F].astype(np.uint8), g, h, rid


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hist_stream", [0, 1])
def test_partition_pred_hist_matches_jax(quantized, hist_stream):
    """The bagged root pass: rows by predicate into A (the bag) and B, one
    stream histogrammed.  The port's predicate stops 257 columns short of
    the segment, where the JAX one is zero-padded; with hist_stream=1 the
    A stream is written in place."""
    bins, g, h, pred = _kernel_data(3 + hist_stream, quantized=quantized)
    n, F = bins.shape
    B = 40
    m = n - 257
    pred[m:] = 0
    dst_a = 0 if hist_stream == 1 else 2 * TILE
    dst_b = 4 * TILE
    pred_j = jnp.zeros((1, 8 * TILE), jnp.float32).at[0, :n].set(pred)
    arena_j, counts, hist_j = pp.partition_segment(
        _jax_arena(bins, g, h, 8 * TILE, quantized), pred_j, 0, n, dst_a,
        dst_b, hist_stream=hist_stream, num_features=F, max_bin=B,
        quantized=quantized, interpret=True)
    counts, hist_j = np.asarray(counts), np.asarray(hist_j)

    arena_t = pk.Arena(n, F, 8, "cpu", quantized=quantized)
    pk.init_pristine(arena_t, torch.from_numpy(np.ascontiguousarray(bins.T)))
    arena_t.payload[0, :n] = torch.from_numpy(g)
    arena_t.payload[1, :n] = torch.from_numpy(h)
    sc = torch.tensor([0, n, dst_a, dst_b, 0, 0, 0, 0], dtype=torch.int32)
    hist_t = pk.partition_segment_pred(arena_t, sc,
                                       torch.from_numpy(pred[:m].copy()),
                                       hist_stream=hist_stream, max_bin=B)
    assert int(sc[pk.SC_CNT_A]) == counts[0] == int(pred.sum())
    assert int(sc[pk.SC_CNT_B]) == counts[1] == n - counts[0]
    for dst, c in ((dst_a, counts[0]), (dst_b, counts[1])):
        want = _jax_planes(arena_j, F, dst, c, quantized)
        got = (arena_t.bins[:, dst:dst + c].numpy(),
               arena_t.payload[0, dst:dst + c].numpy(),
               arena_t.payload[1, dst:dst + c].numpy(),
               arena_t.rid[dst:dst + c].numpy().astype(np.int64))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.astype(a.dtype))
    if quantized:
        assert hist_t.dtype == torch.int32
        np.testing.assert_array_equal(hist_t.numpy(), hist_j.astype(np.int64))
    else:
        np.testing.assert_array_equal(hist_t[..., 2].numpy(), hist_j[..., 2])
        np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-5,
                                   atol=1e-5)


def test_partition_pred_without_histogram():
    bins, g, h, pred = _kernel_data(5, n=700)
    arena = pk.Arena(700, bins.shape[1], 8, "cpu")
    pk.init_pristine(arena, torch.from_numpy(np.ascontiguousarray(bins.T)))
    sc = torch.tensor([0, 700, 2 * TILE, 4 * TILE, 0, 0, 0, 0],
                      dtype=torch.int32)
    assert pk.partition_segment_pred(arena, sc, torch.from_numpy(pred)) \
        is None
    na, nb = int(sc[pk.SC_CNT_A]), int(sc[pk.SC_CNT_B])
    np.testing.assert_array_equal(arena.rid[2 * TILE:2 * TILE + na].numpy(),
                                  np.flatnonzero(pred))
    np.testing.assert_array_equal(arena.rid[4 * TILE:4 * TILE + nb].numpy(),
                                  np.flatnonzero(pred == 0))
    with pytest.raises(TypeError):
        pk.partition_segment_pred(arena, sc, torch.from_numpy(pred).bool())
    with pytest.raises(ValueError):
        pk.partition_segment_pred(arena, sc, torch.from_numpy(pred),
                                  hist_stream=2, max_bin=40)


# --------------------------------------------------------------------------- #
# the binned tree walk
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["grown", "random_missing", "single_leaf"])
def test_predict_leaf_inner_matches_jax(case):
    """A tree grown by the JAX label engine; "random_missing" redraws every
    node's missing type (none, zero, NaN) and default direction, so rows at
    a feature's default bin or last bin take both ways."""
    rng = np.random.RandomState(11)
    n, F, B = 2000, 6, 32
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    num_bins = np.full(F, B, np.int32)
    default_bins = rng.randint(0, B, F).astype(np.int32)
    tree, _ = jgrow.grow_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.zeros(n, jnp.int32), jnp.ones(F, bool), jnp.asarray(num_bins),
        jnp.asarray(default_bins), jnp.asarray(np.arange(F) % 3, jnp.int32),
        jgrow.SplitParams(min_data_in_leaf=10), max_leaves=15, max_bin=B,
        hist_impl="scatter")
    host = dict(jgrow.fetch_tree_arrays(tree)._asdict())
    N = len(host["missing_type"])
    if case == "random_missing":
        host["missing_type"] = rng.randint(0, 3, N).astype(np.int32)
        host["default_left"] = rng.rand(N) < 0.5
    if case == "single_leaf":
        host["num_leaves"] = np.int32(1)
    nl = int(host["num_leaves"])
    assert case == "single_leaf" or nl == 15
    want = np.asarray(jgrow.predict_leaf_inner(
        jnp.asarray(bins), jgrow.TreeArrays(**{k: jnp.asarray(v)
                                               for k, v in host.items()}),
        jnp.asarray(num_bins), jnp.asarray(default_bins)))
    tt = interop.tree_arrays_from_numpy(host, device="cpu")
    # no depth: the walk runs until every row rests at a leaf, as JAX's
    got = tgrow.predict_leaf_inner(torch.from_numpy(bins), tt,
                                   torch.from_numpy(num_bins),
                                   torch.from_numpy(default_bins))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------------- #
ROUNDS = 3
PARAMS = {"num_leaves": 15, "learning_rate": 0.2, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}
BAG = {"bagging_fraction": 0.8, "bagging_freq": 1}
CASES = {
    "bagged_binary_f32": dict(BAG, objective="binary"),
    "bagged_binary_quantized": dict(BAG, objective="binary",
                                    tpu_quantized_grad=True),
    "bagged_l2_f32": dict(BAG, objective="regression"),
    "bagged_freq2_l2_quantized": dict(BAG, objective="regression",
                                      bagging_freq=2, bagging_seed=5,
                                      tpu_quantized_grad=True),
}


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


def _task(params):
    return "binary" if params["objective"] == "binary" else "regression"


@pytest.fixture(scope="module")
def bagged():
    """Each case trained once in both packages, stepped with update() so
    the bag can be read after every tree."""
    out = {}
    for name, extra in CASES.items():
        params = dict(PARAMS, **extra)
        X, y = _data(_task(params), seed=2)
        jb = jlgb.Booster(params=dict(params, tpu_tree_engine="partition"),
                          train_set=jlgb.Dataset(X, y))
        tb = tlgb.Booster(params=params,
                          train_set=tlgb.Dataset(X, y, device="cpu"),
                          device="cpu")
        masks = []
        for _ in range(ROUNDS):
            jb.update()
            tb.update()
            masks.append((np.asarray(jb._gbdt._bag_mask),
                          tb._gbdt._bag_mask.copy(), tb._gbdt._bag_count))
        jb.predict(X[:1])                   # drains JAX's pending trees
        assert tb._gbdt._tree_fetches == 0  # the port's are pending too
        tb.num_trees()                      # and drain here
        out[name] = dict(X=X, jb=jb, tb=tb, masks=masks, params=params)
    return out


def _assert_models_match(jmodels, tmodels, X):
    """tests/test_torch_train.py's standard: equal split features, leaf
    counts and leaves of every row; thresholds equal except at exact ties
    (gains rtol 1e-5); leaf values rtol 1e-4."""
    assert len(tmodels) == len(jmodels)
    for a, b in zip(tmodels, jmodels):
        assert a.num_leaves == b.num_leaves > 1
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
        np.testing.assert_array_equal(a.internal_count[:k],
                                      b.internal_count[:k])


def _assert_scores_match(tg, jg):
    ts = tg.score.numpy()
    js = np.asarray(jg.train_state.score)[0]
    np.testing.assert_allclose(ts, js, rtol=0,
                               atol=1e-6 * float(np.abs(js).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bag_masks_match(bagged, name):
    c = bagged[name]
    n = len(c["X"])
    freq = c["params"]["bagging_freq"]
    for it, (want, got, count) in enumerate(c["masks"]):
        np.testing.assert_array_equal(got, want, err_msg="round %d" % it)
        assert count == int(0.8 * n) == int((got == 0).sum())
        if it % freq:                      # the bag persists between draws
            np.testing.assert_array_equal(got, c["masks"][it - 1][1])
    assert not np.array_equal(c["masks"][0][1], c["masks"][-1][1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_bagged_trees_and_scores_match(bagged, name):
    c = bagged[name]
    jg, tg = c["jb"]._gbdt, c["tb"]._gbdt
    assert not jg._carried_active and not tg._carried_active
    assert bool(jg._quantized) is tg._quantized
    _assert_models_match(jg.models, tg.models, c["X"])
    # a bagged tree's counts are in-bag counts
    for tree, (_, mask, _) in zip(tg.models, c["masks"]):
        assert tree.leaf_count[:tree.num_leaves].sum() == (mask == 0).sum()
    _assert_scores_match(tg, jg)
    np.testing.assert_allclose(c["tb"].predict(c["X"], raw_score=True),
                               c["jb"].predict(c["X"], raw_score=True),
                               rtol=1e-4, atol=1e-6)


VALID_PARAMS = dict(PARAMS, objective="binary", metric="binary_logloss,auc")


def _train_valid(lib, X, y, Xv, yv, **kw):
    ds = lib.Dataset(X, y, **kw)
    dv = lib.Dataset(Xv, yv, reference=ds, **kw)
    ev = {}
    extra = {} if kw else {"tpu_tree_engine": "partition"}
    dev = {"device": "cpu"} if kw else {}
    bst = lib.train(dict(VALID_PARAMS, **extra), ds, num_boost_round=6,
                    valid_sets=[ds, dv], valid_names=["train", "holdout"],
                    evals_result=ev, early_stopping_rounds=2,
                    verbose_eval=False, **dev)
    return bst, ev


def _holdout(X, seed):
    """300 of the training rows with labels of their own draw, which later
    trees do not help, so early stopping ends a run.  Holdout rows that are
    training rows land in the same leaves in both packages; other rows may
    not, since an f32 or quantized tie between two thresholds with no
    training row of the node between them may be broken either way."""
    rng = np.random.RandomState(seed)
    rows = np.sort(rng.choice(len(X), 300, replace=False))
    return X[rows], (rng.rand(300) < 0.5).astype(np.float64)


@pytest.fixture(scope="module")
def with_valid():
    X, y = _data("binary", seed=8)
    Xv, yv = _holdout(X, 9)
    jb, jev = _train_valid(jlgb, X, y, Xv, yv)
    tb, tev = _train_valid(tlgb, X, y, Xv, yv, device="cpu")
    return dict(X=X, jb=jb, jev=jev, tb=tb, tev=tev)


def test_valid_set_run_matches_jax(with_valid):
    """A validation set and a training metric move both packages to the
    eager path at the pristine root; the metrics, early stopping and
    trees agree."""
    c = with_valid
    jg, tg = c["jb"]._gbdt, c["tb"]._gbdt
    assert not jg._carried_active and not tg._carried_active
    assert c["tb"].best_iteration == c["jb"].best_iteration
    assert sorted(c["tev"]) == sorted(c["jev"]) == ["holdout", "train"]
    for ds in c["jev"]:
        assert sorted(c["tev"][ds]) == sorted(c["jev"][ds])
        for metric, want in c["jev"][ds].items():
            np.testing.assert_allclose(c["tev"][ds][metric], want, rtol=0,
                                       atol=1e-6)
    _assert_models_match(jg.models, tg.models, c["X"])
    _assert_scores_match(tg, jg)


def test_early_stopping_stops_and_records_best(with_valid):
    c = with_valid
    tb, tev = c["tb"], c["tev"]
    auc = tev["holdout"]["auc"]
    best = tb.best_iteration
    loss = tev["holdout"]["binary_logloss"]
    assert 1 <= best < len(loss) == tb.num_trees() < 6
    assert len(loss) - best == 2              # early_stopping_rounds
    assert tb.best_score["holdout"]["binary_logloss"] == min(loss) \
        == loss[best - 1]


def test_add_valid_mid_training_leaves_carried_arena():
    """A carried round, then a validation set: both packages leave the
    carried arena for good, grow the same later trees (quantized under the
    eager path's unfolded key, noise in row order) and report the same
    validation metrics.  Quantized, so that the leaf values, and with them
    the training scores, agree within 1e-6 of the scores' scale: f32 leaf
    values agree only to the reassociation of their histogram sums, which
    on other inputs moved a score by 1.5e-6 in three rounds."""
    X, y = _data("binary")
    Xv, yv = _holdout(X, 12)
    params = dict(PARAMS, objective="binary", metric="binary_logloss",
                  tpu_quantized_grad=True)
    jds = jlgb.Dataset(X, y)
    tds = tlgb.Dataset(X, y, device="cpu")
    jb = jlgb.Booster(params=dict(params, tpu_tree_engine="partition"),
                      train_set=jds)
    tb = tlgb.Booster(params=params, train_set=tds, device="cpu")
    jb.update()
    tb.update()
    assert jb._gbdt._carried_active and tb._gbdt._carried_active
    jb.add_valid(jlgb.Dataset(Xv, yv, reference=jds), "holdout")
    tb.add_valid(tlgb.Dataset(Xv, yv, reference=tds, device="cpu"),
                 "holdout")
    evals = []
    for _ in range(2):
        jb.update()
        tb.update()
        assert jb._gbdt._carried_active is False
        assert tb._gbdt._carried_active is False
        evals.append((jb.eval_valid(), tb.eval_valid()))
    for je, te in evals:
        assert [e[:2] for e in te] == [e[:2] for e in je]
        np.testing.assert_allclose([e[2] for e in te], [e[2] for e in je],
                                   rtol=0, atol=1e-6)
    jb.predict(X[:1])
    _assert_models_match(jb._gbdt.models, tb._gbdt.models, X)
    _assert_scores_match(tb._gbdt, jb._gbdt)


def test_valid_set_without_reference_is_binned_as_jax():
    """A validation Dataset given no reference: both packages bin it on its
    own mappers (the JAX package's add_valid sets no reference), so its bin
    matrix is equal bit for bit, and so are three rounds of its metrics.
    Its own mappers cut other bins than the training set's, so its rows land
    in other leaves than under `reference=`; the two packages still agree."""
    X, y = _data("binary", seed=8)
    rng = np.random.RandomState(21)
    Xv = X[np.sort(rng.choice(len(X), 300, replace=False))] * 1.5
    yv = (rng.rand(300) < 0.5).astype(np.float64)
    params = dict(VALID_PARAMS, metric="binary_logloss")
    out = {}
    for lib, kw, extra in ((jlgb, {}, {"tpu_tree_engine": "partition"}),
                           (tlgb, {"device": "cpu"}, {})):
        ds = lib.Dataset(X, y, **kw)
        dv = lib.Dataset(Xv, yv, **kw)
        ev = {}
        bst = lib.train(dict(params, **extra), ds, num_boost_round=ROUNDS,
                        valid_sets=[dv], valid_names=["holdout"],
                        evals_result=ev, verbose_eval=False,
                        **({"device": "cpu"} if kw else {}))
        assert dv.reference is None
        out[lib.__name__] = (bst, dv, ev)
    (jb, jv, jev), (tb, tv, tev) = out["lightgbm_tpu"], out["lightgbm_tpu_torch"]
    np.testing.assert_array_equal(tv._binned.bins, np.asarray(jv._binned.bins))
    ref = tlgb.Dataset(Xv, yv, reference=tlgb.Dataset(X, y, device="cpu"),
                       device="cpu").construct()
    assert not np.array_equal(ref._binned.bins, tv._binned.bins)
    loss = tev["holdout"]["binary_logloss"]
    assert len(loss) == ROUNDS
    np.testing.assert_allclose(loss, jev["holdout"]["binary_logloss"], rtol=0,
                               atol=1e-6)
    _assert_models_match(jb._gbdt.models, tb._gbdt.models, X)


def _logloss(y, p):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def test_valid_set_without_reference_warns_and_parts_from_predict():
    """A validation set given no reference: add_valid warns, once, through
    the port's logger, and the set's walked metric (its evals_result: the
    trees' training bin thresholds over its own bins) stands beside the
    metric of Booster.predict on the same rows.  On this seeded case the
    two bin matrices differ and so do the two metrics; with reference= the
    two agree and nothing is warned."""
    from lightgbm_tpu_torch.utils import log as tlog
    X, y = _data("binary", seed=8)
    rng = np.random.RandomState(21)
    Xv = X[np.sort(rng.choice(len(X), 300, replace=False))] * 1.5
    yv = (rng.rand(300) < 0.5).astype(np.float64)
    ds = tlgb.Dataset(X, y, device="cpu")
    out = {}
    for ref in (None, ds):
        lines = []
        tlog.set_callback(lines.append)
        try:
            ev = {}
            bst = tlgb.train(dict(VALID_PARAMS, metric="binary_logloss"), ds,
                             num_boost_round=ROUNDS,
                             valid_sets=[tlgb.Dataset(Xv, yv, reference=ref,
                                                      device="cpu")],
                             valid_names=["holdout"], evals_result=ev,
                             verbose_eval=False, device="cpu")
        finally:
            tlog.set_callback(None)
        walked = ev["holdout"]["binary_logloss"][-1]
        out[ref is None] = (walked, _logloss(yv, bst.predict(Xv)),
                            [ln for ln in lines if "no reference" in ln])
    walked, predicted, warned = out[True]
    assert len(warned) == 1 and "'holdout'" in warned[0]
    assert abs(walked - predicted) > 1e-3, (walked, predicted)
    walked, predicted, warned = out[False]
    assert not warned
    assert abs(walked - predicted) <= 1e-6, (walked, predicted)


# --------------------------------------------------------------------------- #
# the copied callback module
# --------------------------------------------------------------------------- #
def test_callback_copy_is_verbatim():
    """lightgbm_tpu_torch/callback.py holds lines 1-69 and 150-266 of the
    JAX package's callback.py unchanged, after its provenance comment: all
    but the telemetry, checkpoint and preemption callbacks, so
    reset_parameter is the JAX package's, a callback run before each
    round."""
    def lines(path):
        with open(os.path.join(REPO, path)) as f:
            return f.read().splitlines()
    src = lines("lightgbm_tpu/callback.py")
    port = lines("lightgbm_tpu_torch/callback.py")
    assert port[0].startswith("# Copied from lightgbm_tpu/callback.py, "
                              "lines 1-69 and 150-266")
    body = port[next(i for i, s in enumerate(port) if not s.startswith("#")):]
    assert body[:69] == src[:69]
    assert body[69:71] == ["", ""]
    assert body[71:] == src[149:266]
    cb = tlgb.callback.reset_parameter(learning_rate=[0.1])
    assert cb.before_iteration and cb.order == 10
