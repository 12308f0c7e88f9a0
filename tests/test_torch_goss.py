"""GOSS in the port against the JAX package, on the CPU (its Pallas kernels
in interpret mode, the engine forced by `tpu_tree_engine`).

- `threefry.split` equals `jax.random.split`, bit for bit, over several
  keys and counts;
- the device sample (`models/goss.goss_sample`) equals
  `lightgbm_tpu.models.goss._goss_sample` on the same numpy gradients and
  key: the in-sample rows and the amplified gradients and hessians, bit
  for bit, for one class and for three;
- the selection of the other rows is XLA's `top_k(-u, other_k)` where u
  holds a run of equal values across the other_k boundary: the lower rows
  of the run are taken (a stable ascending sort), and the ties of the
  score at the top_k boundary are all kept;
- training, 5 rounds at learning_rate 0.5 (2 warm-up rounds, 3 sampled):
  f32 and quantized on the partition engine, f32 on the label engine.  The
  sample is equal every round; the trees split on the same features, put
  every row in the same leaf (the seeds hold no exact tie between two
  thresholds with no in-sample row between them, which would send rows out
  of the sample another way: ROADMAP.md queue 3) and count the same rows;
  leaf values agree within f32 tolerance (rtol 1e-4, atol 1e-4 of the
  tree's largest value), predictions within tests/test_torch_bagging.py's
  rtol 1e-4, atol 1e-6;
- the fatal configurations raise in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models.goss import _goss_sample
from lightgbm_tpu.utils.log import LightGBMError as JaxError
from lightgbm_tpu_torch.utils.log import LightGBMError
from lightgbm_tpu_torch.models.goss import goss_sample, goss_select
from lightgbm_tpu_torch.ops import threefry

# The JAX package draws GOSS's uniform u in the default float type
# (lightgbm_tpu/models/goss.py:26), which the tests' conftest makes f64 by
# turning x64 on; it runs with x64 off, u in f32, and so does the port.
# The JAX side of these tests runs so.


def PRODUCTION():
    return jax.enable_x64(False)


PARAMS = {"num_leaves": 15, "learning_rate": 0.5, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}
ROUNDS = 5


def data(task, n=2000, F=8, seed=7):
    """tests/test_torch_bagging.py's generator (a NaN-bearing column, zeros,
    a column of few values), with three classes cut from its score."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[rng.rand(n) < 0.03, 3] = 0.0
    X[:, 4] = np.round(X[:, 4] * 2)
    score = X[:, 0] + 0.7 * np.sin(2 * X[:, 1]) * X[:, 5] + 0.3 * X[:, 6]
    score = score + 0.5 * rng.randn(n)
    if task == "multiclass":
        return X, np.digitize(score, [-0.6, 0.6]).astype(np.float64)
    return X, (score > 0).astype(np.float64) if task == "binary" else score


def train_both(params, task, seed, rounds=ROUNDS, sample=None):
    """Both packages' boosters stepped with update(), JAX's with x64 off
    (`PRODUCTION`); `sample(jax booster, port booster)` gives each round's
    in-sample rows (bool [n], checked equal in both) or None for every row.
    Returns X, the boosters and the rounds' samples."""
    X, y = data(task, seed=seed)
    with PRODUCTION():
        jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, y))
    tb = tlgb.Booster(params=params, train_set=tlgb.Dataset(X, y,
                                                           device="cpu"),
                      device="cpu")
    samples = []
    for _ in range(rounds):
        with PRODUCTION():
            jb.update()
        tb.update()
        samples.append(None if sample is None else sample(jb, tb))
    with PRODUCTION():
        jb.predict(X[:1])               # drains JAX's pending trees
    tb.num_trees()                      # and the port's
    return X, jb, tb, samples


def assert_trees_match(jmodels, tmodels, X, samples, k=1):
    """Equal split features, every row in the same leaf (the in-sample rows
    always; the others wherever the thresholds are equal), equal leaf and
    node counts, leaf values within f32 tolerance.  samples: one entry an
    iteration of k trees."""
    assert len(tmodels) == len(jmodels) == k * len(samples)
    for t, (a, b) in enumerate(zip(tmodels, jmodels)):
        assert a.num_leaves == b.num_leaves > 1
        n = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:n], b.split_feature[:n])
        la, lb = a.predict_leaf_index(X), b.predict_leaf_index(X)
        in_sample = samples[t // k]
        if in_sample is None:
            in_sample = np.ones(len(X), bool)
        np.testing.assert_array_equal(la[in_sample], lb[in_sample])
        same = a.threshold_in_bin[:n] == b.threshold_in_bin[:n]
        assert np.array_equal(la, lb) or not same.all()
        np.testing.assert_array_equal(la, lb)
        scale = float(np.abs(b.leaf_value[:n + 1]).max())
        np.testing.assert_allclose(a.leaf_value[:n + 1], b.leaf_value[:n + 1],
                                   rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_array_equal(a.leaf_count[:n + 1],
                                      b.leaf_count[:n + 1])
        np.testing.assert_array_equal(a.internal_count[:n],
                                      b.internal_count[:n])


def assert_predictions_match(X, jb, tb):
    with PRODUCTION():
        want = jb.predict(X, raw_score=True)
    np.testing.assert_allclose(tb.predict(X, raw_score=True), want,
                               rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------- #
# the key chain and the sample
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3, 77, 2 ** 31 + 5, 2 ** 32 - 1])
def test_split_matches_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = threefry.PRNGKey(seed)
    for num in (2, 2, 3, 5):
        want = np.asarray(jax.random.split(jkey, num)).tolist()
        got = threefry.split(tkey, num)
        assert [list(k) for k in got] == want
        jkey, tkey = jax.random.split(jkey)[0], got[0]


@pytest.mark.parametrize("k", [1, 3])
def test_goss_sample_matches_jax(k):
    rng = np.random.RandomState(k)
    n, top_k, other_k = 3000, 600, 300
    g = rng.randn(k, n).astype(np.float32)
    h = (rng.rand(k, n) + 0.1).astype(np.float32)
    g[:, :50] = g[:, 50:100]              # equal scores, some at the top
    h[:, :50] = h[:, 50:100]
    multiply = (n - top_k) / other_k
    jkey, tkey = jax.random.PRNGKey(9), threefry.PRNGKey(9)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = threefry.split(tkey)
        with PRODUCTION():
            jg, jh, jmask = _goss_sample(
                jnp.asarray(g), jnp.asarray(h), jsub,
                jnp.asarray(multiply, jnp.float32), top_k=top_k,
                other_k=other_k)
        for key in (tsub, torch.tensor(tsub, dtype=torch.int64)):
            tg, th, pred = goss_sample(torch.from_numpy(g),
                                       torch.from_numpy(h), key, multiply,
                                       top_k, other_k)
            assert pred.dtype == torch.uint8
            np.testing.assert_array_equal(pred.numpy() == 1,
                                          np.asarray(jmask) == 0)
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert int(pred.sum()) >= top_k + other_k


def test_other_rows_ties_across_the_boundary_match_top_k():
    """u holds a run of 40 equal values across the other_k boundary: XLA's
    top_k(-u) takes the run's lower rows, and so does the port; three rows
    tie the score's top_k-th value, and all three are kept."""
    n, top_k, other_k = 200, 20, 30
    rng = np.random.RandomState(4)
    score = rng.rand(n).astype(np.float32) + 0.5
    score[[151, 161, 171]] = 2.0                # the top_k-th value, tied
    score[181:199] = 3.0
    u = rng.rand(n).astype(np.float32) * 0.5 + 0.5
    run = np.arange(10, 190, 4)[:40]
    u[run] = np.float32(0.25)
    u[[3, 7, 11, 15, 19]] = np.float32(0.1)     # five below the run
    is_top = score >= np.sort(score)[::-1][top_k - 1]
    assert is_top.sum() == top_k + 1
    assert not is_top[run].any() and (u < 0.25).sum() == 5
    u_in = np.where(is_top, np.float32(2.0), u)
    _, idx = jax.lax.top_k(-jnp.asarray(u_in), other_k)
    want_other = np.zeros(n, bool)
    want_other[np.asarray(idx)] = True
    # the boundary falls inside the run: 25 of its 40 rows, the lowest
    assert want_other[run].sum() == other_k - 5
    np.testing.assert_array_equal(np.flatnonzero(want_other[run]),
                                  np.arange(other_k - 5))
    g = torch.ones(1, n)
    tg, th, pred = goss_select(g, g.clone(), torch.from_numpy(score),
                               torch.from_numpy(u), 3.0, top_k, other_k)
    np.testing.assert_array_equal(pred.numpy() == 1, is_top | want_other)
    np.testing.assert_array_equal(tg[0].numpy(),
                                  np.where(want_other, 3.0, 1.0))


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
TRAIN_CASES = {
    "binary_f32": (dict(tpu_tree_engine="partition"), 2),
    "binary_quantized": (dict(tpu_tree_engine="partition",
                              tpu_quantized_grad=True), 2),
    "binary_label": (dict(tpu_tree_engine="label", top_rate=0.3,
                          other_rate=0.3), 1),
}


def _goss_rows(jb, tb):
    jm, tp = jb._gbdt._bag_mask, tb._gbdt._bag_pred
    assert (jm is None) == (tp is None)
    if jm is None:
        assert tb._gbdt._goss_counts is None
        return None
    want = np.asarray(jm) == 0
    np.testing.assert_array_equal(tp.numpy() == 1, want)
    top_k, other_k = tb._gbdt._goss_counts
    assert (top_k, other_k) == jb._gbdt._goss_counts
    assert want.sum() >= top_k + other_k
    return want


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_goss_training_matches_jax(name):
    extra, seed = TRAIN_CASES[name]
    params = dict(PARAMS, objective="binary", boosting="goss", **extra)
    X, jb, tb, samples = train_both(params, "binary", seed,
                                    sample=_goss_rows)
    tg, jg = tb._gbdt, jb._gbdt
    assert type(tg).__name__ == type(jg).__name__ == "GOSS"
    # 2 warm-up rounds of every row, then 3 sampled ones
    assert [s is None for s in samples] == [True, True, False, False, False]
    assert tg._quantized is bool(jg._quantized) is ("quantized" in name)
    assert tg._use_partition_engine is ("label" not in name)
    assert not tg._carried_active and tg._tree_fetches == 0
    assert_trees_match(jg.models, tg.models, X, samples)
    assert_predictions_match(X, jb, tb)
    np.testing.assert_allclose(tg.score.numpy(),
                               np.asarray(jg.train_state.score)[0], rtol=0,
                               atol=1e-5)


def test_goss_fatal_configurations_raise():
    X, y = data("binary", n=300)
    bagged = dict(PARAMS, objective="binary", boosting="goss",
                  bagging_fraction=0.8, bagging_freq=1)
    with pytest.raises(JaxError, match="bagging in GOSS"):
        jlgb.Booster(params=bagged, train_set=jlgb.Dataset(X, y))
    with pytest.raises(LightGBMError, match="bagging in GOSS"):
        tlgb.Booster(params=bagged,
                     train_set=tlgb.Dataset(X, y, device="cpu"), device="cpu")
    rates = dict(PARAMS, objective="binary", boosting="goss", top_rate=0.7,
                 other_rate=0.4)
    with pytest.raises(JaxError, match="top_rate"):
        jlgb.Booster(params=rates, train_set=jlgb.Dataset(X, y))
    with pytest.raises(LightGBMError, match="top_rate"):
        tlgb.Booster(params=rates,
                     train_set=tlgb.Dataset(X, y, device="cpu"), device="cpu")
