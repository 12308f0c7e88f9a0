"""uint16 bins (a column of more than 256 bins) in the port against the
JAX package, on the CPU.

A dataset whose largest feature or EFB group has more than 256 bins is
binned to uint16 (lightgbm_tpu/io/dataset.py:376-378, :396-397) and
trains on the label engine only, as in JAX; on the device the port holds
the bins as int16 storage of the same bytes.  Cases:

- the host bins equal JAX's bit for bit, and the device tensor holds
  their bytes: max_bin 511 on numerical columns, dense and with EFB
  bundles beside the wide column, and the airline layout with 300
  airports (Origin and Dest then have more than 256 categorical bins);
- label-engine training against JAX on both: the numerical trees as
  tests/test_torch_label.py holds them (`_assert_trees_match`), the
  categorical ones as tests/test_torch_categorical.py does
  (`assert_models_match`: the same model text, bin sets and leaves, at
  an exact tie the same partition with its children swapped);
- a validation set with the 300 airports, walked each round by KP2's
  plain version over uint16 bins and bin sets wider than 256 bits: its
  metrics equal JAX's (rtol 1e-6) and its score the booster's predict;
- KP2's plain walk of a trained 300-airport tree over the uint16 bins
  against JAX's `predict_leaf_inner`: every row's leaf equal;
- K7's plain version at B = 292 and 1023, f32 and f64, against a numpy
  oracle: counts exact, sums within f32 rounding (f64 within 1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu_torch.models.gbdt import _tree_to_device
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import histogram_kernel as hk

from test_torch_categorical import PARAMS as CAT_PARAMS
from test_torch_categorical import airline, assert_models_match
from test_torch_label import PARAMS, _assert_trees_match, _data

CATS = [0, 1, 2, 4, 5, 6]
AIRPORTS = 300


def _numeric(bundled):
    X, y = _data(2, n=3000)
    if bundled:
        rng = np.random.RandomState(9)
        codes = rng.randint(0, 4, (len(X), 2))
        onehot = np.zeros((len(X), 8))
        onehot[np.arange(len(X))[:, None], codes + np.arange(2) * 4] = 1.0
        X = np.column_stack([X, onehot])
        y = ((y > 0) ^ (codes[:, 0] == 1)).astype(np.float64)
    return X, y


DATA = {
    "dense_511": lambda: (_numeric(False), dict(PARAMS, max_bin=511), []),
    "bundled_511": lambda: (_numeric(True), dict(PARAMS, max_bin=511), []),
    "airports_300": lambda: (airline(6000, airports=AIRPORTS),
                             dict(CAT_PARAMS), CATS),
}


def _datasets(name):
    (X, y), params, cats = DATA[name]()
    params = dict(params, objective="binary", tpu_tree_engine="label")
    jd = jlgb.Dataset(X, y, categorical_feature=cats, params=params)
    td = tlgb.Dataset(X, y, categorical_feature=cats, params=params,
                      device="cpu")
    return X, y, params, jd, td


@pytest.mark.parametrize("name", sorted(DATA))
def test_bins_match_jax(name):
    X, y, params, jd, td = _datasets(name)
    jd.construct()
    tds = td.construct()._binned
    want = np.asarray(jd._binned.bins)
    got = tds.bins
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert (tds.bundle is not None) is (name == "bundled_511")
    dev = tds.device_bins("cpu")
    assert dev.dtype == torch.int16
    np.testing.assert_array_equal(dev.numpy().view(np.uint16), want)
    assert tds.hist_max_bin() > 256


@pytest.mark.parametrize("name", sorted(DATA))
def test_label_engine_matches_jax(name):
    X, y, params, jd, td = _datasets(name)
    jb = jlgb.train(params, jd, num_boost_round=3)
    tb = tlgb.train(params, td, num_boost_round=3, device="cpu")
    g = tb._gbdt
    assert not g._use_partition_engine and g.max_bin > 256
    assert g.max_bin == jb._gbdt.max_bin
    if name == "airports_300":
        assert_models_match(jb, tb, X)
        assert sum(t.num_cat for t in g.models) > 0
        return
    _assert_trees_match(jb._gbdt.models, g.models, X, [None] * 3)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)


def test_valid_set_walks_uint16_bins_and_wide_bin_sets():
    X, y = airline(6000, airports=AIRPORTS)
    Xv, yv = airline(1500, seed=12, airports=AIRPORTS)
    params = dict(CAT_PARAMS, objective="binary", tpu_tree_engine="label",
                  metric="auc")
    runs = {}
    for pkg, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = pkg.Dataset(X, y, categorical_feature=CATS, params=params, **kw)
        vs = pkg.Dataset(Xv, yv, reference=ds, **kw)
        ev = {}
        bst = pkg.train(params, ds, num_boost_round=4, valid_sets=[vs],
                        valid_names=["holdout"], evals_result=ev,
                        verbose_eval=False, **kw)
        runs[pkg.__name__] = (bst, ev)
    (jb, jev), (tb, tev) = runs["lightgbm_tpu"], runs["lightgbm_tpu_torch"]
    np.testing.assert_allclose(tev["holdout"]["auc"], jev["holdout"]["auc"],
                               rtol=1e-6)
    state = tb._gbdt.valid_states[0][1]
    assert state.bins.dtype == torch.int16
    assert max(t.num_cat for t in tb._gbdt.models) > 0
    np.testing.assert_allclose(state.score.numpy(),
                               tb.predict(Xv, raw_score=True), rtol=1e-6,
                               atol=1e-6)


def test_binned_walk_matches_jax_over_wide_bin_sets():
    X, y, params, jd, td = _datasets("airports_300")
    tb = tlgb.train(params, td, num_boost_round=2, device="cpu")
    g = tb._gbdt
    bins = g.train_set.device_bins("cpu")
    jbins = jnp.asarray(g.train_set.bins)
    for tree in g.models:
        arrays = _tree_to_device(tree, "cpu", g.max_bin)
        assert arrays.cat_mask.shape[1] == g.max_bin > 256
        got = tgrow.predict_leaf_inner(bins, arrays, g.num_bins,
                                       g.default_bins, g.bundle)
        want = jgrow.predict_leaf_inner(
            jbins, jgrow.TreeArrays(*(jnp.asarray(a.numpy())
                                      for a in arrays)),
            jnp.asarray(g.num_bins.numpy()),
            jnp.asarray(g.default_bins.numpy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(),
                                      tree.predict_leaf_index(X))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B", [292, 1023])
def test_k7_plain_wide_bins_matches_oracle(B, dtype):
    rng = np.random.RandomState(B)
    n, F = 5000, 5
    bins = rng.randint(0, B, (n, F)).astype(np.uint16)
    bins[:, 0] = np.minimum(bins[:, 0], 260)   # a column just past 256
    g = rng.randn(n).astype(dtype)
    h = (rng.rand(n) + 0.1).astype(dtype)
    ids = rng.randint(-1, 3, n).astype(np.int32)
    got = hk.leaf_histogram(torch.from_numpy(bins.view(np.int16)),
                            torch.from_numpy(g), torch.from_numpy(h),
                            torch.from_numpy(ids), 1, B).numpy()
    assert got.dtype == dtype and got.shape == (F, B, 3)
    want = np.zeros((F, B, 3))
    sel = ids == 1
    for f in range(F):
        b = bins[sel, f].astype(np.int64)
        want[f, :, 0] = np.bincount(b, g[sel].astype(np.float64), B)
        want[f, :, 1] = np.bincount(b, h[sel].astype(np.float64), B)
        want[f, :, 2] = np.bincount(b, minlength=B)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=tol,
                               atol=tol)
