"""EFB bundles in the port against the JAX package, on the CPU (its Pallas
kernels in interpret mode, `tpu_tree_engine=partition` unless a case asks
for the label engine):

- the layout (groups, each feature's group, lo, hi, shift, needs_fix, the
  groups' bin counts) and the bundled bins, bit for bit, on Covertype's
  one-hot layout (`onehot`: 10 numbers, 4 area and 40 soil one-hot
  columns), on mutually exclusive sparse columns and on a frame with
  NaNs; a validation set takes its reference's bundle and bins its rows
  as JAX does;
- `unbundle_hist` against lightgbm_tpu.ops.grow.unbundle_hist, and the
  bundle maps against lightgbm_tpu.models.gbdt._bundle_maps;
- KP2's plain walk (`predict_leaf_inner` with the maps) over group
  columns against lightgbm_tpu.ops.grow.predict_leaf_inner;
- training on the carried arena (tests/test_carried_arena.py:121's data:
  3 numbers and 18 one-hot columns), the model text equal to JAX's
  (tests/test_torch_inflight.assert_texts_match), every training row in
  JAX's leaf, raw predictions within 5e-6 of their scale; the label
  engine, a validation set and 3-class softmax at the one-hot layout in
  tests/test_torch_efb_paths.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as jlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.ops import grow as jgrow
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.ops import grow as tgrow

from test_torch_categorical import assert_models_match

ROUNDS = 3
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
          "min_data_in_leaf": 20, "verbose": -1}


def onehot(n=3000, seed=21, k=1):
    """Covertype's layout: 10 numbers, then the row's wilderness area and
    soil type as 4 and 40 one-hot columns; a binary label (k = 1) or k
    classes from the numbers, the area and a per-soil effect."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 54))
    X[:, :10] = rng.randn(n, 10)
    area = rng.randint(0, 4, n)
    soil = rng.choice(40, n, p=np.random.RandomState(3).dirichlet(
        np.full(40, 0.5)))
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    s = X[:, 0] + np.random.RandomState(7).randn(40)[soil] + 0.4 * area \
        + 0.6 * rng.randn(n)
    if k == 1:
        return X, (s > 0.5).astype(np.float64)
    return X, np.clip(np.floor(s + 1.5), 0, k - 1).astype(np.float64)


def carried_data(n=4000, seed=0):
    """tests/test_carried_arena.py:121's rows: 3 numbers and 6 groups of 3
    one-hot columns."""
    rng = np.random.RandomState(seed)
    num = rng.randn(n, 3).astype(np.float32)
    cats = rng.randint(0, 3, (n, 6))
    oh = np.zeros((n, 18), np.float32)
    oh[np.arange(n)[:, None], cats + np.arange(6) * 3] = 1.0
    X = np.column_stack([num, oh])
    y = (num[:, 0] + (cats[:, 0] == 1) + 0.3 * rng.randn(n) > 0.5
         ).astype(np.float32)
    return X, y


def sparse_nan(n=2000, seed=5):
    """Sparse columns with NaNs and negative values: defaults that are not
    bin 0, and a feature whose bundle range has a hole."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 10))
    owner = rng.randint(0, 10, n)
    X[np.arange(n), owner] = rng.randn(n) * 2
    X[rng.rand(n) < 0.02, 3] = np.nan
    X[:, 9] = rng.randn(n)
    return X, (owner % 3 == 0).astype(np.float64)


DATA = {"onehot": onehot, "carried": carried_data, "sparse_nan": sparse_nan}


@pytest.mark.parametrize("name", sorted(DATA))
def test_layout_and_bins_match_jax(name):
    X, y = DATA[name]()
    got = tlgb.Dataset(X, y, device="cpu").construct()._binned
    want = jlgb.Dataset(X, y).construct()._binned
    gb, wb = got.bundle, want.bundle
    assert gb is not None and gb.any_bundled
    assert gb.groups == wb.groups
    for field in ("feature_group", "feature_lo", "feature_hi",
                  "feature_shift", "needs_fix", "group_num_bins",
                  "feature_default"):
        np.testing.assert_array_equal(getattr(gb, field),
                                      getattr(wb, field), err_msg=field)
    assert got.bins.dtype == np.uint8
    np.testing.assert_array_equal(got.bins, np.asarray(want.bins))
    assert got.num_groups == gb.num_groups == got.bins.shape[1]
    assert got.hist_max_bin() == int(gb.group_num_bins.max())
    # a validation set takes the reference's bundle and bins as JAX does
    Xv, yv = DATA[name](n=700, seed=99)
    vt = tlgb.Dataset(Xv, yv, reference=tlgb.Dataset(X, y, device="cpu"),
                      device="cpu").construct()._binned
    vj = jlgb.Dataset(Xv, yv, reference=jlgb.Dataset(X, y)).construct()
    np.testing.assert_array_equal(vt.bins, np.asarray(vj._binned.bins))
    assert vt.bundle.groups == gb.groups


def test_unbundle_and_maps_match_jax():
    """Random group histograms of the one-hot layout unbundled to the
    features: equal to JAX's unbundle_hist within f32 rounding of the
    default bins' totals-less-sums, the gathers exact."""
    X, y = onehot()
    ds = tlgb.Dataset(X, y, device="cpu").construct()._binned
    jds = jlgb.Dataset(X, y).construct()._binned
    maps = tgbdt.bundle_maps(ds, "cpu")
    jmaps = jgbdt._bundle_maps(jds)
    for a, b in zip(maps, jmaps):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.RandomState(4)
    G, B = ds.num_groups, ds.hist_max_bin()
    db = torch.as_tensor([m.default_bin for m in ds.bin_mappers],
                         dtype=torch.int32)
    for _ in range(3):
        hist = rng.randn(G, B, 3).astype(np.float32)
        hist[..., 2] = rng.randint(0, 50, (G, B))
        sg, sh, sc = (float(hist[0, :, i].sum()) for i in range(3))
        got = tgrow.unbundle_hist(torch.from_numpy(hist), sg, sh, sc, maps,
                                  db).numpy()
        want = np.asarray(jgrow.unbundle_hist(
            jnp.asarray(hist), sg, sh, sc, jmaps, jnp.asarray(db.numpy())))
        assert got.shape == want.shape == (ds.num_features, B, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        fixed = np.zeros(got.shape[:2], bool)
        fixed[np.arange(ds.num_features), db.numpy()] = \
            ds.bundle.needs_fix
        np.testing.assert_array_equal(got[~fixed], want[~fixed])


_TRAINED = {}


def train_case(name):
    """(X, JAX booster, port booster) of the carried one-hot run."""
    if name not in _TRAINED:
        X, y = carried_data()
        jb = jlgb.train(dict(PARAMS, tpu_tree_engine="partition"),
                        jlgb.Dataset(X, y), ROUNDS)
        tb = tlgb.train(PARAMS, tlgb.Dataset(X, y, device="cpu"), ROUNDS,
                        device="cpu")
        _TRAINED[name] = (X, jb, tb)
    return _TRAINED[name]


def test_carried_arena_matches_jax():
    X, jb, tb = train_case("carried")
    g = tb._gbdt
    assert g._carried_active and g.bundle is not None
    assert g.arena.num_groups == g.train_set.num_groups < X.shape[1]
    assert jb._gbdt.train_state.bundle is not None
    assert_models_match(jb, tb, X)


def test_walk_over_group_columns_matches_jax():
    """KP2's plain version over the bundled bins: each trained tree walks
    every training row to JAX's predict_leaf_inner leaf (the same maps),
    and to the host walk's."""
    X, jb, tb = train_case("carried")
    g = tb._gbdt
    bins = g.train_set.device_bins("cpu")
    jmaps = jgbdt._bundle_maps(jb._gbdt.train_set)
    for tree in g.models:
        dt = tgbdt._tree_to_device(tree, "cpu", g.max_bin)
        got = tgrow.predict_leaf_inner(bins, dt, g.num_bins, g.default_bins,
                                       g.bundle).numpy()
        jt = jgrow.TreeArrays(**{k: jnp.asarray(v.numpy())
                                 for k, v in dt._asdict().items()})
        want = np.asarray(jgrow.predict_leaf_inner(
            jnp.asarray(bins.numpy()), jt, jnp.asarray(g.num_bins.numpy()),
            jnp.asarray(g.default_bins.numpy()), jmaps))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tree.predict_leaf_index(X))
