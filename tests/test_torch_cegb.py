"""CEGB (cost-effective gradient boosting) in the port against the JAX
package, on the CPU, on both tree engines.

- `cegb_penalty_split` shifts every gain down by the penalty times the
  leaf's count: a prohibitive one stops growth at the first tree, as in
  JAX (tests/test_model_io_extras.py `test_cegb_split_penalty_prunes`);
  a small one changes the trees as JAX's does;
- `cegb_penalty_feature_coupled`: a huge penalty on the one informative
  feature keeps every tree off it (JAX's
  `test_cegb_coupled_feature_penalty`); a moderate one across trees and
  drains is tests/test_torch_cegb_drains.py's;
- `cegb_penalty_feature_lazy` warns through the port's logger and is
  ignored, as in JAX.

Trees are held as tests/test_torch_label.py holds them (`_assert_trees_match`:
split features, counts and every row's leaf equal; thresholds equal but at
exact ties; leaf values rtol 1e-4); the port's partition engine runs the
carried arena, JAX's the eager path (it fetches every CEGB tree in its
round), whose trees are the same.  Seed 2 of `_data` has no exact tie.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_label import PARAMS, _assert_trees_match, _data

ENGINES = ("label", "partition")
COUPLED = [0.0, 8.0, 0.0, 8.0, 0.0, 8.0, 0.0, 8.0]


def _train_both(X, y, params, rounds):
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=rounds, device="cpu")
    assert tb._gbdt._use_partition_engine is (
        params["tpu_tree_engine"] == "partition")
    return jb, tb


def _used_features(models):
    used = set()
    for t in models:
        used.update(int(f) for f in t.split_feature[:t.num_leaves - 1])
    return used


@pytest.mark.parametrize("engine", ENGINES)
def test_split_penalty_matches_jax(engine):
    """A prohibitive split penalty grows no tree past the first, a small
    one grows JAX's trees."""
    X, y = _data(2)
    base = dict(PARAMS, objective="binary", tpu_tree_engine=engine)
    jb, tb = _train_both(X, y, dict(base, cegb_penalty_split=1e6), 3)
    assert tb.num_trees() == jb.num_trees() <= 1
    jb, tb = _train_both(X, y, dict(base, cegb_penalty_split=0.002), 3)
    assert tb.num_trees() == jb.num_trees() == 3
    _assert_trees_match(jb._gbdt.models, tb._gbdt.models, X, [None] * 3)
    plain = tlgb.train(base, tlgb.Dataset(X, y, device="cpu"),
                       num_boost_round=3, device="cpu")
    assert plain.model_to_string() != tb.model_to_string()


@pytest.mark.parametrize("engine", ENGINES)
def test_coupled_penalty_avoids_informative_feature(engine):
    """JAX's case: only feature 2 is informative and carries a 1e9
    coupled penalty; no tree of either package splits on it."""
    rng = np.random.RandomState(4)
    X = rng.randn(600, 4)
    y = (X[:, 2] > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
              "verbose": -1, "tpu_tree_engine": engine,
              "cegb_penalty_feature_coupled": [0.0, 0.0, 1e9, 0.0]}
    jb, tb = _train_both(X, y, params, 2)
    assert 2 not in _used_features(tb._gbdt.models)
    _assert_trees_match(jb._gbdt.models, tb._gbdt.models, X, [None] * 2)


def test_lazy_penalty_warns_and_is_ignored():
    from lightgbm_tpu_torch.utils import log as tlog
    X, y = _data(2, n=800)
    params = dict(PARAMS, objective="binary")
    lines = []
    tlog.set_callback(lines.append)
    try:
        lazy = tlgb.train(dict(params, cegb_penalty_feature_lazy=[1.0] * 8),
                          tlgb.Dataset(X, y, device="cpu"),
                          num_boost_round=2, device="cpu")
    finally:
        tlog.set_callback(None)
    assert any("cegb_penalty_feature_lazy" in s and "ignoring" in s
               for s in lines)
    plain = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                       num_boost_round=2, device="cpu")
    assert lazy.model_to_string() == plain.model_to_string()
