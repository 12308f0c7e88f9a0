"""Forced splits (`forcedsplits_filename`) in the port against the JAX
package, on the CPU, on both tree engines.

The carried arena, an EFB dataset and a plan on a dropped feature are
tests/test_torch_forced_paths.py's.  The plan is the file's BFS list of (leaf, feature, threshold bin,
default left) entries, mapped on the host by each feature's BinMapper;
each entry injects a +inf-gain row into its leaf's split cache before the
best-first steps (lightgbm_tpu/ops/grow.py:641-685,
grow_partition.py:876-915).  The cases:

- a two-level plan (JAX's `test_forced_splits` file: feature 3 at the
  root, feature 2 on its left child; here feature 3 has zeros and feature
  2 NaNs) on both engines: every tree's first splits follow the plan, and
  the trees equal JAX's;
- a plan with an entry that cannot apply (a threshold past every row, so
  one child is empty): that entry and its subtree are dropped, the
  others apply, as in JAX.

Trees are held as tests/test_torch_label.py holds them
(`_assert_trees_match`: split features, counts and every row's leaf
equal; thresholds equal but at exact ties; leaf values rtol 1e-4).  The
data are tests/test_torch_label.py's (seed 2, noisy labels) or seeded
Gaussian rows with noise: with no exact tie, and no leaf so pure that its
gains are rounding noise (JAX's own forced-split file, labels X0 > 0,
leaves such leaves, whose 1e-5 gains the two packages' f32 sums order
differently).
"""
import json

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_label import _assert_trees_match, _data

ENGINES = ("label", "partition")
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "verbose": -1}


def _plan_file(tmp_path, plan):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(plan))
    return str(path)


def _train_both(X, y, params, rounds):
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=rounds, device="cpu")
    assert tb._gbdt._use_partition_engine is (
        params["tpu_tree_engine"] == "partition")
    _assert_trees_match(jb._gbdt.models, tb._gbdt.models, X,
                        [None] * tb.num_trees())
    return jb, tb


@pytest.mark.parametrize("engine", ENGINES)
def test_two_level_plan_matches_jax(engine, tmp_path):
    X, y = _data(2, n=1500)
    fs = _plan_file(tmp_path, {"feature": 3, "threshold": 0.0,
                               "left": {"feature": 2, "threshold": 0.0}})
    params = dict(BASE, tpu_tree_engine=engine, forcedsplits_filename=fs)
    jb, tb = _train_both(X, y, params, 2)
    g = tb._gbdt
    assert g._forced_splits == jb._gbdt._forced_splits
    assert [e[1] for e in g._forced_splits] == [3, 2]
    for t in g.models:
        assert t.split_feature[0] == 3 and abs(t.threshold[0]) < 0.5
        assert t.split_feature[t.left_child[0]] == 2
    pred = tb.predict(X)
    assert np.mean((pred > 0.5) == y) > 0.75


@pytest.mark.parametrize("engine", ENGINES)
def test_entry_that_cannot_apply_drops_its_subtree(engine, tmp_path):
    """The root's left entry splits feature 0 (no missing value) past its
    largest value (an empty right child): it and the entry below it are
    dropped; the root and its right entry apply."""
    X, y = _data(2, n=1500)
    fs = _plan_file(tmp_path, {
        "feature": 3, "threshold": 0.0,
        "left": {"feature": 0, "threshold": 1e6,
                 "left": {"feature": 1, "threshold": 0.0}},
        "right": {"feature": 1, "threshold": 0.5}})
    params = dict(BASE, tpu_tree_engine=engine, forcedsplits_filename=fs)
    jb, tb = _train_both(X, y, params, 2)
    assert len(tb._gbdt._forced_splits) == 4
    for t in tb._gbdt.models:
        assert t.split_feature[0] == 3
        assert t.split_feature[t.right_child[0]] == 1
        left = t.left_child[0]
        # the best-first split of the root's left child, not the plan's
        assert left >= 0 and not (t.split_feature[left] == 0
                                  and t.threshold[left] > 1e5)
