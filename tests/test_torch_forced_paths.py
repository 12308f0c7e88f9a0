"""Forced splits on the port's other paths against the JAX package, on the
CPU (helpers and tolerances: tests/test_torch_forced.py):

- the carried arena (tests/test_carried_arena.py:99's plan), where the
  port's partition engine roots each tree at the carried slot;
- an EFB dataset, the plan on a bundled feature, whose forced candidate
  unbundles the group histogram;
- a plan on a feature the dataset drops (constant): a warning, the entry
  skipped with its subtree.
"""
import numpy as np
import pytest

from test_torch_forced import BASE, ENGINES, _plan_file, _train_both
from test_torch_label import _data


def test_carried_arena_serves_the_plan(tmp_path):
    """tests/test_carried_arena.py:99's plan on the port's carried arena:
    the root split forced in every tree, the trees JAX's."""
    rng = np.random.RandomState(1)
    X = rng.randn(1200, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(1200) > 0
         ).astype(np.float64)
    fs = _plan_file(tmp_path, {"feature": 0, "threshold": 0.0,
                               "left": {"feature": 1, "threshold": 0.0}})
    params = dict(BASE, tpu_tree_engine="partition",
                  forcedsplits_filename=fs)
    jb, tb = _train_both(X, y, params, 4)
    assert tb._gbdt._carried_active
    for t in tb._gbdt.models:
        assert t.split_feature[0] == 0 and t.split_feature[t.left_child[0]] == 1


@pytest.mark.parametrize("engine", ENGINES)
def test_plan_on_bundled_feature(engine, tmp_path):
    """One-hot columns bundle into EFB groups; the plan splits a bundled
    one-hot column, then a numerical one."""
    rng = np.random.RandomState(3)
    n = 1500
    num = rng.randn(n, 2)
    cats = rng.randint(0, 4, (n, 2))
    onehot = np.zeros((n, 8))
    onehot[np.arange(n)[:, None], cats + np.arange(2) * 4] = 1.0
    X = np.column_stack([num, onehot])
    y = (num[:, 0] + (cats[:, 0] == 1) + 0.3 * rng.randn(n) > 0.5
         ).astype(np.float64)
    fs = _plan_file(tmp_path, {"feature": 4, "threshold": 0.0,
                               "right": {"feature": 1, "threshold": 0.0}})
    params = dict(BASE, tpu_tree_engine=engine, forcedsplits_filename=fs)
    jb, tb = _train_both(X, y, params, 2)
    assert tb._gbdt.bundle is not None
    for t in tb._gbdt.models:
        assert t.split_feature[0] == 4
        assert t.split_feature[t.right_child[0]] == 1


def test_unused_feature_is_skipped_with_a_warning(tmp_path):
    from lightgbm_tpu_torch.utils import log as tlog
    X, y = _data(2, n=1500)
    X[:, 1] = 1.0                      # constant: not a used feature
    fs = _plan_file(tmp_path, {"feature": 1, "threshold": 0.5,
                               "left": {"feature": 2, "threshold": 0.0}})
    params = dict(BASE, tpu_tree_engine="label", forcedsplits_filename=fs)
    lines = []
    tlog.set_callback(lines.append)
    try:
        jb, tb = _train_both(X, y, params, 2)
    finally:
        tlog.set_callback(None)
    assert any("forced split on unused feature 1 skipped" in s
               for s in lines)
    # the entry is skipped with its subtree (its children are never
    # queued), so no split is forced
    assert tb._gbdt._forced_splits == jb._gbdt._forced_splits == ()
