"""Histogram pooling (`histogram_pool_size`) on the port's partition
engine, on the CPU.

The pooled cache keeps K < max_leaves slots, written least recently first;
a split whose parent has no slot recomputes the parent's histogram with K2
over its arena segment before K3 partitions it
(lightgbm_tpu/ops/grow_partition.py:577-590, :687-790).

- grower level (JAX's `test_hist_pool_spill_matches_dense`): 4 slots
  against one a leaf, 15 leaves, f32 and quantized, on seeds 0 and 3: the
  same tree (split features, thresholds and counts equal, every row in the
  same leaf), with some but not all splits missing the pool.  A
  recomputed parent is a direct sum (f32, or exact code sums dequantized)
  where the dense cache holds a difference of two rounded sums, as in the
  JAX package, whose own pooled quantized trees part from its dense ones
  in the last bits; so the reals agree to rtol 1e-5 and atol 1e-6 (JAX's
  own test holds them to rtol 1e-4);
- Booster level (JAX's `test_hist_pool_booster_wide`): 40 features, a
  pool of about 6 histograms, 3 rounds of 15 leaves, against the JAX
  package with the same pool, f32 and quantized: the same slot count,
  the same trees (tests/test_torch_label.py's `_assert_trees_match`:
  split features, counts and leaves equal, thresholds equal but at exact
  ties, leaf values rtol 1e-4) and accuracy above 0.8.  JAX's own case
  (1,500 rows, 31 leaves, labels X0 > 0) ends its trees in leaves whose
  gains are rounding noise, where the packages part with or without a
  pool; seed 11 here, 3,000 noisy rows, has no such leaf;
- the port's pooled quantized Booster against its dense one, 3 rounds:
  the same trees (split features, thresholds and counts, every row in the
  same leaf), leaf values within rtol 1e-5, with some but not all splits
  missing the pool (`_pool_misses`, counted on the device);
- forced splits turn pooling off with JAX's warning.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops.grow_partition import grow_tree_partition
from lightgbm_tpu_torch.ops.split import SplitParams

from test_torch_label import _assert_trees_match


def _grow(bins, grad, hess, slots, quantized, misses=None):
    n, F = bins.shape
    arena = pk.Arena(n, F, 8, "cpu", quantized=quantized)
    pk.init_pristine(arena, torch.from_numpy(np.ascontiguousarray(bins.T)))
    g, h = torch.from_numpy(grad), torch.from_numpy(hess)
    kw = {}
    if quantized:
        g, h, gs, hs = tq.quantize_gradients(g, h, tq.quantize_key(7, 0))
        kw["quant_scales"] = (gs, hs)
    nb = torch.full((F,), 48, dtype=torch.int32)
    z = torch.zeros(F, dtype=torch.int32)
    tree, leaf_ids, _ = grow_tree_partition(
        arena, g, h, torch.ones(F, dtype=torch.bool), nb, z, z,
        SplitParams(min_data_in_leaf=10), max_leaves=15, max_bin=48,
        hist_slots=slots, pool_misses=misses, **kw)
    return tree, leaf_ids.numpy()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("quantized", [False, True])
def test_pooled_tree_equals_dense(quantized, seed):
    rng = np.random.RandomState(seed)
    n, F = 2500, 6
    bins = rng.randint(0, 48, (n, F)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    misses = torch.zeros(1, dtype=torch.long)
    t0, l0 = _grow(bins, grad, hess, 0, quantized)
    t1, l1 = _grow(bins, grad, hess, 4, quantized, misses)
    assert int(t0.num_leaves) == int(t1.num_leaves) == 15
    assert 0 < int(misses) < 14
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "leaf_count",
                 "internal_count", "leaf_parent", "leaf_depth"):
        np.testing.assert_array_equal(getattr(t0, name).numpy(),
                                      getattr(t1, name).numpy(), name)
    for name in ("leaf_value", "internal_value", "split_gain"):
        np.testing.assert_allclose(getattr(t1, name).numpy(),
                                   getattr(t0, name).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(l0, l1)


def _wide_data():
    rng = np.random.RandomState(11)
    n, F = 3000, 40
    X = rng.randn(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.randn(n) > 0
         ).astype(np.float64)
    return X, y


# about six [40, 63, 3] f32 histograms: slots spill every split
POOL_MB = 40 * 63 * 3 * 4 * 6 / (1 << 20)


@pytest.mark.parametrize("quantized", [False, True])
def test_pooled_booster_matches_jax(quantized):
    X, y = _wide_data()
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "tpu_tree_engine": "partition",
              "tpu_quantized_grad": quantized,
              "histogram_pool_size": POOL_MB}
    jb = jlgb.train(params, jlgb.Dataset(X, y), num_boost_round=3)
    tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                    num_boost_round=3, device="cpu")
    g = tb._gbdt
    assert g._use_partition_engine and g._quantized is quantized
    assert g._hist_slots == jb._gbdt._hist_slots
    assert 0 < g._hist_slots < 15
    assert tb.num_trees() == 3
    _assert_trees_match(jb._gbdt.models, g.models, X, [None] * 3)
    assert np.mean((tb.predict(X) > 0.5) == y) > 0.8


def test_pooled_quantized_booster_matches_dense():
    X, y = _wide_data()
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "tpu_tree_engine": "partition",
              "tpu_quantized_grad": True}
    dense, pooled = (
        tlgb.train(p, tlgb.Dataset(X, y, device="cpu"), num_boost_round=3,
                   device="cpu")
        for p in (params, dict(params, histogram_pool_size=POOL_MB)))
    g = pooled._gbdt
    assert 0 < g._hist_slots < 15 and dense._gbdt._hist_slots == 0
    splits = sum(t.num_leaves - 1 for t in g.models)
    assert 0 < int(g._pool_misses) < splits
    for a, b in zip(g.models, dense._gbdt.models):
        k = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
        np.testing.assert_array_equal(a.threshold_in_bin[:k],
                                      b.threshold_in_bin[:k])
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        np.testing.assert_allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                                   rtol=1e-5)


def test_forced_splits_disable_pooling(tmp_path):
    from lightgbm_tpu_torch.utils import log as tlog
    X, y = _wide_data()
    fs = tmp_path / "forced.json"
    fs.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "tpu_tree_engine": "partition",
              "forcedsplits_filename": str(fs),
              "histogram_pool_size": POOL_MB}
    lines = []
    tlog.set_callback(lines.append)
    try:
        tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                        num_boost_round=1, device="cpu")
    finally:
        tlog.set_callback(None)
    assert any("forced splits disable histogram pooling" in s for s in lines)
    assert tb._gbdt._hist_slots == 0
    assert tb._gbdt.models[0].split_feature[0] == 0
