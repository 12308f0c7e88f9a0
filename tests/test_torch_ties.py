"""A quantized tree that parts from the JAX package's on the CPU, kept as
a strict expected failure (ROADMAP queue 3, "Exact split ties").

Quantized histograms are exact integers in both packages, and on
tests/test_torch_carried.py's data they give equal trees at 15 leaves.  At
127 leaves on 4000 rows the first tree splits on other features at a few
nodes and puts training rows in other leaves.  The histograms are not
where the packages part: the root's dequantized histogram is equal bit
for bit.  The JAX package runs its grower jitted under XLA on the CPU,
and three of XLA's arithmetic choices move near-ties between thresholds
by an ulp of the gain:
- the root's sums of g and h over the bins (lightgbm_tpu/ops/
  grow_partition.py:314-315) are reduced in XLA's order, which the port's
  `torch.sum` (ops/grow_partition.py:178-179) does not reproduce, nor
  does any simple order of vector lanes, fused or not;
- the split scan's gain, 2 g' out + (h + l2) out^2
  (lightgbm_tpu/ops/split_pallas.py:129-130, the Pallas kernel in
  interpret mode), is computed with a fused multiply-add, which the
  port's scan (ops/split_kernel.py:142-143, csrc/split_scan.cu:70-75)
  rounds twice;
- the sibling histogram, parent minus the dequantized smaller child
  (lightgbm_tpu/ops/grow_partition.py:765-769), fuses the dequantizing
  multiply into the subtraction, where the port rounds the product
  first.
The second and third could be copied; the first cannot, so the trees
cannot be held equal and the test records that they are not.  One round,
so it stays near 20 s on the CPU.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_carried import PARAMS, _data

CASE = dict(PARAMS, objective="binary", tpu_quantized_grad=True,
            num_leaves=127, min_data_in_leaf=20, tpu_arena_factor=4)


@pytest.mark.xfail(strict=True, reason=(
    "XLA's CPU arithmetic in the JAX grower (its reduction order of the "
    "root sums, fused multiply-adds in the split gain and the sibling "
    "subtraction) moves near-tie splits; the port cannot reproduce the "
    "reduction order (ROADMAP queue 3)"))
def test_quantized_127_leaf_tree_matches_jax():
    X, y = _data("binary", n=4000)
    jb = jlgb.Booster(params=dict(CASE, tpu_tree_engine="partition"),
                      train_set=jlgb.Dataset(X, y))
    tb = tlgb.Booster(params=CASE,
                      train_set=tlgb.Dataset(X, y, device="cpu"),
                      device="cpu")
    jb.update()
    tb.update()
    jb.predict(X[:1])                       # drains JAX's pending tree
    a, b = tb._gbdt.models[0], jb._gbdt.models[0]
    assert tb._gbdt._quantized and tb._gbdt._carried_active
    assert a.num_leaves == b.num_leaves > 1
    k = a.num_leaves - 1
    np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
    np.testing.assert_array_equal(a.predict_leaf_index(X),
                                  b.predict_leaf_index(X))
