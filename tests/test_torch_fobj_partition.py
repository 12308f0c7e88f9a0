"""Custom objectives and eval functions on the partition engine's f32 rounds
in the port against the JAX package, on the CPU (its Pallas kernels in
interpret mode), as tests/test_torch_fobj.py holds its quantized rounds:
2 rounds of 15-leaf binary trees on 1,200 rows (`max_bin` 63) with a
validation set, a logloss fobj and an error feval written in numpy, the
trees equal as tests/test_torch_bagging.py's `_assert_models_match` holds
them, predictions within its rtol 1e-4, atol 1e-6, evals_result within
1e-6.  The seed holds no exact tie between two thresholds with no training
row between them (ROADMAP.md queue 3).
"""
from test_torch_fobj import check_fobj_feval


def test_fobj_feval_match_jax_on_partition_f32():
    check_fobj_feval("binary", dict(tpu_tree_engine="partition",
                                    metric="auc"))
