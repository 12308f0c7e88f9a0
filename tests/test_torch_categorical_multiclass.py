"""Categorical training against the JAX package on the CPU, 3 classes
(softmax, k trees a round with their bin sets through the drains), the
`multiclass` case of tests/test_torch_categorical.py's `CASES`, held as
that file holds its cases."""
from test_torch_categorical import check_case, train_case


def test_training_matches_jax():
    check_case("multiclass")
    assert train_case("multiclass")[2]._gbdt.num_tree_per_iteration == 3
