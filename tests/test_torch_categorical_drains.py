"""Categorical training against the JAX package on the CPU, the cases of
tests/test_torch_categorical.py's `CASES` on the eager path's deferred
rounds and the quantized carried arena: a bag (K3's pred mode at the
root, the out-of-bag rows' score by KP2's masked add over categorical
nodes) and int8 gradient codes; each held as that file holds its cases,
no tree fetched in its round."""
import pytest

from test_torch_categorical import check_case, train_case


@pytest.mark.parametrize("name", ["quantized", "bagged"])
def test_training_matches_jax(name):
    check_case(name)
    g = train_case(name)[2]._gbdt
    assert g._tree_fetches == 0
    assert g._quantized is (name == "quantized")
    assert bool(g._carried_active) is (name == "quantized")
