"""Categorical training against the JAX package on the CPU, the case of
tests/test_torch_categorical.py's `CASES` that reads the host tree: a
validation set with AUC and early stopping (each tree fetched in its
round, the set's score by KP2's add mode over categorical nodes; AUC
rtol 1e-6 of JAX's, the same best iteration), held as that file holds
its cases; 3 classes run in tests/test_torch_categorical_multiclass.py."""
from test_torch_categorical import check_case, train_case


def test_training_matches_jax():
    check_case("valid")
    g = train_case("valid")[2]._gbdt
    assert g._tree_fetches == g.num_trees() > 0
