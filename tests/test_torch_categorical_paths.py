"""Categorical training against the JAX partition engine on the CPU, the
cases of tests/test_torch_categorical.py's `CASES` on the fused paths:
the carried arena and, weighted, the pristine root (each held as that file
holds its cases); on the carried model, an unseen category, a negative one
and a missing one take the right branch of each categorical node, as the
same model predicts them in JAX (tests/test_categorical.py:179), and KP2's plain walk over each
tree's categorical nodes (`gbdt._tree_to_device`, the bit sets as
[N, B] masks) equals lightgbm_tpu.ops.grow.predict_leaf_inner and the
host walk on every training row."""
import numpy as np
import pytest

import jax.numpy as jnp
import lightgbm_tpu as jlgb
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.ops import grow as tgrow

from test_torch_categorical import CATS, check_case, train_case


@pytest.mark.parametrize("name", ["carried", "weighted"])
def test_training_matches_jax(name):
    check_case(name)
    g = train_case(name)[2]._gbdt
    assert g._carried_active is (name == "carried")
    assert g._tree_fetches == 0


def test_unseen_and_missing_categories_go_right():
    """tests/test_categorical.py:179: a category the training data never
    had, a negative one and a missing one fail every categorical node's
    bit set and go right.  The port's model in the JAX package predicts
    them as the port's device walk and host walk do, and each tree that
    puts the training rows in JAX's leaves puts these rows there too."""
    X, jb, tb, _ = train_case("carried")
    in_jax = jlgb.Booster(model_str=tb.model_to_string())
    roots = 0
    for fill in (999.0, np.nan, -3.0):
        Xq = X[:50].copy()
        Xq[:, list(CATS)] = fill
        got = tb.predict(Xq, raw_score=True)
        np.testing.assert_array_equal(got, tb.predict(Xq, raw_score=True,
                                                      device=False))
        np.testing.assert_allclose(got, in_jax.predict(Xq, raw_score=True),
                                   rtol=0, atol=1e-12)
        for a, b in zip(tb._gbdt.models, jb._gbdt.models):
            cat_nodes = np.flatnonzero(a.decision_type[:a.num_leaves - 1] & 1)
            assert not a._categorical_go_left(
                np.full(len(cat_nodes), fill), cat_nodes).any()
            leaves = a.predict_leaf_index(Xq)
            if np.array_equal(a.predict_leaf_index(X),
                              b.predict_leaf_index(X)):
                np.testing.assert_array_equal(leaves,
                                              b.predict_leaf_index(Xq))
            if a.decision_type[0] & 1:
                roots += 1
                assert set(leaves) <= _leaves_under(a, a.right_child[0])
    assert roots > 0


def _leaves_under(tree, node):
    if node < 0:
        return {~node}
    return (_leaves_under(tree, tree.left_child[node])
            | _leaves_under(tree, tree.right_child[node]))


def test_walk_over_categorical_nodes_matches_jax():
    """KP2's plain version over the bins: each trained tree's device form
    (gbdt._tree_to_device, the bit sets as [N, B] masks) walks every
    training row to JAX's predict_leaf_inner leaf and to the host walk's."""
    X, jb, tb, _ = train_case("carried")
    g = tb._gbdt
    ds = g.train_set
    bins = ds.device_bins("cpu")
    for tree in g.models:
        dev_tree = tgbdt._tree_to_device(tree, "cpu", g.max_bin)
        assert dev_tree.cat_mask.shape[1] == g.max_bin
        got = tgrow.predict_leaf_inner(bins, dev_tree, g.num_bins,
                                       g.default_bins).numpy()
        jt = jgrow.TreeArrays(**{k: jnp.asarray(v.numpy())
                                 for k, v in dev_tree._asdict().items()})
        want = np.asarray(jgrow.predict_leaf_inner(
            jnp.asarray(bins.numpy()), jt, jnp.asarray(g.num_bins.numpy()),
            jnp.asarray(g.default_bins.numpy())))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tree.predict_leaf_index(X))
