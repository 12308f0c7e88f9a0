"""A bagged run on the eager path that stops on a degenerate round, found
by a drain with both packages' `_DRAIN_EVERY` 2, at a later round or the
first: the same rollback as JAX's and the training score rebuilt from
the model (helpers: tests/test_torch_inflight_eager.py).
"""
import pytest

from test_torch_inflight_eager import (_assert_engine_model,
                                       _assert_scores_close, _eager_inputs,
                                       _train_eager_both)


@pytest.mark.parametrize("min_gain", [100.0, 1e6])
@pytest.mark.parametrize("name", ["bagged_f32", "label_bagged_f32"])
def test_eager_degenerate_stop_matches_jax(name, min_gain, monkeypatch):
    """A bagged run that stops on a degenerate round (min_gain_to_split
    100: a later round; 1e6: the first, which keeps the prior as a
    constant tree), found by a drain with _DRAIN_EVERY 2: the rollback
    leaves the same model, tree count and iteration as JAX's, the
    training score rebuilt from that model as JAX rebuilds it, and the
    next round refuses to train."""
    X, y, params = _eager_inputs(name, 2, monkeypatch,
                                 min_gain_to_split=min_gain)
    jb, tb = _train_eager_both(X, y, params, 10)
    g = tb._gbdt
    assert g._deferred_stopped and jb._gbdt._deferred_stopped
    assert g.iter == jb._gbdt.iter
    assert (g.iter == 0) is (min_gain == 1e6)
    assert g._tree_fetches == 0
    _assert_engine_model(jb, tb, X)
    _assert_scores_close(tb, jb)
    assert tb.update() is True
    assert tb.num_trees() == jb.num_trees()
