"""Runs of the fused paths that stop on a degenerate round (a large
min_gain_to_split), against the JAX package's, with both packages'
`_DRAIN_EVERY` 2 (tests/test_torch_inflight.py's setting): found by the
first drain before any tree was drained, by a later drain, and by the
drain at the end of `train`; and a degenerate first round, which keeps the
prior as a constant tree: the same text, tree count and current_iteration
as JAX, and the next round refuses to train. The carried f32 path here;
tests/test_torch_inflight_stops_quantized.py holds the pristine quantized
one.
"""
import pytest

from test_torch_inflight import (CASES, _assert_same_model, _inputs,  # noqa: F401
                                 _train_both, drain_every)

STOPS = {
    "first_drain": (250.0, 1, 10),     # found by round 2's drain
    "later_drain": (130.0, 3, 10),     # round 3, found by round 4's drain
    "train_end": (130.0, 3, 4),        # round 3, pending when train ends
    "first_round": (1e6, 0, 10),       # the prior as a constant tree
}


@pytest.mark.parametrize("stop", sorted(STOPS))
@pytest.mark.parametrize("name", ["carried_f32"])
def test_degenerate_stop_matches_jax(name, stop, drain_every):
    min_gain, stopped_at, rounds = STOPS[stop]
    quantized, weighted = CASES[name]
    X, y, w, params = _inputs(quantized, weighted,
                              min_gain_to_split=min_gain)
    jb, tb = _train_both(X, y, w, params, rounds)
    g = tb._gbdt
    assert g._deferred_stopped and jb._gbdt._deferred_stopped
    assert g.iter == jb._gbdt.iter == stopped_at
    _assert_same_model(jb, tb, X)
    leaves = [m.num_leaves for m in g.models]
    if stopped_at == 0:
        assert leaves == [1]
        prior = g.models[0].leaf_value[0]
        assert prior == jb._gbdt.models[0].leaf_value[0] != 0.0
    else:
        assert len(leaves) == stopped_at and min(leaves) > 1
    # the stop holds: a further round trains nothing
    assert tb.update() is True
    assert tb.num_trees() == jb.num_trees()
