"""Reads in the middle of a fused run: predict, model_to_string,
num_trees, current_iteration and feature_importance drain first and agree
with the same read of a booster trained to that round by `train`, and
with the JAX booster's read at that round; training on after the read
ends where an unread run ends (helpers: tests/test_torch_inflight.py).
Three of the reads here, num_trees and feature_importance in
tests/test_torch_inflight_reads_counts.py.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb

from test_torch_inflight import (_assert_same_model, _boosters, _inputs,
                                 assert_texts_match)


READS = {
    "predict": lambda b, X: b.predict(X, raw_score=True),
    "model_to_string": lambda b, X: b.model_to_string(),
    "num_trees": lambda b, X: b.num_trees(),
    "current_iteration": lambda b, X: b.current_iteration,
    "feature_importance": lambda b, X: b._gbdt.feature_importance(),
}


def check_read(read):
    """Three rounds of the carried quantized path with the packages' own
    drain cadence (no drain before round 48), then one read."""
    X, y, w, params = _inputs(True, False)
    jb, tb = _boosters(X, y, w, params)
    for _ in range(3):
        jb.update()
        tb.update()
    g = tb._gbdt
    assert len(g._inflight) == 3 and g.models == [None] * 3
    got = READS[read](tb, X)
    assert not g._inflight and None not in g.models and g._drains == 1
    ref = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                     num_boost_round=3, device="cpu")
    want = READS[read](ref, X)
    jax_read = READS[read](jb, X)
    if read == "model_to_string":
        assert got == want
        assert_texts_match(got, jax_read)
        _assert_same_model(jb, tb, X)
    elif read == "predict":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, jax_read, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_read)
    # training on after the read ends where a run without it ends
    for _ in range(2):
        tb.update()
    five = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                      num_boost_round=5, device="cpu")
    assert tb.model_to_string() == five.model_to_string()


@pytest.mark.parametrize("read", ["current_iteration", "model_to_string",
                                  "predict"])
def test_read_in_training_drains_first(read):
    check_read(read)
