"""The eager path's deferred rounds (a bag, or the label engine, with no
validation set or training metric) against the JAX package's, with both
packages' `_DRAIN_EVERY` 3 here (2 in tests/test_torch_inflight_eager.py): bagged f32 and quantized on the partition
engine, the label engine unbagged and bagged, 5 rounds: no tree fetched in
its round, the drains where the cadence puts them, the model and training
score as JAX's (each engine held to the standard its own tests hold it
to).  Helpers: tests/test_torch_inflight_eager.py.
"""
import numpy as np
import pytest

from test_torch_inflight_eager import (EAGER_CASES, _assert_engine_model,  # noqa: F401
                                       _assert_scores_close, _eager_inputs,
                                       _train_eager_both)


@pytest.mark.parametrize("drain", [3])
@pytest.mark.parametrize("name", sorted(EAGER_CASES))
def test_eager_deferred_run_matches_jax(name, drain, monkeypatch):
    """Five rounds of a bagged or label-engine run (no validation set, no
    training metric): no tree is fetched in its round; the drains come at
    rounds 3 and 5 and at the end of train (_DRAIN_EVERY 2), or at round
    4 and the end (3); the model, tree count, iteration and training score
    equal the JAX package's."""
    X, y, params = _eager_inputs(name, drain, monkeypatch)
    jb, tb = _train_eager_both(X, y, params, 5)
    g = tb._gbdt
    assert not g._carried_active and not jb._gbdt._carried_active
    partition = params["tpu_tree_engine"] == "partition"
    assert g._use_partition_engine is partition
    assert bool(jb._gbdt._use_partition_engine) is partition
    assert g._tree_fetches == 0 and g._drains == {2: 3, 3: 2}[drain]
    assert not g._inflight and None not in g.models
    _assert_engine_model(jb, tb, X)
    _assert_scores_close(tb, jb)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)
