"""Multiclass training against the JAX package on the CPU, continued from
tests/test_torch_multiclass.py: feature_fraction 0.6 (one mask a tree, drawn
in class order) and the label engine with a class-major init score of
length k*n, held as that file holds its cases; and the drains, with both
packages' `_DRAIN_EVERY` 2 (monkeypatched): a run whose iteration 4 grows
no tree, found by the drain at the end of `train` after drains that grouped
whole iterations, rolls iterations 4 and 5 back, and a degenerate first
iteration keeps every class's prior as a constant tree: the same model
text as JAX (tests/test_torch_inflight.py's `assert_texts_match`), tree
count and iteration, and the next update refuses to train."""
import numpy as np
import pytest

from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu_torch.models import gbdt as tgbdt

from test_torch_inflight import assert_texts_match
from test_torch_multiclass import (K, _assert_models_match, _train_both,
                                   check_training_case)

DRAIN_CASES = ("softmax-feature-fraction", "softmax-label-init-score")


@pytest.mark.parametrize("case", DRAIN_CASES)
def test_training_matches_jax(case):
    check_training_case(case)


@pytest.fixture
def drain_every(monkeypatch):
    monkeypatch.setattr(jgbdt, "_DRAIN_EVERY", 2)
    monkeypatch.setattr(tgbdt, "_DRAIN_EVERY", 2)


# min_gain_to_split -> the iteration (from 0) at which no class splits
STOPS = {"later": (45.0, 4), "first": (1e6, 0)}


@pytest.mark.parametrize("stop", sorted(STOPS))
def test_degenerate_iteration_rolls_back_whole_iterations(stop, drain_every):
    min_gain, stopped_at = STOPS[stop]
    X, jb, tb, _ = _train_both("multiclass", "fused",
                               {"min_gain_to_split": min_gain}, rounds=6)
    g = tb._gbdt
    assert g._deferred_stopped and jb._gbdt._deferred_stopped
    assert g.iter == jb._gbdt.iter == stopped_at
    # drains after iterations 1 and 3 and at train's end; a first
    # iteration's stop is found by the drain after iteration 1
    assert g._tree_fetches == 0 and g._drains == (3 if stopped_at else 1)
    assert tb.num_trees() == jb.num_trees() == K * max(stopped_at, 1)
    assert_texts_match(tb.model_to_string(), jb.model_to_string())
    if stopped_at == 0:
        priors = [t.leaf_value[0] for t in g.models]
        np.testing.assert_allclose(
            priors, [t.leaf_value[0] for t in jb._gbdt.models], rtol=1e-12)
        assert all(t.num_leaves == 1 for t in g.models)
    else:
        _assert_models_match(jb, tb, X, K * stopped_at)
    assert tb.update() is True
    assert tb.num_trees() == jb.num_trees()
