"""DART in the port against the JAX package, on the CPU (its Pallas kernels
in interpret mode, `tpu_tree_engine="partition"`).

6 rounds of 15-leaf binary trees with a validation set, drop_rate 0.5 and
skip_drop 0 so that trees drop in most rounds, over the four variants of
`uniform_drop` x `xgboost_dart_mode`: the drawn drops, the shrinkage and
the tree weights are equal every round; the trees, dropped and rescaled in
place, split on the same features and put every row in the same leaf;
leaf values agree within f32 tolerance, the training scores within 1e-5
and the validation metrics within 1e-6; the training score equals the
model's own prediction within 1e-5 (the drops and the normalization
against the saved trees); predictions agree within
tests/test_torch_bagging.py's tolerance; every tree is fetched in its
round and the device ensemble follows the trees rescaled in place.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_goss import (PARAMS, PRODUCTION, assert_predictions_match,
                             assert_trees_match, data)

ROUNDS = 6


def _train(params, X, y, Xv, yv):
    with PRODUCTION():
        jd = jlgb.Dataset(X, y)
        jb = jlgb.Booster(params=params, train_set=jd)
        jb.add_valid(jlgb.Dataset(Xv, yv, reference=jd), "holdout")
    td = tlgb.Dataset(X, y, device="cpu")
    tb = tlgb.Booster(params=params, train_set=td, device="cpu")
    tb.add_valid(tlgb.Dataset(Xv, yv, reference=td, device="cpu"), "holdout")
    drops = []
    for _ in range(ROUNDS):
        with PRODUCTION():
            jb.update()
        gen = tb._gbdt._model_gen
        tb.update()
        jg, tg = jb._gbdt, tb._gbdt
        assert tg._drop_index == jg._drop_index
        assert tg.shrinkage_rate == jg.shrinkage_rate
        assert tg.tree_weight == pytest.approx(jg.tree_weight, rel=1e-15)
        assert tg.sum_weight == pytest.approx(jg.sum_weight, rel=1e-12)
        assert tg._model_gen == gen + bool(tg._drop_index)
        drops.append(list(tg._drop_index))
        with PRODUCTION():
            jev = jb.eval_valid()
        for a, b in zip(tb.eval_valid(), jev):
            assert a[:2] == b[:2]
            assert a[2] == pytest.approx(b[2], abs=1e-6)
    return jb, tb, drops


@pytest.mark.parametrize("xgboost_dart_mode", [False, True])
@pytest.mark.parametrize("uniform_drop", [False, True])
def test_dart_training_matches_jax(uniform_drop, xgboost_dart_mode):
    params = dict(PARAMS, objective="binary", boosting="dart",
                  tpu_tree_engine="partition", metric="binary_logloss",
                  drop_rate=0.5, skip_drop=0.0, uniform_drop=uniform_drop,
                  xgboost_dart_mode=xgboost_dart_mode)
    X, y = data("binary", seed=1)
    Xv, yv = data("binary", n=500, seed=11)
    jb, tb, drops = _train(params, X, y, Xv, yv)
    tg, jg = tb._gbdt, jb._gbdt
    assert type(tg).__name__ == type(jg).__name__ == "DART"
    assert sum(map(len, drops)) >= 3 and not drops[0]
    assert tg._tree_fetches == len(tg.models) == ROUNDS
    assert not tg._inflight and tg._drains == 0
    assert_trees_match(jg.models, tg.models, X, [None] * ROUNDS)
    np.testing.assert_allclose(tg.score.numpy(),
                               np.asarray(jg.train_state.score)[0], rtol=0,
                               atol=1e-5)
    # the drops and normalizations kept the score the saved model's
    raw = tb.predict(X, raw_score=True)
    np.testing.assert_allclose(tg.score.numpy(), raw, rtol=0, atol=1e-5)
    assert_predictions_match(X, jb, tb)
    # the device ensemble follows trees rescaled in place
    np.testing.assert_array_equal(raw, tb.predict(X, raw_score=True,
                                                  device=False))
