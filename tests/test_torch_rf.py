"""boosting=rf in the port against the JAX package, on the CPU (its Pallas
kernels in interpret mode, the engine forced by `tpu_tree_engine`).

5 rounds of 15-leaf trees over a bag of 0.8 of the rows, drawn anew every
round: binary on both engines, three classes (a tree a class a round) and
L1, whose leaves are refit to the percentiles of the residuals against the
constant init score.  The bags are equal every round; the trees split on
the same features and put every row in the same leaf (the seeds hold no
exact tie between two thresholds with no row of the bag between them:
ROADMAP.md queue 3); leaf values agree within f32 tolerance; the training
scores, running averages of the trees' outputs, agree within 1e-5 and
equal the model's own averaged prediction within 1e-5; predictions agree
within tests/test_torch_bagging.py's tolerance; the model text carries
`average_output` and loads in the JAX package, predicting the same.  RF
without bagging raises in both packages.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.utils.log import LightGBMError as JaxError
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_goss import (PARAMS, PRODUCTION, assert_predictions_match,
                             assert_trees_match, data, train_both)

BAG = {"boosting": "rf", "bagging_fraction": 0.8, "bagging_freq": 1}
CASES = {
    "binary": ("binary", dict(objective="binary",
                              tpu_tree_engine="partition")),
    "binary_label": ("binary", dict(objective="binary",
                                    tpu_tree_engine="label")),
    "multiclass": ("multiclass", dict(objective="multiclass", num_class=3,
                                      tpu_tree_engine="partition")),
    "l1": ("regression", dict(objective="regression_l1",
                              tpu_tree_engine="partition")),
}


def _bag(jb, tb):
    want = np.asarray(jb._gbdt._bag_mask)
    np.testing.assert_array_equal(tb._gbdt._bag_mask, want)
    return want == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_rf_training_matches_jax(name):
    task, extra = CASES[name]
    params = dict(PARAMS, **BAG, **extra)
    X, jb, tb, bags = train_both(params, task, seed=1, sample=_bag)
    tg, jg = tb._gbdt, jb._gbdt
    assert type(tg).__name__ == type(jg).__name__ == "RF"
    assert tg.average_output and tg.shrinkage_rate == 1.0
    assert tg._rf_init_scores == pytest.approx(jg._rf_init_scores, rel=1e-12)
    k = tg.num_tree_per_iteration
    assert tg._tree_fetches == len(tg.models) == 5 * k
    assert_trees_match(jg.models, tg.models, X, bags, k=k)
    assert_predictions_match(X, jb, tb)
    # the running averages: against JAX's, and against the averaged model
    scores = tg.scores.numpy()
    np.testing.assert_allclose(scores, np.asarray(jg.train_state.score),
                               rtol=0, atol=1e-5)
    raw = tb.predict(X, raw_score=True)
    np.testing.assert_allclose(scores, raw.T.reshape(k, -1), rtol=0,
                               atol=1e-5)
    text = tb.model_to_string()
    assert "\naverage_output\n" in text
    with PRODUCTION():
        in_jax = jlgb.Booster(model_str=text).predict(X, raw_score=True)
    np.testing.assert_allclose(in_jax, raw, rtol=1e-12, atol=1e-12)


def test_rf_without_bagging_raises():
    X, y = data("binary", n=300)
    params = dict(PARAMS, objective="binary", boosting="rf")
    with pytest.raises(JaxError, match="requires bagging"):
        jlgb.Booster(params=params, train_set=jlgb.Dataset(X, y))
    with pytest.raises(LightGBMError, match="requires bagging"):
        tlgb.Booster(params=params,
                     train_set=tlgb.Dataset(X, y, device="cpu"), device="cpu")
