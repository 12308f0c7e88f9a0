"""Continued training and `rollback_one_iter` on the partition engine's
carried arena in the port against the JAX package, on the CPU (its Pallas
kernels in interpret mode): binary, 15 leaves, 1,500 rows (`max_bin` 63);
both packages continue the port's 2-round model text for 4 fused rounds
without a validation set (the carried arena, the trees deferred), then
roll the last one back and grow it again.  The training set's init score
(the model's prediction), the training scores and the predictions agree
within tests/test_torch_bagging.py's prediction tolerance, rtol 1e-4, atol
1e-6, and the trees as its `_assert_models_match` holds them; the port
leaves the carried arena for good at the rollback, its training score
then the prediction of the 3 iterations within 1e-6.  One JAX booster
holds both, for the time of the JAX package's compilations.  The seed
holds no exact tie between two thresholds with no training row between
them (ROADMAP.md queue 3).
"""
import numpy as np

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_bagging import _assert_models_match
from test_torch_continue import PARAMS
from test_torch_goss import data

P = dict(PARAMS, tpu_tree_engine="partition")


def _continued(lib, text, X, y, **dev):
    ds = lib.Dataset(X, y, free_raw_data=False, **dev)
    bst = lib.train(P, ds, 4, init_model=lib.Booster(model_str=text, **dev),
                    verbose_eval=False, **dev)
    return bst, ds


def test_continued_training_and_rollback_match_jax_on_the_partition_engine():
    X, y = data("binary", n=1500, seed=6)
    text = tlgb.train(P, tlgb.Dataset(X, y, device="cpu"), 2,
                      verbose_eval=False, device="cpu").model_to_string()
    jb, jds = _continued(jlgb, text, X, y)
    tb, tds = _continued(tlgb, text, X, y, device="cpu")
    tg, jg = tb._gbdt, jb._gbdt
    assert tg._use_partition_engine and tg._carried_active
    np.testing.assert_allclose(tds.get_init_score(), jds.get_init_score(),
                               rtol=1e-4, atol=1e-6)
    three = tb.predict(X, raw_score=True, num_iteration=3)
    jg._sync_model()
    tg._sync_model()
    assert len(tg.models) == len(jg.models) == 4
    _assert_models_match(jg.models, tg.models, X)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-6)

    jb.rollback_one_iter()
    tb.rollback_one_iter()
    assert tg._carried_active is False and tg.iter == jg.iter == 3
    np.testing.assert_array_equal(tb.predict(X, raw_score=True), three)
    init = tds.get_init_score()
    np.testing.assert_allclose(tg.score.numpy(), three + init, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.score.numpy(),
                               np.asarray(jg.train_state.score)[0],
                               rtol=1e-4, atol=1e-6)
    jb.update()
    tb.update()
    jg._sync_model()
    tg._sync_model()
    assert tg._carried_active is False and tb.num_trees() == 4
    _assert_models_match(jg.models, tg.models, X)
