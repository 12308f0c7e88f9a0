"""Continued training and rollback in the port against the JAX
package, on the CPU (its Pallas kernels in interpret mode, the engine
named by `tpu_tree_engine`).

- `init_model` as the JAX package's `TestContinuedTraining`
  (tests/test_resilience.py:198-224: 150 x 8 regression, 7 leaves, 3 + 3
  rounds at learning rate 0.2): the continued booster holds only the new
  trees, and the two stages' raw predictions summed equal the
  uninterrupted run's (rtol 1e-5, atol 1e-6); on the partition engine (the
  carried arena) from a model file (the next test continues from a
  Booster on the label engine);
- continued training against the JAX package: binary, 15 leaves, 1,500
  rows (`max_bin` 63), the label engine, 2 rounds then 2 more from the
  first model, with a validation set given no init score: the continued
  trees as tests/test_torch_bagging.py's `_assert_models_match` holds
  them, the datasets' init scores (the first models' predictions) within
  its prediction tolerance, rtol 1e-4, atol 1e-6, evals_result within
  1e-6 (tests/test_torch_continue_partition.py holds the partition
  engine's);
- `rollback_one_iter` after 4 rounds and a validation set attached, on
  the label engine against the JAX package: the training and validation
  scores within the prediction tolerance of JAX's rolled-back scores and
  within 1e-6 of the port's prediction of the first 3 iterations, which
  the model is; one more round after it grows JAX's tree; on the partition
  engine after 4 fused carried rounds: the carried arena left for good,
  the training score the prediction of the 3 iterations within 1e-6, and
  the next round trains on the pristine arena
  (tests/test_torch_continue_partition.py holds it against the JAX
  package after continued rounds).

The seeds hold no exact tie between two thresholds with no training row
between them (ROADMAP.md queue 3).
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_bagging import _assert_models_match
from test_torch_goss import data

BASE = dict(objective="regression", num_leaves=7, verbosity=-1,
            min_data_in_leaf=5, seed=3, learning_rate=0.2)
PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
          "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1,
          "tpu_tree_engine": "label"}


def _resilience_data(seed=1, n=150, f=8):
    """tests/test_resilience.py's `_data`."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    return X, X[:, 0] * 2 + rng.rand(n) * 0.1


@pytest.mark.parametrize("engine,source", [("partition", "file")])
def test_init_model_is_additive(engine, source, tmp_path):
    X, y = _resilience_data()
    params = dict(BASE, tpu_tree_engine=engine)

    def ds():
        return tlgb.Dataset(X, label=y, device="cpu")
    full = tlgb.train(params, ds(), 6, verbose_eval=False, device="cpu")
    m1 = tlgb.train(params, ds(), 3, verbose_eval=False, device="cpu")
    init = m1
    if source == "file":
        init = str(tmp_path / "m1.txt")
        m1.save_model(init)
    m2 = tlgb.train(params, ds(), 3, init_model=init, verbose_eval=False,
                    device="cpu")
    assert len(m2._gbdt.models) == 3
    pf = full.predict(X, raw_score=True)
    pc = m1.predict(X, raw_score=True) + m2.predict(X, raw_score=True)
    np.testing.assert_allclose(pc, pf, rtol=1e-5, atol=1e-6)


def _continued(lib, X, y, Xv, yv, **dev):
    ev = {}
    m1 = lib.train(PARAMS, lib.Dataset(X, y, **dev), 2, verbose_eval=False,
                   **dev)
    ds = lib.Dataset(X, y, free_raw_data=False, **dev)
    dv = lib.Dataset(Xv, yv, reference=ds, free_raw_data=False, **dev)
    m2 = lib.train(PARAMS, ds, 2, valid_sets=[dv], valid_names=["v"],
                   init_model=m1, evals_result=ev, verbose_eval=False,
                   **dev)
    return m2, ds, dv, ev


def test_continued_training_matches_jax():
    X, y = data("binary", n=1500, seed=6)
    Xv, yv = X[::3], y[::3]
    jb, jds, jdv, jev = _continued(jlgb, X, y, Xv, yv)
    tb, tds, tdv, tev = _continued(tlgb, X, y, Xv, yv, device="cpu")
    for a, b in ((tds, jds), (tdv, jdv)):
        np.testing.assert_allclose(a.get_init_score(), b.get_init_score(),
                                   rtol=1e-4, atol=1e-6)
    assert len(tb._gbdt.models) == len(jb._gbdt.models) == 2
    _assert_models_match(jb._gbdt.models, tb._gbdt.models, X)
    for metric, want in jev["v"].items():
        np.testing.assert_allclose(tev["v"][metric], want, rtol=0,
                                   atol=1e-6)


def _rollback(lib, X, y, Xv=None, yv=None, engine="label", **dev):
    ds = lib.Dataset(X, y, **dev)
    bst = lib.Booster(dict(PARAMS, tpu_tree_engine=engine), ds, **dev)
    for _ in range(4):
        bst.update()
    if Xv is not None:
        bst.add_valid(lib.Dataset(Xv, yv, reference=ds, **dev), "v")
    three = bst.predict(X, raw_score=True, num_iteration=3)
    bst.rollback_one_iter()
    return bst, three


def test_rollback_one_iter_on_the_carried_arena():
    X, y = data("binary", n=1500, seed=6)
    tb, three = _rollback(tlgb, X, y, engine="partition", device="cpu")
    g = tb._gbdt
    assert g._carried_active is False and g.iter == 3
    np.testing.assert_array_equal(tb.predict(X, raw_score=True), three)
    np.testing.assert_allclose(g.score.numpy(), three, rtol=0, atol=1e-6)
    tb.update()
    assert g._carried_active is False and tb.num_trees() == 4


def test_rollback_one_iter_matches_jax():
    X, y = data("binary", n=1500, seed=6)
    Xv, yv = X[::3], y[::3]
    jb, _ = _rollback(jlgb, X, y, Xv, yv)
    tb, three = _rollback(tlgb, X, y, Xv, yv, device="cpu")
    tg, jg = tb._gbdt, jb._gbdt
    assert tg.iter == jg.iter == 3 and tb.num_trees() == 3
    np.testing.assert_array_equal(tb.predict(X, raw_score=True), three)
    np.testing.assert_allclose(tg.score.numpy(),
                               np.asarray(jg.train_state.score)[0],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tg.valid_states[0][1].score.numpy(),
                               np.asarray(jg.valid_states[0][1].score)[0],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tg.score.numpy(), three, rtol=0, atol=1e-6)
    jb.update()
    tb.update()
    _assert_models_match(jg.models, tg.models, X)
