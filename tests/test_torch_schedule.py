"""Learning-rate schedules and `reset_parameter` in the port against the JAX
package, on the CPU (its Pallas kernels in interpret mode, the engine
named by `tpu_tree_engine`).

- 6 rounds of binary 7-leaf trees on 2,000 rows (`max_bin` 63) with a
  validation set, so that the JAX package fetches every tree in its round
  and shrinks it by its own round's rate: `learning_rates` (a list) and
  `callback.reset_parameter` of `lambda_l2`, `min_data_in_leaf` and
  bagging (off for three rounds, then `bagging_fraction` 0.8 every
  round), on the label engine (tests/test_torch_schedule_partition.py
  holds the partition engine's).  Equal bags, trees as
  tests/test_torch_bagging.py's `_assert_models_match` holds them,
  shrinkages equal, predictions within its rtol 1e-4, atol 1e-6 and
  evals_result within 1e-6.  The seeds hold no exact tie between two
  thresholds with no in-bag row between them (ROADMAP.md queue 3);
- the port's deferred run on the partition engine (no validation set:
  the fused carried arena, then the eager path's deferred bagged rounds)
  grows the trees of its eager run, with the same shrinkages (the label
  engine's deferred rounds are the last test's);
- the JAX package shrinks a deferred tree by the rate of its drain
  (ROADMAP.md queue 3): with `learning_rates=[0.1]*3 + [0.5]*3` and no
  validation set its trees carry 1, 0.5, 0.5, 0.5, 0.5, 0.5.  The port
  keeps each round's rate: 1 (the bias resets it), 0.1, 0.1, 0.5, 0.5,
  0.5, and its model predicts its training score within 1e-5, on both
  engines.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_bagging import _assert_models_match
from test_torch_goss import data

PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1, "bagging_seed": 3}
ROUNDS = 6
RATES = [0.3, 0.3, 0.1, 0.2, 0.05, 0.2]
SCHEDULE = dict(lambda_l2=[0.0, 1.0, 1.0, 5.0, 5.0, 0.5],
                min_data_in_leaf=[20, 20, 40, 40, 10, 10],
                bagging_fraction=[1.0, 1.0, 1.0, 0.8, 0.8, 0.8],
                bagging_freq=[0, 0, 0, 1, 1, 1])
ENGINES = ("partition", "label")


def _train(lib, engine, X, y, valid: bool, masks=None, schedule=SCHEDULE,
           **dev):
    ds = lib.Dataset(X, y, **dev)
    kw = {}
    if valid:
        kw = dict(valid_sets=[lib.Dataset(X[::5], y[::5], reference=ds,
                                          **dev)],
                  valid_names=["holdout"], evals_result={})
    callbacks = [lib.reset_parameter(**schedule)]
    if masks is not None:
        def bag(env):
            masks.append(np.asarray(env.model._gbdt._bag_mask)
                         if env.model._gbdt._bag_mask is not None else None)
        callbacks.append(bag)
    bst = lib.train(dict(PARAMS, tpu_tree_engine=engine), ds, ROUNDS,
                    learning_rates=RATES, callbacks=callbacks,
                    verbose_eval=False, **kw, **dev)
    return bst, kw.get("evals_result")


@pytest.fixture(scope="module")
def runs():
    X, y = data("binary", n=2000, seed=4)
    out = {}
    for engine in ENGINES:
        jm, tm = [], []
        out[engine] = dict(
            X=X, jm=jm, tm=tm,
            port=_train(tlgb, engine, X, y, True, tm, device="cpu"))
        if engine == "label":
            out[engine]["jax"] = _train(jlgb, engine, X, y, True, jm)
        else:
            out[engine]["deferred"] = _train(tlgb, engine, X, y, False,
                                             device="cpu")
    return out


def check_schedule_matches_jax(c, schedule=SCHEDULE):
    """The port's eager scheduled run `c` against the JAX package's: the
    same bags, trees, shrinkages, predictions and evals_result."""
    (jb, jev), (tb, tev) = c["jax"], c["port"]
    assert len(c["tm"]) == len(c["jm"]) == ROUNDS
    for it, (a, b) in enumerate(zip(c["tm"], c["jm"])):
        assert (a is None) == (b is None) \
            == (schedule["bagging_freq"][it] == 0), it
        if a is not None:
            np.testing.assert_array_equal(a, b)
    jg, tg = jb._gbdt, tb._gbdt
    last = {k: v[-1] for k, v in schedule.items()}
    assert tg.config.lambda_l2 == last["lambda_l2"]
    assert tg.config.min_data_in_leaf == last["min_data_in_leaf"]
    assert tg.split_params.lambda_l2 == last["lambda_l2"]
    _assert_models_match(jg.models, tg.models, c["X"])
    assert [t.shrinkage for t in tg.models] == pytest.approx(
        [t.shrinkage for t in jg.models], rel=1e-12)
    assert [t.shrinkage for t in tg.models][1:] == pytest.approx(RATES[1:])
    np.testing.assert_allclose(tb.predict(c["X"], raw_score=True),
                               jb.predict(c["X"], raw_score=True),
                               rtol=1e-4, atol=1e-6)
    for metric, want in jev["holdout"].items():
        np.testing.assert_allclose(tev["holdout"][metric], want, rtol=0,
                                   atol=1e-6)


def test_schedule_matches_jax_eager(runs):
    check_schedule_matches_jax(runs["label"])


def test_deferred_schedule_equals_eager(runs):
    c = runs["partition"]
    (tb, _), (db, _) = c["port"], c["deferred"]
    g = db._gbdt
    assert g._tree_fetches == 0 and g._drains >= 1
    assert tb._gbdt._tree_fetches == ROUNDS
    # the carried arena until bagging starts, then left for good
    assert g._carried_active is False and g._bag_count == 1600
    _assert_models_match(tb._gbdt.models, g.models, c["X"])
    assert [t.shrinkage for t in g.models] == \
        [t.shrinkage for t in tb._gbdt.models]


@pytest.mark.parametrize("engine", ENGINES)
def test_deferred_trees_keep_their_rounds_rate(engine):
    """The inputs of ROADMAP.md queue 3's record of the JAX package's
    fault: 2,000 x 8 binary, 7 leaves, no validation set."""
    X, y = data("binary", n=2000, seed=3)
    rates = [0.1] * 3 + [0.5] * 3
    bst = tlgb.train({"objective": "binary", "num_leaves": 7,
                      "max_bin": 63, "verbose": -1,
                      "tpu_tree_engine": engine},
                     tlgb.Dataset(X, y, device="cpu"), 6,
                     learning_rates=rates, verbose_eval=False,
                     device="cpu")
    g = bst._gbdt
    assert g._tree_fetches == 0
    assert [t.shrinkage for t in g.models] == pytest.approx(
        [1.0] + rates[1:], rel=1e-12)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               g.score.numpy(), rtol=0, atol=1e-5)
