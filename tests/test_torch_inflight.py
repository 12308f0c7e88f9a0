"""The fused paths' deferred tree pipeline against the JAX package's, on the
CPU (its Pallas kernels in interpret mode, `tpu_tree_engine=partition`).

Both packages defer each fused round's tree and drain the pending trees
every `_DRAIN_EVERY` rounds and wherever the model is read.  Here both
modules' `_DRAIN_EVERY` is 2 (monkeypatched; the packages keep 48), so a
few rounds of a small model cross several drains:

- binary on the carried arena and, weighted, on the pristine root, f32 and
  quantized, 5 rounds: the same model text (token by token: names and
  integers equal, reals within rtol 1e-4 and atol 1e-6, as the trees'
  leaf values agree in tests/test_torch_carried.py; `tree_sizes`, the
  texts' lengths, follow the reals' digits and are left out; thresholds
  and their missing-value directions as tests/test_torch_carried.py holds
  thresholds: equal but at exact ties, where two choices split the node's
  rows alike and the gains agree to rtol 1e-5, every training row in the
  same leaf), tree count and
  current_iteration; the port drains at rounds 3 and 5 and at the end of
  training, and fetches no tree in its round.

The other cases of the pipeline live beside this file, a few each, so that
no file holds one test worker for long: tests/test_torch_inflight_stops.py
and _stops_quantized.py (degenerate rounds), _reads.py and
_reads_counts.py (reads in the middle of training), _eager.py and
_eager_drain3.py (the eager path's deferred rounds) and _eager_stops.py
(their degenerate rounds). Their helpers are this file's.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu_torch.models import gbdt as tgbdt

from test_torch_carried import PARAMS, _data

DRAIN = 2
CASES = {
    "carried_f32": (False, False),
    "carried_quantized": (True, False),
    "pristine_f32": (False, True),
    "pristine_quantized": (True, True),
}


@pytest.fixture
def drain_every(monkeypatch):
    monkeypatch.setattr(jgbdt, "_DRAIN_EVERY", DRAIN)
    monkeypatch.setattr(tgbdt, "_DRAIN_EVERY", DRAIN)


def _inputs(quantized, weighted, **extra):
    X, y = _data("binary")
    w = np.random.RandomState(3).rand(len(y)) + 0.5 if weighted else None
    params = dict(PARAMS, objective="binary", tpu_quantized_grad=quantized,
                  **extra)
    return X, y, w, params


def _boosters(X, y, w, params):
    jb = jlgb.Booster(params=dict(params, tpu_tree_engine="partition"),
                      train_set=jlgb.Dataset(X, y, weight=w))
    tb = tlgb.Booster(params=params,
                      train_set=tlgb.Dataset(X, y, weight=w, device="cpu"),
                      device="cpu")
    return jb, tb


def _train_both(X, y, w, params, rounds):
    jb = jlgb.train(dict(params, tpu_tree_engine="partition"),
                    jlgb.Dataset(X, y, weight=w), num_boost_round=rounds)
    tb = tlgb.train(params, tlgb.Dataset(X, y, weight=w, device="cpu"),
                    num_boost_round=rounds, device="cpu")
    return jb, tb


def assert_texts_match(got: str, want: str) -> None:
    """Model texts line by line: the same keys and tokens, names and
    integers equal, reals within rtol 1e-4 and atol 1e-6; `tree_sizes`
    only by count, thresholds and decision types by count
    (`_assert_same_model` holds them)."""
    gl, wl = got.split("\n"), want.split("\n")
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        ka, _, va = a.partition("=")
        kb, _, vb = b.partition("=")
        assert ka == kb
        ta, tb = va.split(" "), vb.split(" ")
        assert len(ta) == len(tb), ka
        if ka in ("tree_sizes", "threshold", "decision_type"):
            continue
        for x, y in zip(ta, tb):
            if x != y:
                assert abs(float(x) - float(y)) <= 1e-6 + 1e-4 * abs(
                    float(y)), (ka, x, y)


def _assert_same_model(jb, tb, X):
    assert tb.num_trees() == jb.num_trees()
    assert tb.current_iteration == jb.current_iteration
    assert_texts_match(tb.model_to_string(), jb.model_to_string())
    for a, b in zip(tb._gbdt.models, jb._gbdt.models):
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.predict_leaf_index(X),
                                      b.predict_leaf_index(X))
        same = ((a.threshold_in_bin[:k] == b.threshold_in_bin[:k])
                & (a.decision_type[:k] == b.decision_type[:k]))
        np.testing.assert_array_equal(a.threshold[:k][same],
                                      b.threshold[:k][same])
        np.testing.assert_allclose(a.split_gain[:k][~same],
                                   b.split_gain[:k][~same], rtol=1e-5)



@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_run_matches_jax(name, drain_every):
    quantized, weighted = CASES[name]
    X, y, w, params = _inputs(quantized, weighted)
    jb, tb = _train_both(X, y, w, params, 5)
    g = tb._gbdt
    assert bool(g._carried_active) is not weighted
    assert g._quantized is quantized
    # rounds 3 and 5 found DRAIN trees pending; train's end drained round 5
    assert g._drains == 3 and g._tree_fetches == 0
    assert not g._inflight and None not in g.models
    _assert_same_model(jb, tb, X)
    assert tb.num_trees() == 5
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=1e-4,
                               atol=1e-6)


