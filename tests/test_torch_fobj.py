"""Custom objectives and eval functions in the port against the JAX package,
on the CPU (its Pallas kernels in interpret mode, the engine named by
`tpu_tree_engine`).

- `train(fobj=..., feval=...)`, 2 rounds of 15-leaf trees on 1,200 rows
  (`max_bin` 63) with a validation set: binary logloss and three-class
  softmax written in numpy: binary on the partition engine with quantized
  gradients and on the label engine (f32), three classes on the label
  engine (tests/test_torch_fobj_partition.py holds the partition engine's
  f32 rounds).  The objective is `none`
  in both packages (no boost-from-average), the trees are equal as
  tests/test_torch_bagging.py's `_assert_models_match` holds them,
  predictions agree within its rtol 1e-4, atol 1e-6, and evals_result
  (the built-in metric, then feval's) within 1e-6.  The seeds hold no
  exact tie between two thresholds with no training row between them
  (ROADMAP.md queue 3);
- the custom rounds run the eager path with the trees deferred: without a
  validation set the port fetches no tree before its drain, and its
  model predicts its own training score within 1e-5;
- `objective=none` with no fobj raises in the port.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_bagging import _assert_models_match
from test_torch_goss import data

PARAMS = {"num_leaves": 15, "learning_rate": 0.3, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}
ROUNDS = 2
K = 3


def binary_fobj(preds, ds):
    y = ds.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def softmax_fobj(preds, ds):
    """Class-major [K*n] raw scores -> class-major gradients."""
    y = ds.get_label().astype(np.int64)
    z = preds.reshape(K, -1)
    e = np.exp(z - z.max(axis=0))
    p = e / e.sum(axis=0)
    onehot = (np.arange(K)[:, None] == y[None, :])
    return (p - onehot).reshape(-1), (2.0 * p * (1.0 - p)).reshape(-1)


def binary_feval(preds, ds):
    y = ds.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return ("my_error", float(np.mean((p > 0.5) != (y > 0.5))), False)


def softmax_feval(preds, ds):
    y = ds.get_label()
    return [("my_error", float(np.mean(preds.reshape(K, -1).argmax(axis=0)
                                       != y)), False),
            ("my_top", float(preds.reshape(K, -1).max()), True)]


CASES = {
    "binary_quantized": ("binary", dict(tpu_tree_engine="partition",
                                        tpu_quantized_grad=True,
                                        metric="auc")),
    "binary_label": ("binary", dict(tpu_tree_engine="label", metric="auc")),
    "multiclass_label": ("multiclass", dict(tpu_tree_engine="label",
                                            num_class=K,
                                            metric="multi_error")),
}


def _run(lib, params, X, y, Xv, yv, fobj, feval, **dev):
    ds = lib.Dataset(X, y, **dev)
    dv = lib.Dataset(Xv, yv, reference=ds, **dev)
    ev = {}
    bst = lib.train(params, ds, ROUNDS, valid_sets=[dv],
                    valid_names=["holdout"], fobj=fobj, feval=feval,
                    evals_result=ev, verbose_eval=False, **dev)
    return bst, ev


@pytest.mark.parametrize("name", sorted(CASES))
def test_fobj_feval_match_jax(name):
    check_fobj_feval(*CASES[name])


def check_fobj_feval(task, extra):
    """A run of fobj and feval against the JAX package's (the module's
    docstring)."""
    params = dict(PARAMS, **extra)
    X, y = data(task, n=1200, seed=5)
    Xv, yv = X[::4], y[::4]
    fobj, feval = ((binary_fobj, binary_feval) if task == "binary"
                   else (softmax_fobj, softmax_feval))
    jb, jev = _run(jlgb, params, X, y, Xv, yv, fobj, feval)
    tb, tev = _run(tlgb, params, X, y, Xv, yv, fobj, feval, device="cpu")
    tg, jg = tb._gbdt, jb._gbdt
    assert tg.objective is None and jg.objective is None
    assert bool(tg._quantized) == bool(jg._quantized) \
        == bool(extra.get("tpu_quantized_grad"))
    assert tg._use_partition_engine == (extra["tpu_tree_engine"]
                                        == "partition")
    _assert_models_match(jg.models, tg.models, X)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=1e-4, atol=1e-6)
    assert list(tev["holdout"]) == list(jev["holdout"])
    assert "my_error" in tev["holdout"]
    for metric, want in jev["holdout"].items():
        np.testing.assert_allclose(tev["holdout"][metric], want, rtol=0,
                                   atol=1e-6)


def test_custom_rounds_defer_and_predict_their_score():
    """Without a validation set the custom rounds update the score on the
    device and defer every tree to the drain; the drained model predicts
    the training score."""
    X, y = data("binary", n=1200, seed=4)
    params = dict(PARAMS, tpu_tree_engine="partition")
    bst = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"), ROUNDS,
                     fobj=binary_fobj, verbose_eval=False, device="cpu")
    g = bst._gbdt
    assert g._tree_fetches == 0 and g._drains == 1
    assert not g._carried_active and len(g.models) == ROUNDS
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               g.score.numpy(), rtol=0, atol=1e-5)


def test_objective_none_needs_gradients():
    X, y = data("binary", n=300, seed=4)
    bst = tlgb.Booster(dict(PARAMS, objective="none"),
                       tlgb.Dataset(X, y, device="cpu"), device="cpu")
    with pytest.raises(LightGBMError, match="custom gradients"):
        bst.update()
