"""The port's ground rules:

- lightgbm_tpu_torch imports and trains on the CPU with jax and the JAX
  package poisoned in sys.modules;
- no module of the package, and not chip_smoke.py, imports jax, jaxlib or
  lightgbm_tpu (AST check);
- entry points with no device and no CUDA raise, with no CPU fallback;
- every configuration this slice does not run raises NotImplementedError
  naming the ROADMAP.md item that brings it, those that raised until they
  were ported (categorical features, EFB bundles, the boosting modes, the
  general grower's f64, uint16 bins, forced splits and histogram pooling,
  and the public API's learning-rate schedules, callbacks before a round,
  custom objectives and continued training) train as JAX trains them, and
  quantized training, bagging and the label engine engage; cv and
  reset_parameter run;
- `Dataset.set_weight` moves training between the carried and pristine
  arenas as weights demand, and a validation set keeps it off the carried
  arena.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "lightgbm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _data(seed=0, n=600, F=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


POISONED = r"""
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu"):
        del sys.modules[name]
for name in ("jax", "jaxlib", "lightgbm_tpu"):
    sys.modules[name] = None
import numpy as np
import lightgbm_tpu_torch as lt
rng = np.random.RandomState(0)
X = rng.randn(500, 4)
y = (X[:, 0] > 0).astype(float)
bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
               lt.Dataset(X, y, device="cpu"), num_boost_round=2,
               device="cpu")
p = bst.predict(X)
assert bst.num_trees() == 2 and p.shape == (500,) and np.isfinite(p).all()
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
            and sys.modules[m] is not None]
print("trained without jax")
"""


def test_imports_and_trains_with_jax_poisoned():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", POISONED], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trained without jax" in out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PKG.rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(REPO / path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (path, bad)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlgb.Dataset(X, y)
    ds = tlgb.Dataset(X, y, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlgb.train({"objective": "binary", "verbose": -1}, ds,
                   num_boost_round=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlgb.train({"objective": "binary", "verbose": -1}, ds,
                   num_boost_round=1, device="cuda")


def test_kernel_wrappers_refuse_other_devices():
    from lightgbm_tpu_torch.ops import _cuda
    assert _cuda.plain_or_cuda(torch.device("cuda", 0)) is True
    assert _cuda.plain_or_cuda(torch.device("cpu")) is False
    with pytest.raises(ValueError):
        _cuda.plain_or_cuda(torch.device("meta"))


def _schedule(env):
    """A per-round schedule callback, as reset_parameter makes one."""


_schedule.before_iteration = True


def _logloss(preds, data):
    """A custom objective: binary logloss of the raw scores."""
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - data.get_label(), p * (1.0 - p)


# name -> (params, Dataset keywords, train keywords)
UNSUPPORTED = {
    # with one machine and one device the config turns a parallel learner
    # into the serial one, as the reference does (config.cpp:230-260)
    "data_parallel": ({"tree_learner": "data", "num_machines": 2}, {}),
    "voting_parallel": ({"tree_learner": "voting", "num_devices": 4}, {}),
}
# configurations that raised until they were ported: each now trains as
# the JAX package trains it (name -> (params, Dataset keywords))
PORTED = {
    "categorical": ({}, {"categorical_feature": [0]}),
    "efb_bundle": ({}, {"sparse": True}),
    "goss": ({"boosting": "goss"}, {}),
    # a bag of 0.5 leaves the second tree's last split at a tie between
    # two features, broken apart by f32 rounding
    "rf": ({"boosting": "rf", "bagging_fraction": 0.8, "bagging_freq": 1},
           {}),
    "dart": ({"boosting": "dart"}, {}),
    "double_precision": ({"tpu_double_precision": True}, {}),
    # 600 distinct values a feature and min_data_in_bin=1: 511 bins, uint16
    "wide_bins": ({"max_bin": 511, "min_data_in_bin": 1}, {}),
    # a plan file of one split, written to the test's directory
    "forced_splits": ({"forcedsplits_filename": "forced.json"}, {}),
    # the label engine keeps one histogram a leaf, as JAX's does
    "histogram_pool": ({"histogram_pool_size": 64.0}, {}),
    # the public API (train keywords third): a schedule of the rate 0.2
    # (one rate: with no validation set the JAX package shrinks a deferred
    # tree by the rate of its drain, ROADMAP.md queue 3, which
    # tests/test_torch_schedule.py holds the port apart from), a callback
    # before each round, a custom objective, and two rounds on a one-round
    # model written to the test's directory
    "learning_rates": ({}, {}, {"learning_rates": [0.2, 0.2]}),
    "reset_parameter_callback": ({}, {}, {"callbacks": [_schedule]}),
    "fobj": ({}, {}, {"fobj": _logloss}),
    "init_model": ({}, {}, {"init_model": "model.txt"}),
}


def _sparse_data(seed=1, n=600, F=6, flip=0.0):
    """Mutually exclusive sparse columns: EFB bundles them; a share `flip`
    of the labels flipped."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, F))
    owner = rng.randint(0, F, n)
    X[np.arange(n), owner] = rng.rand(n) + 0.5
    y = (owner % 2).astype(float)
    flipped = rng.rand(n) < flip
    y[flipped] = 1.0 - y[flipped]
    return X, y


ROADMAP_ITEMS = {}


@pytest.mark.parametrize("name", sorted(set(UNSUPPORTED) | set(PORTED)))
def test_unsupported_config_raises(name, tmp_path):
    """A configuration of UNSUPPORTED raises NotImplementedError naming its
    ROADMAP.md item; one of PORTED trains 2 rounds as the JAX package's
    label engine trains it: the same model text (names and integers
    equal, reals within rtol 1e-4)."""
    if name in PORTED:
        import json
        import lightgbm_tpu as jlgb
        from test_torch_inflight import assert_texts_match
        extra, ds_kw, train_kw = (PORTED[name] + ({},))[:3]
        ds_kw, train_kw = dict(ds_kw), dict(train_kw)
        if "forcedsplits_filename" in extra:
            plan = tmp_path / extra["forcedsplits_filename"]
            plan.write_text(json.dumps({"feature": 1, "threshold": 0.0}))
            extra = dict(extra, forcedsplits_filename=str(plan))
        # labels with noise, so no split after the first ones rests on
        # gains of rounding noise
        X, y = (_sparse_data(flip=0.15) if ds_kw.pop("sparse", False)
                else _data())
        params = dict({"objective": "binary", "verbose": -1,
                       "num_leaves": 7, "tpu_tree_engine": "label"}, **extra)
        if "init_model" in train_kw:
            model = tmp_path / train_kw["init_model"]
            jlgb.train(params, jlgb.Dataset(X, y, **ds_kw),
                       num_boost_round=1).save_model(str(model))
            train_kw["init_model"] = str(model)
        tb = tlgb.train(params, tlgb.Dataset(X, y, device="cpu", **ds_kw),
                        num_boost_round=2, device="cpu", **train_kw)
        jb = jlgb.train(params, jlgb.Dataset(X, y, **ds_kw),
                        num_boost_round=2, **train_kw)
        binned = tb._gbdt.train_set
        if name == "efb_bundle":
            assert binned.bundle is not None and binned.bundle.any_bundled
        elif name == "categorical":
            assert binned.bin_mappers[0].bin_type == 1
        else:
            assert type(tb._gbdt).__name__ == type(jb._gbdt).__name__
        assert_texts_match(tb.model_to_string(), jb.model_to_string())
        return
    params, ds_kw, train_kw = (UNSUPPORTED[name] + ({},))[:3]
    ds_kw = dict(ds_kw)
    X, y = _sparse_data() if ds_kw.pop("sparse", False) else _data()
    params = dict({"objective": "binary", "verbose": -1}, **params)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        tlgb.train(params, tlgb.Dataset(X, y, device="cpu", **ds_kw),
                   num_boost_round=1, device="cpu", **train_kw)
    assert ROADMAP_ITEMS.get(name, "") in str(err.value)


def test_label_engine_engages():
    """tpu_tree_engine=label trains on the label engine: no arena, never
    the carried path, and tpu_quantized_grad cleared (the JAX rule)."""
    X, y = _data()
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                      "tpu_tree_engine": "label",
                      "tpu_quantized_grad": True},
                     tlgb.Dataset(X, y, device="cpu"), num_boost_round=2,
                     device="cpu")
    g = bst._gbdt
    assert not g._use_partition_engine
    assert g.arena is None and not g._quantized and not g._carried_active
    assert bst.num_trees() == 2 and all(m.num_leaves > 1 for m in g.models)
    p = bst.predict(X)
    assert np.isfinite(p).all() and ((p > 0.5) == (y > 0)).mean() > 0.8


def test_cv_and_schedules_are_refused():
    """Refused until the public API was ported: cv now runs its folds and
    reset_parameter makes a callback run before each round."""
    X, y = _data()
    res = tlgb.cv({"objective": "binary", "num_leaves": 7, "verbose": -1},
                  tlgb.Dataset(X, y, device="cpu"), num_boost_round=2,
                  nfold=3, device="cpu")
    assert sorted(res) == ["binary_logloss-mean", "binary_logloss-stdv"]
    assert len(res["binary_logloss-mean"]) == 2
    cb = tlgb.callback.reset_parameter(learning_rate=[0.1])
    assert cb.before_iteration


def test_bagging_engages():
    """bagging_fraction with bagging_freq trains each tree on a bag of
    int(fraction * n) rows, on the eager path, off the carried arena."""
    X, y = _data()
    bst = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                      "bagging_fraction": 0.5, "bagging_freq": 1},
                     tlgb.Dataset(X, y, device="cpu"), num_boost_round=2,
                     device="cpu")
    g = bst._gbdt
    assert not g._carried_active
    assert g._bag_count == int(0.5 * len(y)) == int((g._bag_mask == 0).sum())
    assert [m.leaf_count[:m.num_leaves].sum() for m in g.models] == \
        [g._bag_count] * 2


@pytest.mark.parametrize("weighted", [False, True])
def test_quantized_training_engages(weighted):
    """tpu_quantized_grad trains on int8 codes: on the carried arena without
    weights, on the pristine one with them (the JAX rule)."""
    X, y = _data()
    w = np.random.RandomState(2).rand(len(y)) + 0.5 if weighted else None
    bst = tlgb.train({"objective": "binary", "tpu_quantized_grad": True,
                      "num_leaves": 7, "verbose": -1},
                     tlgb.Dataset(X, y, weight=w, device="cpu"),
                     num_boost_round=2, device="cpu")
    g = bst._gbdt
    assert g._quantized and g.arena.quantized
    assert g.arena.payload.dtype == torch.int8
    assert g._carried_active is not weighted
    assert bst.num_trees() == 2
    assert all(m.num_leaves > 1 for m in g.models)
    p = bst.predict(X)
    assert np.isfinite(p).all() and ((p > 0.5) == (y > 0)).mean() > 0.8


def test_set_weight_switches_path():
    """Dataset.set_weight on a constructed dataset keeps its bins and moves
    training to the pristine arena; clearing the weights moves it back; the
    weighted model equals one trained on a dataset built with the weights."""
    X, y = _data()
    w = np.random.RandomState(2).rand(len(y)) + 0.5
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    ds = tlgb.Dataset(X, y, device="cpu").construct()
    binned = ds._binned
    ds.set_weight(w)
    weighted = tlgb.train(params, ds, num_boost_round=2, device="cpu")
    assert ds._binned is binned
    assert not weighted._gbdt._carried_active
    fresh = tlgb.train(params, tlgb.Dataset(X, y, weight=w, device="cpu"),
                       num_boost_round=2, device="cpu")
    assert weighted.model_to_string() == fresh.model_to_string()
    ds.set_weight(None)
    plain = tlgb.train(params, ds, num_boost_round=2, device="cpu")
    assert plain._gbdt._carried_active


def test_validation_set_keeps_training_off_carried_arena():
    """The same unweighted params run the carried arena alone and the
    pristine root (the eager path) with a validation set attached."""
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1}
    plain = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"),
                       num_boost_round=2, device="cpu")
    assert plain._gbdt._carried_active
    ds = tlgb.Dataset(X, y, device="cpu")
    ev = {}
    valid = tlgb.train(params, ds, num_boost_round=2,
                       valid_sets=[tlgb.Dataset(X[:200], y[:200],
                                                reference=ds, device="cpu")],
                       evals_result=ev, verbose_eval=False, device="cpu")
    assert not valid._gbdt._carried_active
    assert len(ev["valid_0"]["binary_logloss"]) == 2
    assert valid.model_to_string() == plain.model_to_string()
