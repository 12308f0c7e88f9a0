"""The port's ground rules:

- lightgbm_tpu_torch imports and trains on the CPU with jax and the JAX
  package poisoned in sys.modules;
- no module of the package, and not chip_smoke.py, imports jax, jaxlib or
  lightgbm_tpu (AST check);
- entry points with no device and no CUDA raise, with no CPU fallback;
- every configuration this slice does not run raises NotImplementedError
  naming the ROADMAP.md item that brings it, and quantized training, which
  it does run, engages;
- `Dataset.set_weight` moves training between the carried and pristine
  arenas as weights demand.
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


UNSUPPORTED = {
    "label_engine": ({"tpu_tree_engine": "label"}, {}),
    "categorical": ({}, {"categorical_feature": [0]}),
    "bagging": ({"bagging_fraction": 0.5, "bagging_freq": 1}, {}),
    "goss": ({"boosting": "goss"}, {}),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, {}),
    "dart": ({"boosting": "dart"}, {}),
    "forced_splits": ({"forcedsplits_filename": "forced.json"}, {}),
    "histogram_pool": ({"histogram_pool_size": 64.0}, {}),
    # with one machine and one device the config turns a parallel learner
    # into the serial one, as the reference does (config.cpp:230-260)
    "data_parallel": ({"tree_learner": "data", "num_machines": 2}, {}),
    "voting_parallel": ({"tree_learner": "voting", "num_devices": 4}, {}),
    "efb_bundle": ({}, {"sparse": True}),
}


def _sparse_data(seed=1, n=600, F=6):
    """Mutually exclusive sparse columns: EFB bundles them."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, F))
    owner = rng.randint(0, F, n)
    X[np.arange(n), owner] = rng.rand(n) + 0.5
    y = (owner % 2).astype(float)
    return X, y


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_config_raises(name):
    params, ds_kw = UNSUPPORTED[name]
    ds_kw = dict(ds_kw)
    X, y = _sparse_data() if ds_kw.pop("sparse", False) else _data()
    if params.get("objective") == "multiclass":
        y = np.arange(len(y)) % 3
    params = dict({"objective": "binary", "verbose": -1}, **params)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlgb.train(params, tlgb.Dataset(X, y, device="cpu", **ds_kw),
                   num_boost_round=1, device="cpu")


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
