"""`GBDT.model_to_if_else` (models/codegen.py, copied from the JAX
package) against the JAX package's, on the CPU: for the same model text,
a numerical binary model with NaN and zero missing values and a 3-class
categorical one, the port's C++ text equals the JAX package's character
for character; compiled with the system's C++ compiler (the test skips
where there is none, as tests/test_codegen_compile.py does), its raw and
transformed outputs equal the port's host walk and predict within 1e-12.
"""
import shutil
import subprocess

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_codegen_compile import _MAIN
from test_torch_categorical import PARAMS as CAT_PARAMS
from test_torch_categorical import airline
from test_torch_label import PARAMS, _data

MODELS = {
    "binary": lambda: (_data(2, n=1500), dict(PARAMS, objective="binary"),
                       []),
    "multiclass_categorical": lambda: (
        _three_classes(*airline(1500)),
        dict(CAT_PARAMS, objective="multiclass", num_class=3),
        [0, 1, 2, 4, 5, 6]),
}


def _three_classes(X, y):
    return X, (y + (X[:, 3] > 1200)).astype(np.float64)


def _train(name):
    (X, y), params, cats = MODELS[name]()
    tb = tlgb.train(params, tlgb.Dataset(X, y, categorical_feature=cats,
                                         device="cpu"),
                    num_boost_round=3, device="cpu")
    return X, tb


@pytest.mark.parametrize("name", sorted(MODELS))
def test_text_equals_jax(name):
    X, tb = _train(name)
    text = tb.model_to_string()
    want = jlgb.Booster(model_str=text)._gbdt.model_to_if_else()
    assert tb._gbdt.model_to_if_else() == want
    loaded = tlgb.Booster(model_str=text, device="cpu")
    assert loaded._gbdt.model_to_if_else() == want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_compiled_code_predicts_as_the_model(name, tmp_path):
    cxx = next((shutil.which(c) for c in ("g++", "c++", "clang++")
                if shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no C++ compiler on PATH")
    X, tb = _train(name)
    X = X[:300]
    src = tmp_path / "model.cpp"
    src.write_text(tb._gbdt.model_to_if_else() + "\n" + _MAIN)
    exe = tmp_path / "model"
    subprocess.run([cxx, "-O1", "-include", "vector", "-o", str(exe),
                    str(src)], check=True)
    stdin = "%d %d\n" % X.shape + "\n".join(
        " ".join(repr(float(v)) for v in row) for row in X)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         text=True, check=True).stdout
    vals = np.array([line.split() for line in out.strip().split("\n")],
                    float)
    k = tb._gbdt.num_tree_per_iteration
    raw = tb.predict(X, raw_score=True, device=False).reshape(len(X), k)
    prob = tb.predict(X).reshape(len(X), k)
    np.testing.assert_allclose(vals[:, :k], raw, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(vals[:, k:], prob, rtol=1e-12, atol=1e-12)
