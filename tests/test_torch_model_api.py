"""The Booster's model text, dumps and introspection, and the Dataset's
fields and subsets, in the port against the JAX package on the CPU.

One model of each kind is trained once (2 rounds of 15 leaves, `max_bin`
63, 1,000 rows, the label engine): binary with a categorical feature,
and three classes.  For each:
- cross-loading: the port loads the JAX package's text of its model and
  the JAX package loads the port's, each writing the same text back,
  `start_iteration` and `num_iteration` cuts included; both predict the
  same raw scores (rtol 1e-12);
- `dump_model` of the same text equal to the JAX package's dict, exactly;
- `get_leaf_output` of every leaf, and split and gain importance (all
  iterations and the first), equal to the JAX package's;
- `save_model` writes the text atomically (no temporary file left), which
  `Booster(model_file=...)` and `model_from_string` load back; pickling
  keeps the text, the best iteration and the device.
The Dataset: `create_valid`, `subset` (the reference's binned rows, no
binning anew), the fields (`get_field`, `set_field`, `set_init_score`
before construction), `num_data`, `num_feature` and `get_feature_name`
equal to the JAX package's.
"""
import os
import pickle

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_goss import data

PARAMS = {"num_leaves": 15, "learning_rate": 0.3, "max_bin": 63,
          "min_data_in_leaf": 20, "verbose": -1}
KINDS = {
    "binary_categorical": ("binary", dict(objective="binary",
                                          tpu_tree_engine="label")),
    "multiclass": ("multiclass", dict(objective="multiclass", num_class=3,
                                      tpu_tree_engine="label")),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, (task, extra) in KINDS.items():
        X, y = data(task, n=1000, seed=8)
        cat = "auto"
        if task == "binary":
            # feature 4 as 7 categories, two of which lift the label
            cat = [4]
            X[:, 4] = np.abs(X[:, 4])
            y = np.where(np.isin(X[:, 4], (1, 3)), 1.0, y)
        tb = tlgb.train(dict(PARAMS, **extra),
                        tlgb.Dataset(X, y, categorical_feature=cat,
                                     device="cpu"), 2, verbose_eval=False,
                        device="cpu")
        text = tb.model_to_string()
        out[kind] = dict(X=X, tb=tb, text=text,
                         jb=jlgb.Booster(model_str=text),
                         loaded=tlgb.Booster(model_str=text, device="cpu"))
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_model_text_cross_loads(models, kind):
    c = models[kind]
    if kind == "binary_categorical":
        assert sum(t.num_cat for t in c["tb"]._gbdt.models) > 0
    jtext = c["jb"].model_to_string()
    assert jtext == c["text"]
    back = tlgb.Booster(model_str=jtext, device="cpu")
    assert back.model_to_string() == jtext
    for start, num in ((0, 1), (1, 1), (1, -1), (2, 5)):
        assert back.model_to_string(num, start) == \
            c["jb"].model_to_string(num, start)
    np.testing.assert_allclose(back.predict(c["X"], raw_score=True),
                               c["jb"].predict(c["X"], raw_score=True),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dump_leaf_output_and_importance_match_jax(models, kind):
    """Both loaded from one text (the text rounds split gains and internal
    values, which a trained booster holds unrounded)."""
    c = models[kind]
    tb, jb = c["loaded"], c["jb"]
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(1) == jb.dump_model(1)
    for i, tree in enumerate(tb._gbdt.models):
        for leaf in range(tree.num_leaves):
            assert tb.get_leaf_output(i, leaf) == jb.get_leaf_output(i, leaf)
    with pytest.raises(LightGBMError, match="out of range"):
        tb.get_leaf_output(len(tb._gbdt.models), 0)
    # the Booster's error is the logger's, as in the JAX package
    # (lightgbm_tpu/basic.py:27)
    assert issubclass(tlgb.LightGBMError, LightGBMError)
    assert issubclass(jlgb.basic.LightGBMError,
                      jlgb.utils.log.LightGBMError)
    for kind_ in ("split", "gain"):
        for it in (-1, 1):
            np.testing.assert_array_equal(tb.feature_importance(kind_, it),
                                          jb.feature_importance(kind_, it))
    assert tb.feature_importance("gain").sum() > 0
    assert tb.feature_name() == jb.feature_name()
    assert tb.num_feature() == jb.num_feature() == c["X"].shape[1]


def test_save_load_and_pickle(models, tmp_path):
    c = models["multiclass"]
    tb = c["tb"]
    path = tmp_path / "model.txt"
    tb.save_model(str(path))
    tb.save_model(str(path), num_iteration=1)
    assert os.listdir(tmp_path) == ["model.txt"]
    assert path.read_text() == tb.model_to_string(num_iteration=1)
    loaded = tlgb.Booster(model_file=str(path), device="cpu")
    assert loaded.model_to_string() == path.read_text()
    shell = tlgb.Booster(model_str=c["text"], device="cpu")
    shell.best_iteration = 3
    shell.model_from_string(path.read_text())
    assert shell.best_iteration == -1 and shell.num_trees() == 3
    tb.best_iteration = 2
    again = pickle.loads(pickle.dumps(tb))
    assert again.model_to_string() == tb.model_to_string()
    assert again.best_iteration == 2 and again.device == tb.device
    np.testing.assert_array_equal(again.predict(c["X"]), tb.predict(c["X"]))


def test_dataset_surface_matches_jax():
    X, y = data("binary", n=1000, seed=8)
    w = np.linspace(0.5, 1.5, len(y))
    init = np.linspace(-0.2, 0.2, len(y))
    got = {}
    for lib, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lib.Dataset(X, y, weight=w, params={"max_bin": 63}, **kw)
        ds.set_init_score(init)
        ds.construct()
        valid = ds.create_valid(X[:200], y[:200])
        sub = ds.subset(np.arange(0, 1000, 3)[::-1])
        sub.set_field("weight", np.ones(334))
        got[lib] = dict(
            n=ds.num_data(), f=ds.num_feature(), names=ds.get_feature_name(),
            label=ds.get_field("label"), weight=ds.get_weight(),
            init=ds.get_init_score(),
            vbins=valid.construct()._binned.bins,
            sbins=sub.construct()._binned.bins, slabel=sub.get_label(),
            sinit=sub.get_init_score(), sweight=sub.get_weight(),
            sn=sub.num_data())
        with pytest.raises(Exception, match="Unknown field"):
            ds.get_field("nothing")
    a, b = got[tlgb], got[jlgb]
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["sn"] == 334
