"""The port's `Dataset` input against the JAX package's, on the CPU.

- a numeric pandas DataFrame is read as its matrix: the same bins and
  feature names as JAX's `Dataset`, a model text equal to the one trained
  on the bare matrix but for its feature names, and the header of
  JAX's model text (trained with the label engine on the same frame);
- a `category` column detected under "auto", and one named or indexed in
  `categorical_feature`, is binned as a category where JAX bins it so and
  trains to JAX's model text (the label engine, 3 rounds);
- scipy sparse input and a file path raise NotImplementedError naming
  queue 1, item 3;
- `Booster.predict` reads a DataFrame's category column as its codes, as
  before;
- checkpoint resume names queue 1, item 14; item 7b's training options
  (fobj, feval, init_model, learning_rates), callbacks before a round and
  cv, ported since, run on a frame.
"""
import json

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import callback as tcallback

from test_torch_inflight import assert_texts_match

PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "learning_rate": 0.25, "verbose": -1}


def _frame(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    df = pd.DataFrame(X, columns=["a", "b", "c"])
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    return df, y


def _header(text):
    """The model text's lines before its first tree, tree sizes aside."""
    head = text[:text.index("Tree=0")].splitlines()
    return [line for line in head if not line.startswith("tree_sizes=")]


def test_numeric_frame_reads_as_jax_reads_it():
    df, y = _frame()
    tds = tlgb.Dataset(df, y, params=PARAMS, device="cpu").construct()
    jds = jlgb.Dataset(df, y, params=PARAMS).construct()
    assert tds._binned.feature_names == jds._binned.feature_names == \
        ["a", "b", "c"]
    np.testing.assert_array_equal(tds._binned.bins, np.asarray(
        jds._binned.bins))
    on_frame = tlgb.train(PARAMS, tlgb.Dataset(df, y, device="cpu"), 3,
                          device="cpu").model_to_string()
    on_matrix = tlgb.train(PARAMS, tlgb.Dataset(df.to_numpy(), y,
                                                device="cpu"), 3,
                           device="cpu").model_to_string()
    assert "feature_names=a b c" in on_frame.splitlines()
    for i, name in enumerate("abc"):
        on_matrix = on_matrix.replace("Column_%d" % i, name)
    assert on_frame == on_matrix
    jtext = jlgb.train(dict(PARAMS, tpu_tree_engine="label"),
                       jlgb.Dataset(df, y), 3).model_to_string()
    assert _header(on_frame) == _header(jtext)
    # names given by the caller win over the frame's, in both packages
    named = tlgb.Dataset(df, y, feature_name=["x", "y", "z"],
                         device="cpu").construct()
    jnamed = jlgb.Dataset(df, y, feature_name=["x", "y", "z"]).construct()
    assert named._binned.feature_names == jnamed._binned.feature_names


@pytest.mark.parametrize("how", ["auto", "by_name", "by_index"])
def test_category_column_raises_where_jax_detects_it(how):
    """A category column, detected or named or indexed, is binned as a
    category where JAX bins it so, and trains to JAX's model; prediction
    on the frame maps its categories to their codes."""
    df, y = _frame()
    df["c"] = pd.Categorical(10 * np.random.RandomState(1).randint(0, 5,
                                                                   len(df)))
    kw = {"auto": {}, "by_name": {"categorical_feature": ["c"]},
          "by_index": {"categorical_feature": [2]}}[how]
    jds = jlgb.Dataset(df, y, **kw).construct()
    assert jds._binned.bin_mappers[2].bin_type != \
        jds._binned.bin_mappers[0].bin_type
    tds = tlgb.Dataset(df, y, device="cpu", **kw).construct()
    assert [m.bin_type for m in tds._binned.bin_mappers] == \
        [m.bin_type for m in jds._binned.bin_mappers]
    params = dict(PARAMS, tpu_tree_engine="label")
    tb = tlgb.train(params, tds, 3, device="cpu")
    jb = jlgb.train(params, jds, 3)
    assert_texts_match(tb.model_to_string(), jb.model_to_string())
    np.testing.assert_allclose(tb.predict(df, raw_score=True),
                               jb.predict(df, raw_score=True), rtol=0,
                               atol=5e-6)


def test_unmatched_category_names_are_dropped_as_in_jax():
    df, y = _frame()
    ds = tlgb.Dataset(df, y, categorical_feature=["nope"],
                      device="cpu").construct()
    assert ds._binned.feature_names == ["a", "b", "c"]


@pytest.mark.parametrize("kind", ["csr", "csc", "path"])
def test_sparse_input_and_file_paths_raise(kind, tmp_path):
    df, y = _frame()
    if kind == "path":
        path = tmp_path / "train.tsv"
        np.savetxt(path, np.column_stack([y, df.to_numpy()]),
                   delimiter="\t")
        data = str(path)
    else:
        data = getattr(sp, kind + "_matrix")(df.to_numpy())
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        tlgb.Dataset(data, y, device="cpu").construct()


def test_predict_reads_category_codes():
    """Booster.predict keeps reading a frame's category column as its
    codes, as JAX's `_to_matrix` does."""
    df, y = _frame()
    bst = tlgb.train(PARAMS, tlgb.Dataset(df.to_numpy(), y, device="cpu"),
                     2, device="cpu")
    codes = np.random.RandomState(2).randint(0, 4, len(df))
    cat = df.copy()
    cat["c"] = pd.Categorical.from_codes(codes, ["w", "x", "y", "z"])
    plain = df.copy()
    plain["c"] = codes.astype(np.float64)
    np.testing.assert_array_equal(bst.predict(cat, raw_score=True),
                                  bst.predict(plain.to_numpy(),
                                              raw_score=True))


def _logloss(preds, data):
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - data.get_label(), p * (1.0 - p)


@pytest.mark.parametrize("kw,item", [
    ({"fobj": _logloss}, "item 7b"),
    ({"feval": lambda p, d: ("m", 0.0, True)}, "item 7b"),
    ({"init_model": "model.txt"}, "item 7b"),
    ({"learning_rates": [0.1]}, "item 7b"),
    ({"resume_from": "ckpt"}, "item 14"),
])
def test_unported_training_options_name_their_item(kw, item, tmp_path):
    """resume_from raises NotImplementedError naming its item (14); the
    options of item 7b, ported since, train on a frame."""
    df, y = _frame(n=50)
    if item == "item 14":
        with pytest.raises(NotImplementedError, match=item):
            tlgb.train(PARAMS, tlgb.Dataset(df, y, device="cpu"), 1,
                       device="cpu", **kw)
        return
    kw = dict(kw)
    if "init_model" in kw:
        kw["init_model"] = str(tmp_path / kw["init_model"])
        tlgb.train(PARAMS, tlgb.Dataset(df, y, device="cpu"), 1,
                   device="cpu").save_model(kw["init_model"])
    if "feval" in kw:
        kw.update(valid_sets=[tlgb.Dataset(df, y, device="cpu")],
                  evals_result={})
    bst = tlgb.train(PARAMS, tlgb.Dataset(df, y, device="cpu"), 1,
                     device="cpu", verbose_eval=False, **kw)
    assert bst.current_iteration == 1
    if "feval" in kw:
        assert kw["evals_result"]["valid_0"]["m"] == [0.0]


def test_unported_callbacks_and_cv_name_item_7b():
    """Item 7b's callbacks before a round, reset_parameter and cv, ported
    since, run on a frame."""
    df, y = _frame(n=50)
    seen = []

    def before(env):
        seen.append((env.iteration, env.evaluation_result_list))
    before.before_iteration = True
    tlgb.train(PARAMS, tlgb.Dataset(df, y, device="cpu"), 2, device="cpu",
               callbacks=[before])
    assert seen == [(0, None), (1, None)]
    assert tcallback.reset_parameter(learning_rate=[0.1]).before_iteration
    res = tlgb.cv(PARAMS, tlgb.Dataset(df, y, device="cpu"),
                  num_boost_round=2, nfold=3, device="cpu")
    assert len(res["binary_logloss-mean"]) == 2


def test_mixed_columns_bin_as_jax_does():
    """Numerical columns (one with NaNs, one of few values) beside a
    categorical one: the mappers equal JAX's, column for column, and so do
    the bins, with and without EFB bundles."""
    rng = np.random.RandomState(6)
    n = 3000
    X = rng.randn(n, 12)
    X[rng.rand(n) < 0.05, 3] = np.nan
    X[:, 5] = rng.randint(0, 30, n)
    X[:, 7] = np.round(X[:, 7] * 3)
    y = (X[:, 0] > 0).astype(np.float64)
    onehot = np.zeros((n, 8))
    onehot[np.arange(n), rng.randint(0, 8, n)] = 1.0
    for data in (X, np.column_stack([X, onehot])):
        got = tlgb.Dataset(data, y, categorical_feature=[5],
                           device="cpu").construct()._binned
        want = jlgb.Dataset(data, y,
                            categorical_feature=[5]).construct()._binned
        # as JSON: a NaN bin bound equals itself there
        assert [json.dumps(m.to_state()) for m in got.bin_mappers] == \
            [json.dumps(m.to_state()) for m in want.bin_mappers]
        assert got.bin_mappers[5].bin_type == 1
        assert got.bin_mappers[0].bin_type == 0
        assert (got.bundle is None) is (data is X)
        np.testing.assert_array_equal(got.bins, np.asarray(want.bins))
