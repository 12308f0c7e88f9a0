"""Categorical features in the port against the JAX package, on the CPU
(its Pallas kernels in interpret mode, `tpu_tree_engine=partition` unless
a case asks for the label engine):

- the categorical split scan (`best_split_categorical_per_feature`) against
  lightgbm_tpu.ops.split's and against tests/test_categorical.py's numpy
  oracle of FindBestThresholdCategorical, in one-hot and sorted modes and
  for each missing type: the same left-going bins and counts, the gain
  within 1e-5 of the largest gain;
- training on data of the airline benchmark's layout (`airline`: six
  category columns of 12, 31, 7, 22, 40 and 40 categories, skewed
  airports, and two numbers), 7 leaves, 3 rounds, both engines: the
  label engine and a pandas frame here; the fused carried, the weighted
  pristine root, the quantized carried arena, a bag, a validation set
  with early stopping and k = 3 in tests/test_torch_categorical_paths.py,
  _drains.py, _valid.py and _multiclass.py.  Each case: the same model
  text as JAX's (tests/test_torch_inflight.assert_texts_match: integers
  and names equal, reals within rtol 1e-4; the label engine's leaf values
  within 1e-4 of the largest), equal split features, bin sets and every
  training row's leaf (at an exact tie, the same partition), raw
  predictions within 5e-6 of their scale;
- an unseen, a negative and a missing category go right, as in JAX
  (tests/test_torch_categorical_paths.py);
- KP2's plain walk (`predict_leaf_inner`) over a trained tree's
  categorical nodes against lightgbm_tpu.ops.grow.predict_leaf_inner
  (tests/test_torch_categorical_paths.py);
- a pandas `category` column trains as JAX trains it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as jlgb
from lightgbm_tpu.ops import split as jsplit
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.basic import _to_matrix
from lightgbm_tpu_torch.ops import split as tsplit

from test_categorical import oracle_categorical
from test_torch_inflight import assert_texts_match

ROUNDS = 3
CATS = (0, 1, 2, 4, 5, 6)
# DayOfWeek's 7 categories in one-hot mode, the others sorted, walked at
# most 4 steps: no bin set is then reached from both ends with its
# complement, an exact tie that rounding breaks (ROADMAP.md queue 3) and
# that a quantized carried run would carry into its row order and codes
PARAMS = {"num_leaves": 7, "learning_rate": 0.2, "min_data_in_leaf": 20,
          "cat_smooth": 5.0, "min_data_per_group": 20,
          "max_cat_to_onehot": 8, "max_cat_threshold": 4, "verbose": -1}
PRED_ATOL = 5e-6


def airline(n=2000, seed=11, airports=40):
    """Rows of the airline on-time layout (Month, DayofMonth, DayOfWeek,
    DepTime, UniqueCarrier, Origin, Dest, Distance), categories as their
    integer codes, airports Zipf-skewed; the label a noisy logistic draw
    from per-category effects, so no order of the codes carries it."""
    rng = np.random.RandomState(seed)
    cards = (12, 31, 7, 22, airports, airports)
    zipf = 1.0 / np.arange(1, airports + 1)
    zipf /= zipf.sum()
    cols, effect = [], np.zeros(n)
    for j, card in enumerate(cards):
        p = zipf if j >= 4 else None
        codes = rng.choice(card, n, p=p)
        cols.append(codes.astype(np.float64))
        effect += rng.randn(card)[codes] * (0.8 if j in (0, 4, 5) else 0.4)
    dep = rng.randint(0, 2400, n).astype(np.float64)
    dist = np.round(rng.gamma(2.0, 400.0, n))
    X = np.column_stack(cols[:3] + [dep] + cols[3:] + [dist])
    score = effect + (dep > 1700) * 0.7 - 0.4 + 0.8 * rng.randn(n)
    return X, (score > 0).astype(np.float64)


# --------------------------------------------------------------------------- #
# the categorical scan
# --------------------------------------------------------------------------- #
MODES = {
    "onehot": dict(max_cat_to_onehot=32),
    "sorted": dict(max_cat_to_onehot=1, cat_smooth=2.0, min_data_per_group=5),
    "sorted_reg": dict(max_cat_to_onehot=1, cat_smooth=10.0,
                       min_data_per_group=50, cat_l2=3.0),
}


def _random_hists(rng, F, B):
    counts = rng.randint(0, 60, (F, B)).astype(np.float64)
    g = rng.randn(F, B) * np.sqrt(counts)
    h = np.abs(rng.randn(F, B)) * counts * 0.1 + counts * 0.05
    hist = np.stack([g, h, counts], axis=-1)
    num_bins = rng.randint(4, B + 1, F).astype(np.int32)
    for f in range(F):
        hist[f, num_bins[f]:] = 0.0
    return hist.astype(np.float32), num_bins


# compiled once: the parameters ride the call as traced leaves
_jax_scan = jax.jit(jsplit.best_split_categorical_per_feature,
                    static_argnames=("max_cat_threshold",))


@pytest.mark.parametrize("missing", [0, 1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_scan_matches_jax_and_oracle(mode, missing):
    rng = np.random.RandomState(3 + missing)
    F, B = 6, 16
    kw = dict(min_data_in_leaf=5, **MODES[mode])
    jp, tp = jsplit.SplitParams(**kw), tsplit.SplitParams(**kw)
    for _ in range(3):
        hist, nb = _random_hists(rng, F, B)
        mt = np.full(F, missing, np.int32)
        sg = float(hist[0, :, 0].sum(dtype=np.float32))
        sh = float(hist[0, :, 1].sum(dtype=np.float32))
        sc = int(hist[0, :, 2].sum())
        want = _jax_scan(
            jnp.asarray(hist), jnp.float32(sg), jnp.float32(sh), sc,
            jnp.asarray(nb), jnp.asarray(mt), jp, max_cat_threshold=8)
        got = tsplit.best_split_categorical_per_feature(
            torch.from_numpy(hist), torch.tensor(sg), torch.tensor(sh), sc,
            torch.from_numpy(nb), torch.from_numpy(mt), tp,
            max_cat_threshold=8)
        wg = np.asarray(want.gain)
        scale = np.abs(wg[np.isfinite(wg)]).max(initial=1.0)
        np.testing.assert_array_equal(np.isfinite(got.gain.numpy()),
                                      np.isfinite(wg))
        live = np.isfinite(wg)
        np.testing.assert_allclose(got.gain.numpy()[live], wg[live], rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_array_equal(got.cat_mask.numpy(),
                                      np.asarray(want.cat_mask))
        for name in ("left_count", "right_count", "threshold",
                     "default_left"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(),
                np.asarray(getattr(want, name)).astype(
                    getattr(got, name).numpy().dtype))
        for name in ("left_sum_gradient", "left_sum_hessian",
                     "left_output", "right_output"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-5, atol=1e-5)
        for f in range(F):
            ref_gain, ref_left = oracle_categorical(
                hist[f].astype(np.float64), sg, sh, sc, int(nb[f]), missing,
                tp, max_cat_threshold=8)
            if ref_left is None:
                assert not np.isfinite(got.gain[f].item())
                continue
            assert got.gain[f].item() == pytest.approx(ref_gain, rel=1e-4)
            assert np.flatnonzero(got.cat_mask[f].numpy()).tolist() == \
                ref_left


# --------------------------------------------------------------------------- #
# training against JAX
# --------------------------------------------------------------------------- #
# case -> (extra parameters, Dataset keywords, train path)
CASES = {
    "carried": ({}, {}, "plain"),
    # weighted, as are the label engine's other runs here: its histograms
    # sum in another order than JAX's, so categories of equal unweighted
    # statistics would sort by ratios equal but for rounding
    "label": ({"tpu_tree_engine": "label"}, {"weighted": True}, "plain"),
    "weighted": ({}, {"weighted": True}, "plain"),
    "quantized": ({"tpu_quantized_grad": True}, {}, "plain"),
    "bagged": ({"bagging_fraction": 0.7, "bagging_freq": 1,
                "bagging_seed": 5}, {}, "plain"),
    "valid": ({"metric": "auc"}, {}, "valid"),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, {},
                   "plain"),
}
_TRAINED = {}


def _labels(y, X, multiclass):
    if not multiclass:
        return y
    return (y + (X[:, 3] > 1200)).astype(np.float64)


def train_case(name):
    """(X, JAX booster, port booster, (JAX evals, port evals)) of a case
    of CASES, trained once a process."""
    if name in _TRAINED:
        return _TRAINED[name]
    extra, ds_kw, path = CASES[name]
    X, y = airline()
    params = dict(PARAMS, objective="binary")
    params.update(extra)
    y = _labels(y, X, params["objective"] == "multiclass")
    w = (np.random.RandomState(4).rand(len(y)) + 0.5
         if ds_kw.get("weighted") else None)
    jparams = dict(params)
    jparams.setdefault("tpu_tree_engine", "partition")
    jds = jlgb.Dataset(X, y, weight=w, categorical_feature=list(CATS))
    tds = tlgb.Dataset(X, y, weight=w, categorical_feature=list(CATS),
                       device="cpu")
    jkw, tkw, jev, tev = {}, {}, {}, {}
    if path == "valid":
        Xv, yv = airline(600, seed=12)
        jkw = dict(valid_sets=[jlgb.Dataset(Xv, yv, reference=jds)],
                   evals_result=jev, verbose_eval=False,
                   early_stopping_rounds=2)
        tkw = dict(valid_sets=[tlgb.Dataset(Xv, yv, reference=tds,
                                            device="cpu")],
                   evals_result=tev, verbose_eval=False,
                   early_stopping_rounds=2)
    jb = jlgb.train(jparams, jds, num_boost_round=ROUNDS, **jkw)
    tb = tlgb.train(params, tds, num_boost_round=ROUNDS, device="cpu", **tkw)
    _TRAINED[name] = (X, jb, tb, (jev, tev))
    return _TRAINED[name]


def assert_texts_close(got: str, want: str, value_atol: float = 0.0):
    """assert_texts_match, with leaf values, internal values and gains
    also within value_atol: the label engine's band (tests/test_torch_
    label.py holds its leaf values to 1e-4 of the tree's scale, as its
    histograms sum in another order than JAX's)."""
    if not value_atol:
        assert_texts_match(got, want)
        return
    keys = ("leaf_value", "internal_value", "split_gain")
    gl, wl = got.split("\n"), want.split("\n")
    assert len(gl) == len(wl)
    loose = [(a, b) for a, b in zip(gl, wl) if a.split("=")[0] in keys]
    strict = [(a, b) for a, b in zip(gl, wl) if a.split("=")[0] not in keys]
    assert_texts_match("\n".join(a for a, _ in strict),
                       "\n".join(b for _, b in strict))
    for a, b in loose:
        np.testing.assert_allclose(
            np.array(a.split("=")[1].split(), float),
            np.array(b.split("=")[1].split(), float), rtol=1e-4,
            atol=1e-6 + value_atol, err_msg=a.split("=")[0])


def assert_models_match(jb, tb, X):
    """The same model text, split features, bin sets and leaf of every
    training row; raw predictions within 5e-6 of their scale and the
    device walk equal to the host walk.  The label engine is held to its
    own band (tests/test_torch_label.py): leaf values within 1e-4 of the
    largest.  At an exact tie (ROADMAP.md queue 3) between a bin set and
    its complement, which the ascending and the descending walk both
    reach with gains equal but for rounding, a tree may take the other
    side: it must then split the training rows into the same leaves with
    the same values, its children swapped."""
    assert tb.num_trees() == jb.num_trees()
    label = not tb._gbdt._use_partition_engine
    scale = max(np.abs(t.leaf_value).max() for t in jb._gbdt.models)
    atol = 1e-4 * scale if label else 0.0
    got_blocks = tb.model_to_string().split("Tree=")
    want_blocks = jb.model_to_string().split("Tree=")
    assert_texts_close(got_blocks[0], want_blocks[0])
    mirrored = 0
    for i, (a, b) in enumerate(zip(tb._gbdt.models, jb._gbdt.models)):
        n = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(np.sort(a.split_feature[:n]),
                                      np.sort(b.split_feature[:n]))
        la, lb = a.predict_leaf_index(X), b.predict_leaf_index(X)
        if not np.array_equal(la, lb):
            mirrored += 1
            assert len(set(zip(la, lb))) == len(set(la)) == len(set(lb))
            np.testing.assert_allclose(a.leaf_value[la], b.leaf_value[lb],
                                       rtol=1e-4, atol=max(atol, 1e-6))
            continue
        np.testing.assert_array_equal(a.split_feature[:n],
                                      b.split_feature[:n])
        np.testing.assert_array_equal(a.decision_type[:n],
                                      b.decision_type[:n])
        assert a.cat_threshold == b.cat_threshold
        assert a.cat_threshold_inner == b.cat_threshold_inner
        np.testing.assert_array_equal(la, lb)
        assert_texts_close(got_blocks[i + 1], want_blocks[i + 1], atol)
    assert mirrored < len(tb._gbdt.models)
    want = jb.predict(X, raw_score=True)
    got = tb.predict(X, raw_score=True)
    atol = (1e-4 * scale * tb.num_trees() if label else
            PRED_ATOL * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got, tb.predict(X, raw_score=True,
                                                  device=False))


def check_case(name):
    X, jb, tb, (jev, tev) = train_case(name)
    assert_models_match(jb, tb, X)
    g = tb._gbdt
    assert g.is_categorical is not None
    assert int(g.is_categorical.sum()) == len(CATS)
    assert sum(t.num_cat for t in g.models) > 0
    extra, _, path = CASES[name]
    assert g._use_partition_engine is (
        extra.get("tpu_tree_engine") != "label")
    if path == "valid":
        assert tb.best_iteration == jb.best_iteration
        np.testing.assert_allclose(tev["valid_0"]["auc"],
                                   jev["valid_0"]["auc"], rtol=1e-6)


def test_label_engine_matches_jax():
    check_case("label")


def test_pandas_category_column_trains_as_jax():
    """A DataFrame's category columns are detected by default and train as
    categorical features; prediction on a frame maps them to codes."""
    pd = pytest.importorskip("pandas")
    X, y = airline(1200, seed=13)
    names = ["Month", "DayofMonth", "DayOfWeek", "DepTime", "UniqueCarrier",
             "Origin", "Dest", "Distance"]
    df = pd.DataFrame(X, columns=names)
    for j in CATS:
        df[names[j]] = pd.Categorical(
            ["c%d" % int(v) for v in X[:, j]])
    w = np.random.RandomState(14).rand(len(y)) + 0.5
    params = dict(PARAMS, objective="binary", tpu_tree_engine="label")
    tb = tlgb.train(params, tlgb.Dataset(df, y, weight=w, device="cpu"),
                    ROUNDS, device="cpu")
    jb = jlgb.train(params, jlgb.Dataset(df, y, weight=w), ROUNDS)
    mappers = tb._gbdt.train_set.bin_mappers
    assert [m.bin_type for m in mappers] == \
        [1 if j in CATS else 0 for j in range(8)]
    # the frame's rows as both packages read them: categories as codes
    assert_models_match(jb, tb, _to_matrix(df)[0])
