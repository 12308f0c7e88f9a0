"""EFB-bundled training against the JAX package on the CPU, beside
tests/test_torch_efb.py's carried run (each held as
tests/test_torch_categorical.py holds its runs): the label engine (K7 over
the group columns, its histograms unbundled before K1's scan), a
validation set that shares its reference's bundle (the eager path; each
tree fetched in its round and walked over the set's group columns by
KP2's add mode; AUC rtol 1e-6 of JAX's); 3-class softmax at Covertype's
one-hot layout on the fused pristine path runs in
tests/test_torch_efb_multiclass.py."""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_categorical import assert_models_match
from test_torch_efb import PARAMS, ROUNDS, carried_data, onehot

def check_case(name):
    X, y = onehot() if name == "multiclass" else carried_data()
    if name == "multiclass":
        X, y = onehot(k=3)
    params = dict(PARAMS)
    jkw, tkw, jev, tev = {}, {}, {}, {}
    w = None
    if name == "label":
        # weighted: the label engine's histograms sum in another order
        # than JAX's, and one-hot bins of equal unweighted sums would tie
        params["tpu_tree_engine"] = "label"
        w = np.random.RandomState(8).rand(len(y)) + 0.5
    if name == "multiclass":
        params.update(objective="multiclass", num_class=3)
    jds = jlgb.Dataset(X, y, weight=w)
    tds = tlgb.Dataset(X, y, weight=w, device="cpu")
    if name == "valid":
        Xv, yv = carried_data(800, seed=1)
        params["metric"] = "auc"
        jkw = dict(valid_sets=[jlgb.Dataset(Xv, yv, reference=jds)],
                   evals_result=jev, verbose_eval=False)
        tvs = tlgb.Dataset(Xv, yv, reference=tds, device="cpu")
        tkw = dict(valid_sets=[tvs], evals_result=tev, verbose_eval=False)
    jparams = dict(params)
    jparams.setdefault("tpu_tree_engine", "partition")
    jb = jlgb.train(jparams, jds, ROUNDS, **jkw)
    tb = tlgb.train(params, tds, ROUNDS, device="cpu", **tkw)
    g = tb._gbdt
    assert g.bundle is not None
    assert g._use_partition_engine is (name != "label")
    assert_models_match(jb, tb, X)
    if name == "valid":
        assert tvs._binned.bundle is tds._binned.bundle
        assert g._tree_fetches == ROUNDS
        np.testing.assert_allclose(tev["valid_0"]["auc"],
                                   jev["valid_0"]["auc"], rtol=1e-6)
    if name == "multiclass":
        assert g.num_tree_per_iteration == 3 and not g._carried_active


@pytest.mark.parametrize("name", ["label", "valid"])
def test_training_matches_jax(name):
    check_case(name)
