"""`refit` and `refit_inplace` in the port against the JAX package, on the
CPU: tests/test_torch_continue.py's 3-round 15-leaf model text (1,500 rows,
`max_bin` 63, the label engine; binary and 3 classes) refit on other rows
and labels (decay 0.9 and 0.5; 3 classes at decay 0.9): leaf values within
1e-6 of JAX's (relative to the tree's largest), the structure kept, and
`refit_inplace` equal to `refit`.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_continue import PARAMS
from test_torch_goss import data


@pytest.mark.parametrize("case", ["binary", "multiclass"])
def test_refit_matches_jax(case):
    params = dict(PARAMS, tpu_tree_engine="label")
    if case == "multiclass":
        params.update(objective="multiclass", num_class=3)
    X, y = data(case, n=1500, seed=6)
    text = tlgb.train(params, tlgb.Dataset(X, y, device="cpu"), 3,
                      verbose_eval=False, device="cpu").model_to_string()
    X2, y2 = data(case, n=800, seed=9)
    for decay in (0.9, 0.5) if case == "binary" else (0.9,):
        jr = jlgb.Booster(model_str=text).refit(X2, y2, decay_rate=decay)
        tr = tlgb.Booster(model_str=text, device="cpu").refit(
            X2, y2, decay_rate=decay)
        inplace = tlgb.Booster(model_str=text, params={
            "refit_decay_rate": decay}, device="cpu").refit_inplace(X2, y2)
        for a, b, c in zip(tr._gbdt.models, jr._gbdt.models,
                           inplace._gbdt.models):
            n = a.num_leaves
            assert n == b.num_leaves > 1
            np.testing.assert_array_equal(a.split_feature[:n - 1],
                                          b.split_feature[:n - 1])
            scale = float(np.abs(b.leaf_value[:n]).max())
            np.testing.assert_allclose(a.leaf_value[:n], b.leaf_value[:n],
                                       rtol=0, atol=1e-6 * scale)
            np.testing.assert_array_equal(a.leaf_value, c.leaf_value)
        assert not np.array_equal(tr.predict(X2, raw_score=True),
                                  tlgb.Booster(model_str=text, device="cpu")
                                  .predict(X2, raw_score=True))
