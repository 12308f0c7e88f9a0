"""CEGB's coupled penalty across trees and drains, against the JAX
package, on the CPU, on both tree engines (helpers and tolerances:
tests/test_torch_cegb.py): a moderate penalty on half the features, over
5 rounds with both packages' `_DRAIN_EVERY` 2, charges a feature until a
tree first splits on it; the port's used-feature vector lives on the
device across trees and drains, and equals JAX's host vector at the end.
"""
import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu_torch.models import gbdt as tgbdt

from test_torch_cegb import COUPLED, ENGINES, _train_both, _used_features
from test_torch_label import PARAMS, _assert_trees_match, _data


@pytest.mark.parametrize("engine", ENGINES)
def test_coupled_penalty_across_trees_and_drains(engine, monkeypatch):
    """A coupled penalty of 8 on the odd features, 5 rounds with both
    packages' _DRAIN_EVERY 2: the same trees as JAX, the port's rounds
    deferred and drained at rounds 3 and 5 and the end, and its device
    used-feature vector equal to JAX's host one."""
    monkeypatch.setattr(jgbdt, "_DRAIN_EVERY", 2)
    monkeypatch.setattr(tgbdt, "_DRAIN_EVERY", 2)
    X, y = _data(2)
    params = dict(PARAMS, objective="binary", tpu_tree_engine=engine,
                  cegb_tradeoff=1.0, cegb_penalty_feature_coupled=COUPLED)
    jb, tb = _train_both(X, y, params, 5)
    g = tb._gbdt
    assert g._tree_fetches == 0 and g._drains == 3
    assert bool(g._carried_active) is (engine == "partition")
    _assert_trees_match(jb._gbdt.models, g.models, X, [None] * 5)
    used = g._cegb_used.numpy()
    np.testing.assert_array_equal(used, np.asarray(jb._gbdt._cegb_used))
    assert set(np.flatnonzero(used)) == _used_features(g.models)
    plain = tlgb.train(dict(params, cegb_penalty_feature_coupled=[0.0] * 8),
                       tlgb.Dataset(X, y, device="cpu"), num_boost_round=5,
                       device="cpu")
    odd = [f for f in range(1, 8, 2)]

    def odd_splits(models):
        return sum(int(np.isin(t.split_feature[:t.num_leaves - 1],
                               odd).sum()) for t in models)

    assert odd_splits(g.models) < odd_splits(plain._gbdt.models)
