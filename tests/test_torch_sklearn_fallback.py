"""The port's scikit-learn wrappers without scikit-learn, and plotting, on
the CPU.

- without scikit-learn (a subprocess with `sys.modules["sklearn"] =
  None`): the wrappers keep their constructor's parameters
  (`get_params`, `_process_params`), so `LGBMClassifier(num_leaves=4,
  learning_rate=0.3, n_estimators=3)` grows trees of at most 4 leaves
  shrunk by 0.3 (the JAX package's wrappers drop them there, ROADMAP.md
  queue 3); `cv` falls back to plain folds;
- plotting: `plot_importance` and `plot_metric` on matplotlib's Agg
  backend, and `create_tree_digraph`'s graph source equal to the JAX
  package's for the same model text.
"""
import os
import subprocess
import sys
import textwrap

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from test_torch_goss import data
from test_torch_sklearn import N

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wrappers_keep_their_parameters_without_sklearn():
    code = textwrap.dedent("""
        import sys
        sys.modules["sklearn"] = None
        import numpy as np
        import lightgbm_tpu_torch as lt
        from lightgbm_tpu_torch import sklearn as sk
        assert not sk._SKLEARN
        rng = np.random.RandomState(0)
        X = rng.randn(600, 5)
        y = (X[:, 0] + 0.5 * rng.randn(600) > 0).astype(float)
        clf = lt.LGBMClassifier(num_leaves=4, learning_rate=0.3,
                                n_estimators=3, device="cpu")
        p = clf.get_params()
        assert p["num_leaves"] == 4 and p["learning_rate"] == 0.3, p
        assert p["n_estimators"] == 3 and p["device"] == "cpu", p
        q = clf._process_params()
        assert q["num_leaves"] == 4 and q["learning_rate"] == 0.3, q
        assert "device" not in q, q
        clf.fit(X, y)
        assert clf.booster_._gbdt.objective.name == "binary"
        trees = clf.booster_._gbdt.models
        assert len(trees) == 3, len(trees)
        assert max(t.num_leaves for t in trees) <= 4
        assert [t.shrinkage for t in trees][1:] == [0.3, 0.3]
        res = lt.cv({"objective": "binary", "num_leaves": 4,
                     "verbose": -1}, lt.Dataset(X, y, device="cpu"),
                    num_boost_round=2, nfold=3, device="cpu")
        assert len(res["binary_logloss-mean"]) == 2
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_plotting():
    import matplotlib
    matplotlib.use("Agg")
    X, y = data("binary", n=N, seed=5)
    ev = {}
    t = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "tpu_tree_engine": "label"},
                   tlgb.Dataset(X, y, device="cpu"), 2,
                   valid_sets=[tlgb.Dataset(X[::2], y[::2], device="cpu")],
                   evals_result=ev, verbose_eval=False, device="cpu")
    ax = tlgb.plot_importance(t, importance_type="gain")
    assert len(ax.patches) == int((t.feature_importance("gain") > 0).sum())
    ax = tlgb.plot_metric(ev)
    assert ax.get_ylabel() == "binary_logloss"
    # both loaded from one text, which rounds the split gains
    text = t.model_to_string()
    t = tlgb.Booster(model_str=text, device="cpu")
    j = jlgb.Booster(model_str=text)
    for i in (0, 1):
        got = tlgb.create_tree_digraph(t, tree_index=i,
                                       show_info=["split_gain"])
        want = jlgb.create_tree_digraph(j, tree_index=i,
                                        show_info=["split_gain"])
        assert got.source == want.source
