"""The pieces around the rounds' CUDA graphs, on the CPU:

- `pack_tree_vector` / `unpack_tree_vector`, the one host fetch of a tree
  with its truncation flag: the round trip equals `pack_tree_arrays` /
  `unpack_tree_vectors` field for field;
- the partition grower's K3 segment vector, built by fills on the device,
  equals the vector it replaced;
- `RoundGraphs` on the CPU calls the function: no graph, no warm-up;
- the driver stages the round's quantization key and feature mask into
  `_round_inp`, the graphs' static input, and keeps no pinned ring on the
  CPU;
- the eager path without a bag (a validation set) adds each tree to the
  score by K4's add mode with s = 1: bit for bit the formula it replaced,
  `score += lv[leaf_ids]` over K4's set-mode leaf ids, at every tree.

The graphs themselves run on the card (tests/test_torch_gpu.py, `-k
graph`)."""
import numpy as np
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import gbdt as gbdt_mod
from lightgbm_tpu_torch.ops import grow_partition as gp
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops import quantize as qz
from lightgbm_tpu_torch.ops import threefry
from lightgbm_tpu_torch.ops.graphs import RoundGraphs
from lightgbm_tpu_torch.ops.grow import (pack_tree_arrays, pack_tree_vector,
                                         unpack_tree_vector,
                                         unpack_tree_vectors)
from lightgbm_tpu_torch.ops.split import SplitParams


def _data(n=600, F=6, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = (X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


def _tree(max_leaves=15):
    rng = np.random.RandomState(2)
    n, F, B = 3000, 5, 32
    arena = pk.Arena(n, F, 4, "cpu")
    pk.init_pristine(arena, torch.from_numpy(
        rng.randint(0, B, (F, n)).astype(np.uint8)))
    return gp.grow_tree_partition(
        arena, torch.from_numpy(rng.randn(n).astype(np.float32)),
        torch.from_numpy((rng.rand(n) + 0.1).astype(np.float32)),
        torch.ones(F, dtype=torch.bool), torch.full((F,), B), torch.zeros(
            F, dtype=torch.int32), torch.zeros(F, dtype=torch.int32),
        SplitParams(min_data_in_leaf=20), max_leaves=max_leaves, max_bin=B)


def test_tree_vector_round_trip():
    tree, _, truncated = _tree()
    for flag in (False, True):
        vec = pack_tree_vector(tree, torch.tensor(flag))
        assert vec.dtype == torch.float64
        got, trunc = unpack_tree_vector(vec.numpy(), 15)
        assert trunc is flag
        ivec, fvec = pack_tree_arrays(tree)
        want = unpack_tree_vectors(ivec.numpy(), fvec.numpy(), 15, 0)
        for name, a, b in zip(want._fields, got, want):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got.num_leaves) == 15 and not bool(truncated)


def test_segment_vector_by_fills():
    for head in [(0, 1000, 4096, 8192), (4096, 1000), (0, 0)]:
        want = torch.tensor(list(head) + [0] * (pk.SC_LEN - len(head)),
                            dtype=torch.int32)
        assert torch.equal(gp._sc_vector(head, torch.device("cpu")), want)


def test_round_graphs_call_the_function_on_the_cpu():
    graphs = RoundGraphs("cpu")
    calls = []

    def fn():
        calls.append(1)
        return (torch.ones(3) * len(calls),)
    for k in range(3):
        (out,) = graphs.run("key", "warm", fn)
        assert torch.equal(out, torch.full((3,), float(k + 1)))
    assert len(calls) == 3 and graphs.graphs == {} and graphs.stats() == []


def test_round_inputs_are_staged():
    X, y = _data()
    bst = lt.Booster({"objective": "binary", "num_leaves": 7, "verbose": -1,
                      "feature_fraction": 0.5, "tpu_quantized_grad": True},
                     lt.Dataset(X, y, device="cpu"), device="cpu")
    g = bst._gbdt
    assert g._slot() is None and g._ring == []
    key = threefry.fold_in(qz.quantize_key(7, 3), 0)
    g._stage_inputs(None, [0], [key])
    inp = g._round_inp
    # a row a class, then the sampling key's row (GOSS), here unused
    assert inp.dtype == torch.int64 and inp.shape == (2, 2 + X.shape[1])
    assert tuple(inp[0, :2].tolist()) == key and not inp[1].any()
    assert int(inp[0, 2:].sum()) == 3 and set(inp[0, 2:].tolist()) <= {0, 1}
    g._stage_inputs(None, [0], [None])
    assert inp[0, :2].tolist() == [0, 0]


def test_valid_set_score_by_add_mode_matches_the_replaced_formula(
        monkeypatch):
    X, y = _data()
    real = gbdt_mod.scatter_segments
    seen = []

    def check(arena, seg, vals, nl, out, shrink=None):
        assert shrink == 1.0
        ids = torch.full_like(out, -1, dtype=torch.int32)
        real(arena, seg, torch.arange(seg.shape[0], dtype=torch.int32), nl,
             ids)
        want = out + vals[ids.clamp(0, int(nl[0]) - 1).long()]
        real(arena, seg, vals, nl, out, shrink=shrink)
        seen.append(((ids >= 0).all().item(),
                     torch.equal(out.view(torch.int32),
                                 want.view(torch.int32))))
    monkeypatch.setattr(gbdt_mod, "scatter_segments", check)
    ds = lt.Dataset(X[:450], y[:450], device="cpu")
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "metric": "auc"}, ds, num_boost_round=3,
                   valid_sets=[lt.Dataset(X[450:], y[450:], reference=ds,
                                          device="cpu")],
                   verbose_eval=False, device="cpu")
    assert bst._gbdt._tree_fetches == 3 and bst._gbdt._drains == 0
    assert seen == [(True, True)] * 3
