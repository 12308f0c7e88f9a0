"""One tree from the port's partition-engine grower (plain kernel versions on
the CPU) against the JAX label engine (ops/grow.grow_tree, scatter
histograms), which tests/test_partition_engine.py holds equal to the JAX
partition engine; and, in the slow tier, against that partition engine
itself in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import grow_partition as jgp
from lightgbm_tpu.ops import partition_pallas as jpp
from lightgbm_tpu.ops.split import SplitParams as JSplitParams
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops.grow_partition import grow_tree_partition
from lightgbm_tpu_torch.ops.split import SplitParams


def _case(seed, n=2500, F=6, B=48):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (n, F)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    return dict(bins=bins, grad=grad, hess=hess, nb=np.full(F, B, np.int32),
                db=np.zeros(F, np.int32), mt=np.zeros(F, np.int32), B=B)


def _arena(bins, cap=None):
    """The pristine arena the GBDT driver sizes (factor 4); with `cap`, its
    planes cut to that many columns."""
    n, F = bins.shape
    arena = pk.Arena(n, F, 4, "cpu")
    if cap is not None:
        arena.cap = cap
        arena.bins = arena.bins[:, :cap].contiguous()
        arena.payload = arena.payload[:, :cap].contiguous()
        arena.rid = arena.rid[:cap].contiguous()
    pk.init_pristine(arena, torch.from_numpy(np.ascontiguousarray(bins.T)))
    return arena


def _grow_port(c, params, max_leaves, max_depth=-1, monotone=None,
               penalty=None, cap=None, emit="leaf_ids", **kw):
    F = c["bins"].shape[1]
    arena = _arena(c["bins"], cap)

    def t(v, dt=torch.int32):
        return None if v is None else torch.as_tensor(np.asarray(v)).to(dt)
    tree, leaf_ids, truncated = grow_tree_partition(
        arena, torch.from_numpy(c["grad"]), torch.from_numpy(c["hess"]),
        torch.ones(F, dtype=torch.bool), t(c["nb"]), t(c["db"]), t(c["mt"]),
        SplitParams(**params), t(monotone), t(penalty, torch.float32),
        max_leaves=max_leaves, max_depth=max_depth, max_bin=c["B"],
        emit=emit, **kw)
    return tree, leaf_ids.numpy(), bool(truncated)


def _grow_label(c, params, max_leaves, max_depth=-1, monotone=None,
                penalty=None):
    F = c["bins"].shape[1]

    def j(v, dt=jnp.int32):
        return None if v is None else jnp.asarray(np.asarray(v), dt)
    tree, leaf_ids = jgrow.grow_tree(
        jnp.asarray(c["bins"]), jnp.asarray(c["grad"]), jnp.asarray(c["hess"]),
        jnp.zeros(len(c["grad"]), jnp.int32), jnp.ones(F, bool),
        jnp.asarray(c["nb"]), jnp.asarray(c["db"]), jnp.asarray(c["mt"]),
        JSplitParams(**params), j(monotone, jnp.int8),
        j(penalty, jnp.float32), max_leaves=max_leaves, max_bin=c["B"],
        max_depth=max_depth, hist_impl="scatter")
    return tree, np.asarray(leaf_ids)


def _assert_trees_equal(got, want):
    """tests/test_partition_engine.py's band: rtol 1e-4, atol 1e-5 on every
    field, default_left exempt (two-direction ties break on sub-ulp gain
    differences between accumulation orders)."""
    assert int(got.num_leaves) == int(np.asarray(want.num_leaves))
    for f in want._fields:
        if f == "default_left":
            continue
        a = np.asarray(getattr(got, f).numpy() if isinstance(
            getattr(got, f), torch.Tensor) else getattr(got, f))
        b = np.asarray(getattr(want, f))
        if a.shape != b.shape:
            continue            # cat_mask width (the port's is 0)
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=f)


def _missing_case(seed):
    c = _case(seed)
    c["mt"][0] = jgrow.MISSING_NAN
    c["mt"][1] = jgrow.MISSING_ZERO
    c["db"][1] = 3
    return c


GROW_CASES = {
    "basic": (lambda: _case(0), dict(min_data_in_leaf=10), 15, {}),
    "missing": (lambda: _missing_case(1), dict(min_data_in_leaf=10), 15, {}),
    "max_depth": (lambda: _case(2), dict(min_data_in_leaf=10), 31,
                  dict(max_depth=3)),
    "early_stop": (lambda: _case(3), dict(min_data_in_leaf=1100), 15, {}),
    "regularized": (lambda: _case(4), dict(min_data_in_leaf=20,
                                           lambda_l1=0.3, lambda_l2=1.5,
                                           max_delta_step=0.5,
                                           min_gain_to_split=0.05), 15, {}),
    "monotone_penalty": (lambda: _case(5), dict(min_data_in_leaf=10), 15,
                         dict(monotone=np.array([1, -1, 0, 0, 1, 0]),
                              penalty=np.array([1.0, 0.5, 1.0, 2.0, 1.0,
                                                0.8]))),
}


@pytest.mark.parametrize("name", sorted(GROW_CASES))
def test_port_grower_matches_label_engine(name):
    make, params, leaves, extra = GROW_CASES[name]
    c = make()
    got, ids_got, truncated = _grow_port(c, params, leaves, **extra)
    want, ids_want = _grow_label(c, params, leaves, **extra)
    assert not truncated
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(ids_got, ids_want)
    if name == "max_depth":
        assert int(got.leaf_depth[:int(got.num_leaves)].max()) <= 3
    if name == "early_stop":
        assert int(got.num_leaves) < leaves


def test_score_emit_is_leaf_value_per_row():
    c = _case(6)
    params = dict(min_data_in_leaf=10)
    tree, ids, _ = _grow_port(c, params, 15)
    n = len(c["grad"])
    score0 = np.random.RandomState(3).randn(n).astype(np.float32)
    score = torch.from_numpy(score0.copy())
    _, got, _ = _grow_port(c, params, 15, emit="score", score=score,
                           shrinkage=torch.tensor(0.1))
    assert got is not None and np.shares_memory(got, score.numpy())
    lv = tree.leaf_value.numpy()[ids]
    np.testing.assert_array_equal(got, score0 + lv * np.float32(0.1))


def test_arena_truncation_flag():
    """A bump region too small for the smaller children stops growth and
    raises the flag, leaving a valid shorter tree (grow_partition.py:657-674
    of the JAX engine)."""
    c = _case(7)
    n = c["bins"].shape[0]
    # the bump region starts past the pristine block, its guard tile and the
    # redirected root copy; leave it four allocation units and a guard tile
    cursor0 = pk.pristine_work0(n) + -(-n // pk.TILE) * pk.TILE
    tree, ids, truncated = _grow_port(c, dict(min_data_in_leaf=10), 31,
                                      cap=cursor0 + pk.TILE + 4 * pk.ALLOC)
    nl = int(tree.num_leaves)
    assert truncated and 1 < nl < 31
    assert (ids >= 0).all() and (ids < nl).all()
    np.testing.assert_array_equal(np.bincount(ids, minlength=nl),
                                  tree.leaf_count.numpy()[:nl])


@pytest.mark.slow
def test_port_grower_matches_jax_partition_engine():
    c = _case(8)
    bins = c["bins"]
    F = bins.shape[1]
    params = dict(min_data_in_leaf=10)
    got, ids_got, _ = _grow_port(c, params, 15)
    n = bins.shape[0]
    arena = jnp.zeros((jpp.arena_channels(F), 8 * jpp.TILE), jpp.ARENA_DT)
    want, ids_want, _, _ = jgp.grow_tree_partition(
        arena, jnp.asarray(bins.T.astype(np.float32)),
        jnp.asarray(c["grad"]), jnp.asarray(c["hess"]),
        jnp.zeros(n, jnp.int32), jnp.ones(F, bool), jnp.asarray(c["nb"]),
        jnp.asarray(c["db"]), jnp.asarray(c["mt"]), JSplitParams(**params),
        max_leaves=15, max_bin=c["B"], interpret=True)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(ids_got, np.asarray(ids_want))
