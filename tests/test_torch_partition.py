"""Parity of the port's K2/K3/K4 plain versions with the JAX partition
kernels (lightgbm_tpu/ops/partition_pallas.py, interpret mode) on one or two
tiles of rows.  The CUDA kernels meet the plain versions in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import partition_pallas as pp
from lightgbm_tpu_torch.ops import partition_kernel as pk

TILE = pp.TILE


def _data(seed, n=3000, F=5, B=40):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, F)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (np.abs(rng.randn(n)) + 0.1).astype(np.float32)
    return bins, grad, hess


def _jax_arena(bins, grad, hess, cap):
    """Pristine-layout f32 arena: bins rows, six g/h residue planes and the
    rowid byte planes (as grow_partition assembles it)."""
    n, F = bins.shape
    C = pp.arena_channels(F)
    Fp = pp.feature_channels(F)
    arena = pp.init_pristine(jnp.zeros((C, cap), pp.ARENA_DT),
                             jnp.asarray(bins.T, pp.ARENA_DT))
    gh = jnp.concatenate([c[None] for c in pp.split_f32(jnp.asarray(grad))]
                         + [c[None] for c in pp.split_f32(jnp.asarray(hess))])
    return arena.at[Fp:Fp + 6, :n].set(gh)


def _port_arena(bins, grad, hess, factor=8):
    n, F = bins.shape
    arena = pk.Arena(n, F, factor, "cpu")
    pk.init_pristine(arena, torch.from_numpy(np.ascontiguousarray(bins.T)))
    arena.payload[0, :n] = torch.from_numpy(grad)
    arena.payload[1, :n] = torch.from_numpy(hess)
    return arena


def _jax_planes(arena, F, start, cnt):
    """(bins [F, cnt], g [cnt], h [cnt], rowid [cnt]) of a JAX arena range."""
    a = np.asarray(arena[:, start:start + cnt], np.float32)
    Fp = pp.feature_channels(F)
    g = a[Fp] + a[Fp + 1] + a[Fp + 2]
    h = a[Fp + 3] + a[Fp + 4] + a[Fp + 5]
    rid = (a[Fp + 6].astype(np.int64) * 65536 + a[Fp + 7].astype(np.int64) * 256
           + a[Fp + 8].astype(np.int64))
    return a[:F].astype(np.uint8), g, h, rid


def _port_planes(arena, start, cnt):
    return (arena.bins[:, start:start + cnt].numpy(),
            arena.payload[0, start:start + cnt].numpy(),
            arena.payload[1, start:start + cnt].numpy(),
            arena.rid[start:start + cnt].numpy().astype(np.int64))


@pytest.mark.parametrize("start,cnt", [(0, 3000), (256, 1500), (512, 0)])
def test_segment_histogram_matches_jax(start, cnt):
    bins, grad, hess = _data(1)
    F, B = bins.shape[1], 40
    want = np.asarray(pp.segment_histogram(
        _jax_arena(bins, grad, hess, 4 * TILE), start, cnt, num_features=F,
        max_bin=B, interpret=True))
    seg = torch.tensor([start, cnt], dtype=torch.int32)
    got = pk.segment_histogram(_port_arena(bins, grad, hess), seg, B).numpy()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("xr", [0, 1])
def test_partition_segment_matches_jax(in_place, xr):
    bins, grad, hess = _data(2)
    n, F = bins.shape
    feat, thr = 2, 17
    mask = (np.arange(256) <= thr).astype(np.float32)
    mask[5] = 0.0                   # a missing-style bin routed the other way
    dst_a = 0 if in_place else 2 * TILE
    dst_b = 4 * TILE
    arena_j, counts = pp.partition_segment(
        _jax_arena(bins, grad, hess, 8 * TILE), jnp.zeros((1, TILE), jnp.float32),
        0, n, dst_a, dst_b, decision=(feat, mask, xr), interpret=True)
    counts = np.asarray(counts)
    arena_t = _port_arena(bins, grad, hess)
    sc = torch.tensor([0, n, dst_a, dst_b, 0, 0, feat, xr], dtype=torch.int32)
    pk.partition_segment(arena_t, sc, torch.from_numpy(mask.astype(np.uint8)))
    assert int(sc[pk.SC_CNT_A]) == counts[0]
    assert int(sc[pk.SC_CNT_B]) == counts[1]
    assert counts[0] + counts[1] == n
    for dst, c in ((dst_a, counts[0]), (dst_b, counts[1])):
        jb, jg, jh, jr = _jax_planes(arena_j, F, dst, c)
        tb, tg, th, tr = _port_planes(arena_t, dst, c)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(th, jh)


def test_partition_plain_is_stable_and_complete():
    bins, grad, hess = _data(3, n=700)
    arena = _port_arena(bins, grad, hess)
    mask = torch.zeros(256, dtype=torch.uint8)
    mask[:20] = 1
    sc = torch.tensor([0, 700, 2 * TILE, 4 * TILE, 0, 0, 1, 0],
                      dtype=torch.int32)
    pk.partition_segment(arena, sc, mask)
    na, nb = int(sc[pk.SC_CNT_A]), int(sc[pk.SC_CNT_B])
    rid_a = arena.rid[2 * TILE:2 * TILE + na].numpy()
    rid_b = arena.rid[4 * TILE:4 * TILE + nb].numpy()
    left = bins[:, 1] < 20
    np.testing.assert_array_equal(rid_a, np.flatnonzero(left))
    np.testing.assert_array_equal(rid_b, np.flatnonzero(~left))


def _leaf_segments(n, L, rng):
    cuts = np.sort(rng.choice(np.arange(1, n), L - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    return bounds[:-1].astype(np.int32), np.diff(bounds).astype(np.int32)


@pytest.mark.parametrize("emit", ["score", "leaf_ids"])
def test_scatter_segments_matches_jax_compact_and_sort(emit):
    """K4 is the composition of compact_segments and its consumer's sort
    (grow_partition.py:967-996): row-ordered values equal."""
    bins, grad, hess = _data(4, n=2500)
    n, F = bins.shape
    rng = np.random.RandomState(0)
    L, live = 9, 7
    # the rows of the leaf segments: a permutation of all n rows, laid out
    # from column 0 (rid plane permuted in both arenas)
    perm = rng.permutation(n).astype(np.int32)
    starts, cnts = _leaf_segments(n, live, rng)
    starts = np.concatenate([starts, np.zeros(L - live, np.int32)])
    cnts = np.concatenate([cnts, np.zeros(L - live, np.int32)])
    vals = (rng.randn(L).astype(np.float32) if emit == "score"
            else np.arange(L, dtype=np.float32))
    arena_j = _jax_arena(bins[perm], grad[perm], hess[perm], 4 * TILE)
    Fp = pp.feature_channels(F)
    rid_planes = jnp.stack(pp.split_rowid(jnp.asarray(perm)))
    arena_j = arena_j.at[Fp + 6:Fp + 9, :n].set(rid_planes)
    capn = -(-n // TILE) * TILE + L * TILE
    stream, used = pp.compact_segments(
        arena_j, jnp.asarray(starts), jnp.asarray(cnts), jnp.asarray(vals),
        live, n, F, capn, interpret=True)
    stream = np.asarray(stream)
    written = np.arange(capn) < int(np.asarray(used)[0])
    rid = np.where(written, stream[0], n).astype(np.int64)
    order = np.argsort(rid, kind="stable")
    want = stream[1][order][:n]

    arena_t = _port_arena(bins, grad, hess)
    arena_t.rid[:n] = torch.from_numpy(perm)
    seg = torch.from_numpy(np.stack([starts, cnts], axis=1))
    nl = torch.tensor([live], dtype=torch.int32)
    if emit == "score":
        out = torch.zeros(n)
        pk.scatter_segments(arena_t, seg, torch.from_numpy(vals), nl, out)
        np.testing.assert_array_equal(out.numpy(), want)
    else:
        out = torch.full((n,), -1, dtype=torch.int32)
        pk.scatter_segments(arena_t, seg,
                            torch.arange(L, dtype=torch.int32), nl, out)
        np.testing.assert_array_equal(out.numpy(),
                                      np.round(want).astype(np.int32))


def test_geometry_matches_jax():
    for n in (1, 2047, 2048, 10_500_000):
        for factor in (3, 4, 6):
            C, cap = pp.arena_geometry(n, 28, factor)
            G, cap_t = pk.arena_geometry(n, 28, factor)
            assert cap_t == cap and G == 28
        assert pk.pristine_work0(n) == pp.pristine_work0(n)


def test_wrappers_check_inputs():
    bins, grad, hess = _data(5, n=100)
    arena = _port_arena(bins, grad, hess)
    with pytest.raises(TypeError):
        pk.segment_histogram(arena, torch.tensor([0, 100]), 40)   # int64 seg
    with pytest.raises(ValueError):
        pk.partition_segment(arena, torch.zeros(7, dtype=torch.int32),
                             torch.zeros(256, dtype=torch.uint8))
    with pytest.raises(ValueError):
        pk.segment_histogram(arena, torch.tensor([0, 100], dtype=torch.int32),
                             300)
