"""The port's quantized-gradient pieces against the JAX package, on the CPU:

- ops/threefry: `uniform` equals jax.random.uniform under
  fold_in(PRNGKey(seed), iteration) bit for bit, and the keys are equal;
  so does `uniform` under the same key as an int64 [2] tensor, as the
  driver stages it for a captured round (unfolded and folded with 0), and
  `quantize_gradients` under a tensor key gives JAX's codes;
- ops/quantize: `quantize_gradients` gives equal codes and scales for the
  same f32 inputs and key; `dequantize_hist` equals JAX's;
- the plain versions of K2 in int8 mode (`segment_histogram` on a quantized
  arena), K5 (`fused_refresh_histogram`) and K6 (`compact_carry`) equal the
  JAX kernels run in interpret mode (lightgbm_tpu/ops/partition_pallas.py),
  exactly.  The CUDA kernels meet the plain versions in
  tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import partition_pallas as pp
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops import threefry as tf

TILE = pp.TILE


# --------------------------------------------------------------------------- #
# threefry and the uniform draw
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 2, 1023, 4097])
@pytest.mark.parametrize("iteration", [0, 1, 499])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_uniform_matches_jax_bit_for_bit(seed, iteration, n):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), iteration)
    tkey = tf.fold_in(tf.PRNGKey(seed), iteration)
    assert tkey == tuple(int(v) for v in np.asarray(jkey))
    want = np.asarray(jax.random.uniform(jkey, (n,), jnp.float32))
    got = tf.uniform(tkey, n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("iteration", [0, 1, 499])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 - 3])
def test_uniform_tensor_key_matches_jax_bit_for_bit(seed, iteration, fold):
    jkey = jq.quantize_key(seed, iteration)
    tkey = tq.quantize_key(seed, iteration)
    if fold:
        jkey, tkey = jax.random.fold_in(jkey, 0), tf.fold_in(tkey, 0)
    want = np.asarray(jax.random.uniform(jkey, (4097,), jnp.float32))
    got = tf.uniform(torch.tensor(tkey, dtype=torch.int64), 4097).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_tensor_key_is_checked():
    with pytest.raises(ValueError, match="int64"):
        tf.uniform(torch.tensor([1, 2], dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="int64"):
        tf.uniform(torch.tensor([1, 2, 3]), 8)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 - 3])
@pytest.mark.parametrize("iteration", [0, 1, 499])
def test_quantize_key_matches_jax(seed, iteration):
    """2^32 - 3 needs the & 0x7FFFFFFF mask (quantize.py:85)."""
    want = tuple(int(v) for v in np.asarray(jq.quantize_key(seed, iteration)))
    assert tq.quantize_key(seed, iteration) == want


def test_threefry_block_matches_jax():
    from jax._src import prng
    rng = np.random.RandomState(0)
    k = rng.randint(0, 2**32, 2, dtype=np.uint64)
    x = rng.randint(0, 2**32, (2, 64), dtype=np.uint64)
    want = prng.threefry_2x32(jnp.asarray(k, jnp.uint32),
                              jnp.asarray(x.reshape(-1), jnp.uint32))
    got = tf.threefry2x32(int(k[0]), int(k[1]),
                          torch.from_numpy(x[0].astype(np.int64)),
                          torch.from_numpy(x[1].astype(np.int64)))
    np.testing.assert_array_equal(
        np.concatenate([g.numpy() for g in got]),
        np.asarray(want).astype(np.int64))


# --------------------------------------------------------------------------- #
# quantize_gradients and dequantize_hist
# --------------------------------------------------------------------------- #
def _gradients(kind, n=5000, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        g = np.tanh(rng.randn(n)).astype(np.float32)
        h = (0.25 - g * g / 4).astype(np.float32)
    elif kind == "l2":
        g = (rng.randn(n) * 3).astype(np.float32)
        h = np.ones(n, np.float32)
    else:          # zeros and exact multiples of the scale: rounding edges
        g = (rng.randint(-127, 128, n) / 127 * 0.5).astype(np.float32)
        g[::7] = 0.0
        h = (rng.randint(0, 255, n) / 254).astype(np.float32)
    return g, h


@pytest.mark.parametrize("kind", ["binary", "l2", "edges"])
@pytest.mark.parametrize("seed,iteration,fold", [(0, 0, False), (7, 3, True),
                                                 (2**31 - 1, 41, False)])
def test_quantize_gradients_matches_jax(kind, seed, iteration, fold):
    g, h = _gradients(kind)
    jkey = jq.quantize_key(seed, iteration)
    tkey = tq.quantize_key(seed, iteration)
    if fold:
        jkey, tkey = jax.random.fold_in(jkey, 0), tf.fold_in(tkey, 0)
    jg, jh, jgs, jhs = jq.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                                             jkey)
    tg, th, tgs, ths = tq.quantize_gradients(torch.from_numpy(g),
                                             torch.from_numpy(h), tkey)
    assert tg.dtype == th.dtype == torch.int8
    np.testing.assert_array_equal(tg.numpy().astype(np.float32),
                                  np.asarray(jg))
    np.testing.assert_array_equal(th.numpy().astype(np.float32),
                                  np.asarray(jh))
    assert np.float32(tgs) == np.float32(jgs)
    assert np.float32(ths) == np.float32(jhs)
    # the key as a captured round reads it: an int64 [2] tensor
    kt = tq.quantize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                               torch.tensor(tkey, dtype=torch.int64))
    for a, b in zip(kt, (tg, th, tgs, ths)):
        assert torch.equal(a, b)
    hist = np.random.RandomState(1).randint(-2**20, 2**20, (5, 40, 3))
    np.testing.assert_array_equal(
        tq.dequantize_hist(torch.from_numpy(hist.astype(np.int32)), tgs,
                           ths).numpy(),
        np.asarray(jq.dequantize_hist(jnp.asarray(hist, jnp.float32), jgs,
                                      jhs)))


def test_exactness_envelope_matches_jax():
    assert tq.exact_rows() == jq.exact_rows() == 132_104
    for rows in (1, 132_104, 132_105):
        assert tq.overflow_safe(rows) == jq.overflow_safe(rows)


# --------------------------------------------------------------------------- #
# K2 int8 mode, K5 and K6 against the JAX kernels in interpret mode
# --------------------------------------------------------------------------- #
def _code_data(seed, n=3000, F=5, B=40):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, F)).astype(np.uint8)
    g_code = rng.randint(-127, 128, n).astype(np.int8)
    h_code = rng.randint(0, 128, n).astype(np.int8)
    return bins, g_code, h_code


def _jax_code_arena(bins, g_code, h_code, cap, rid=None):
    """A JAX arena with bins, the two code planes at Fp, Fp+1 and the rowid
    byte planes (tests/test_quantized.py's layout)."""
    n, F = bins.shape
    Fp, C = pp.feature_channels(F), pp.arena_channels(F)
    arena = np.zeros((C, cap), np.float32)
    arena[:F, :n] = bins.T
    arena[Fp, :n], arena[Fp + 1, :n] = g_code, h_code
    rid = np.arange(n, dtype=np.int32) if rid is None else rid
    for i, p in enumerate(pp.split_rowid(jnp.asarray(rid))):
        arena[Fp + 6 + i, :n] = np.asarray(p, np.float32)
    return jnp.asarray(arena, pp.ARENA_DT)


def _port_code_arena(bins, g_code, h_code, rid=None):
    n, F = bins.shape
    arena = pk.Arena(n, F, 6, "cpu", quantized=True)
    pk.init_pristine(arena, torch.from_numpy(np.ascontiguousarray(bins.T)))
    arena.payload[0, :n] = torch.from_numpy(g_code)
    arena.payload[1, :n] = torch.from_numpy(h_code)
    if rid is not None:
        arena.rid[:n] = torch.from_numpy(rid)
    return arena


@pytest.mark.parametrize("start,cnt", [(0, 3000), (256, 1500), (2048, 952),
                                       (512, 0)])
def test_segment_histogram_int8_matches_jax(start, cnt):
    bins, g_code, h_code = _code_data(1)
    F, B = bins.shape[1], 40
    want = np.asarray(pp.segment_histogram(
        _jax_code_arena(bins, g_code, h_code, 4 * TILE), start, cnt,
        num_features=F, max_bin=B, quantized=True, interpret=True))
    got = pk.segment_histogram(_port_code_arena(bins, g_code, h_code),
                               torch.tensor([start, cnt], dtype=torch.int32),
                               B)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("start", [0, 2048])
def test_fused_refresh_histogram_matches_jax(start):
    """K5 at the pristine root (start 0) and at a carried slot: the integer
    histogram, the code planes written, the bins and row ids untouched."""
    bins, g_code, h_code = _code_data(2, n=2500)
    n, F = bins.shape
    B = 40
    Fp = pp.feature_channels(F)
    # the segment's rows sit at [start, start+n); stale codes there
    z = np.zeros(n, np.int8)
    stale_j = _jax_code_arena(bins, z, z, start + 2 * TILE)
    stale_j = jnp.roll(stale_j, start, axis=1)
    arena_j, want = pp.fused_refresh_histogram(
        stale_j, pp.pack_code_planes(jnp.asarray(g_code, jnp.float32),
                                     jnp.asarray(h_code, jnp.float32)),
        start, n, num_features=F, max_bin=B, interpret=True)
    arena_t = _port_code_arena(bins, z, z)
    for plane in (arena_t.bins, arena_t.payload):
        plane[:, start:start + n] = plane[:, :n].clone()
    arena_t.rid[start:start + n] = arena_t.rid[:n].clone()
    codes = torch.from_numpy(np.stack([g_code, h_code]))
    got = pk.fused_refresh_histogram(
        arena_t, codes, torch.tensor([start, n], dtype=torch.int32), B)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    a = np.asarray(arena_j[:, start:start + n], np.float32)
    np.testing.assert_array_equal(
        arena_t.payload[:, start:start + n].numpy().astype(np.float32),
        a[Fp:Fp + 2])
    np.testing.assert_array_equal(arena_t.bins[:, start:start + n].numpy(),
                                  a[:F].astype(np.uint8))
    rid_j = (a[Fp + 6].astype(np.int64) * 65536 + a[Fp + 7].astype(np.int64)
             * 256 + a[Fp + 8].astype(np.int64))
    np.testing.assert_array_equal(arena_t.rid[start:start + n].numpy(),
                                  rid_j)
    np.testing.assert_array_equal(rid_j, np.arange(n))


@pytest.mark.parametrize("quantized", [False, True])
def test_compact_carry_matches_jax(quantized):
    """K6 over 9 leaf segments (7 live, one empty) at 256-aligned starts,
    as the bump allocator leaves them: rows written, the row-id order, the
    bins and the payload at dst0 equal."""
    rng = np.random.RandomState(5)
    n, F, B, L, live = 2100, 5, 40, 9, 7
    bins, g_code, h_code = _code_data(3, n=n, F=F, B=B)
    rid = rng.permutation(n).astype(np.int32)
    cnts = np.array([400, 0, 333, 257, 600, 10, 500, 0, 0], np.int32)
    assert cnts[:live].sum() == n
    starts = np.zeros(L, np.int32)
    col = 0
    for i in range(live):
        starts[i] = col
        col += -(-max(cnts[i], 1) // pk.ALLOC) * pk.ALLOC
    # the rows of each segment at its start (the arena's first columns hold
    # the segments; row j of the data lands in the j-th live column)
    src_cols = np.concatenate([starts[i] + np.arange(cnts[i])
                               for i in range(live)])
    width = col
    dst0 = -(-width // TILE) * TILE
    cap = dst0 + 3 * TILE
    spread = np.zeros((width, F), np.uint8)
    spread[src_cols] = bins
    sg, sh, sr = (np.zeros(width, np.int8), np.zeros(width, np.int8),
                  np.zeros(width, np.int32))
    sg[src_cols], sh[src_cols], sr[src_cols] = g_code, h_code, rid
    # JAX: the codes ride planes Fp, Fp+1 whether or not the port's arena
    # is quantized (K6 copies every channel)
    arena_j = _jax_code_arena(spread, sg, sh, cap, rid=sr)
    out_j, used_j = pp.compact_carry(arena_j, jnp.asarray(starts),
                                     jnp.asarray(cnts), live, dst0,
                                     interpret=True)
    arena_t = pk.Arena(width, F, 6, "cpu", quantized=quantized)
    pk.init_pristine(arena_t, torch.from_numpy(np.ascontiguousarray(
        spread.T)))
    arena_t.rid[:width] = torch.from_numpy(sr)
    arena_t.payload[0, :width] = torch.from_numpy(sg)
    arena_t.payload[1, :width] = torch.from_numpy(sh)
    seg = torch.from_numpy(np.stack([starts, cnts], axis=1))
    used = pk.compact_carry(arena_t, seg,
                            torch.tensor([live], dtype=torch.int32), dst0)
    assert used.dtype == torch.int32 and used.shape == (1,)
    assert int(used[0]) == int(np.asarray(used_j)) == n
    Fp = pp.feature_channels(F)
    a = np.asarray(out_j[:, dst0:dst0 + n], np.float32)
    rid_j = (a[Fp + 6].astype(np.int64) * 65536 + a[Fp + 7].astype(np.int64)
             * 256 + a[Fp + 8].astype(np.int64))
    np.testing.assert_array_equal(arena_t.rid[dst0:dst0 + n].numpy(), rid_j)
    np.testing.assert_array_equal(rid_j, rid)       # leaf-index order
    np.testing.assert_array_equal(arena_t.bins[:, dst0:dst0 + n].numpy(),
                                  a[:F].astype(np.uint8))
    np.testing.assert_array_equal(
        arena_t.payload[:, dst0:dst0 + n].numpy().astype(np.float32),
        a[Fp:Fp + 2])


def test_quantized_wrappers_check_inputs():
    bins, g_code, h_code = _code_data(4, n=100)
    arena = _port_code_arena(bins, g_code, h_code)
    seg = torch.tensor([0, 100], dtype=torch.int32)
    with pytest.raises(TypeError):      # codes must be int8
        pk.fused_refresh_histogram(arena, torch.zeros((2, 100)), seg, 40)
    with pytest.raises(ValueError):     # K5 needs a quantized arena
        pk.fused_refresh_histogram(pk.Arena(100, 5, 4, "cpu"),
                                   torch.zeros((2, 100), dtype=torch.int8),
                                   seg, 40)
    with pytest.raises(ValueError):     # segments are [L, 2]
        pk.compact_carry(arena, torch.zeros(4, dtype=torch.int32),
                         torch.tensor([1], dtype=torch.int32), 4096)
