"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and is marked `gpu`; without one it
skips.  The file imports neither jax nor the JAX package, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances, per kernel:
- K1 split_scan: feature, threshold and default_left equal; sums, outputs
  and gains rtol 1e-5 (the kernel rounds as the plain version does, in
  another order only where a block reduction sums);
- K2 segment_histogram: counts equal; g/h within 1e-5 of each bin's sum of
  |values| (shared-memory atomics add in a varying order; the plain version
  sums in f64);
- K3 partition_segment and K4 scatter_segments: exact;
- K3 in pred mode with the hist_stream histogram (the bagged root): counts
  and planes exact; the histogram exact for codes, for f32 as K2's; at
  G=28 and at G=80, whose [G, 255, 3] histogram exceeds one block's shared
  memory (the kernel then walks its rows once more per feature chunk);
- the binned tree walk: equal leaves on the card and the CPU;
- K2 in int8 mode, K5 fused_refresh_histogram, K6 compact_carry and K3 with
  the code payload: exact (integer atomics are order-independent);
- a grown tree on dyadic gradients (every sum exact in f32): the same
  splits and leaf ids, leaf values rtol 1e-6; the same for a bagged tree,
  f32 and quantized, with -1 at the out-of-bag rows;
- a quantized tree on a carried root, compacted by K6: the same splits,
  thresholds, leaf ids and carried row order, leaf values rtol 1e-6;
- quantization: the same f32 gradients give equal codes and scales on the
  card and the CPU; from each device's own binary-logloss gradients the
  gradients agree to 1e-6, at most one code in a thousand differs, and one
  integer histogram dequantized and summed over a feature's bins agrees to
  1e-5 of its |value| sum (`-s` prints what was found);
- K7 leaf_histogram over row-major bins, at the root and on a masked
  child, G=28 and G=80 (two feature chunks at B=255), max_bin 16 and 255:
  f32 as K2's tolerance, int8 exact;
- a 63-leaf label-engine tree (K7 and K1) on dyadic gradients over a bag:
  the same splits, default directions, counts and leaf ids as on the CPU,
  leaf values rtol 1e-6;
- K8 partition_ablate: every stage equal to its plain version (the
  per-tile checksums of the read, decide, lookback and stage stages, the
  full stage's planes);
- the races of the single-pass K3 (tiles by ticket, decoupled look-back,
  stream A in place) and of K7's row list: in place, out of place and
  overlapping from before, at segment counts 0, 1, T-1, T, T+1 and several
  tiles, pred mode at G=80 in place, K7 on empty, `done` and full leaves,
  each 50 times in a row, exact (histograms as above); K3's 512-row tile
  shapes (G=120 and G=300) 10 times;
- K2's block schedule: the root, a 40k child at an unaligned start, cnt 0
  and 1, a few rows across a chunk boundary, on uniform and on skewed bins
  (2-3 bins, 96% of the rows in one), each 50 times, and G = 3, 33 and 80
  (feature passes and chunks): tolerances as above; int8 at 2^20 rows (a
  row a thread) and one row more (the slabs), exact;
- K1 at B = 2 to 1024, one and two children, 50 launches back to back on
  different inputs (the fused select's tickets), and 50 launches on each
  of two streams at once: feature, threshold and default_left equal,
  gains and the selected rows rtol 1e-5;
- K6's 16-byte copies: leaves of 0 to 2 rows (40 live of 255), a skewed
  tree (one leaf of half the rows, the rest geometric down to 20) and
  255 even leaves, sources at any column in a shuffled order, dst0
  256-aligned or not, G = 28 and 40, f32 and int8: exact, every plane of
  the whole arena;
- K5 on both of K2's bodies (2^20 rows, a row a thread; 2^20 + 1 and
  more, the slabs), starts 0, 4096 and odd, fewer rows than codes, G = 28
  and 40, B = 63 and 255: exact.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops import split_kernel as sk
from lightgbm_tpu_torch.ops.grow import predict_leaf_inner
from lightgbm_tpu_torch.ops import quantize as qz
from lightgbm_tpu_torch.ops.grow_partition import grow_tree_partition
from lightgbm_tpu_torch.ops.split import SplitParams

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _rand_hist(rng, F, B, n_rows=50_000):
    cnt = rng.multinomial(n_rows, np.ones(F * B) / (F * B)).reshape(F, B)
    g = rng.standard_normal((F, B)) * np.sqrt(cnt + 1e-3)
    h = rng.random((F, B)) * cnt * 0.25 + cnt * 1e-3
    return np.stack([g, h, cnt.astype(np.float64)], axis=-1).astype(np.float32)


def _split_case(name):
    """(hist [CH, F, B, 3], statics and params) per case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    F, B = 28, 255
    c = dict(hist=np.stack([_rand_hist(rng, F, B), _rand_hist(rng, F, B)]),
             nb=rng.integers(3, B + 1, F), db=rng.integers(0, 3, F),
             mt=rng.integers(0, 3, F), params=dict(min_data_in_leaf=20))
    if name == "regularization_monotone":
        c.update(mt=np.ones(F, int), monotone=rng.integers(-1, 2, F),
                 minc=np.array([-0.2, -np.inf]), maxc=np.array([0.2, np.inf]),
                 params=dict(lambda_l1=0.5, lambda_l2=2.0, max_delta_step=0.4,
                             min_data_in_leaf=50, min_sum_hessian_in_leaf=1.0,
                             min_gain_to_split=0.1))
    elif name == "penalties_mask":
        c.update(penalty=rng.random(F) + 0.5, fmask=rng.random(F) > 0.3,
                 cegb=rng.random(F) * 0.1,
                 params=dict(min_data_in_leaf=5, cegb_split_penalty=1e-6))
    elif name == "two_bins":
        c.update(nb=np.full(F, 2), mt=rng.integers(0, 3, F))
    elif name == "degenerate":
        c["hist"][1, ..., 0] = 0.0
        c["hist"][1, ..., 2] = 10.0
        c["hist"][1, ..., 1] = 2.5
    return c


SPLIT_CASES = ["missing_mixed", "regularization_monotone", "penalties_mask",
               "two_bins", "degenerate"]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_scan_matches_plain(name, dev):
    c = _split_case(name)
    hist = torch.from_numpy(c["hist"]).to(dev)

    def t(key, dt):
        v = c.get(key)
        return None if v is None else torch.as_tensor(np.asarray(v)).to(
            device=dev, dtype=dt)
    fvec = sk.build_feature_statics(
        t("nb", torch.int32), t("db", torch.int32), t("mt", torch.int32),
        monotone=t("monotone", torch.int32), penalty=t("penalty", torch.float32),
        feature_mask=t("fmask", torch.bool),
        cegb_feature_penalty=t("cegb", torch.float32), children=2)
    svec = sk.child_vector(hist[:, 0, :, 0].sum(1), hist[:, 0, :, 1].sum(1),
                           hist[:, 0, :, 2].sum(1), c.get("minc"),
                           c.get("maxc")).to(dev)
    pvec = sk.params_vector(SplitParams(**c["params"]), dev)
    rows_k, best_k = sk.split_scan(hist, fvec, svec, pvec)
    torch.cuda.synchronize()
    rows_p, best_p = sk.split_scan_plain(hist, fvec, svec, pvec)
    lanes = [sk._OF, sk._OT, sk._ODL]
    valid = rows_p[:, sk._OG] > sk.NEG_GATE
    assert torch.equal(rows_k[:, sk._OG] > sk.NEG_GATE, valid)
    assert torch.equal(rows_k[valid][:, lanes], rows_p[valid][:, lanes])
    assert torch.equal(best_k[:, lanes], best_p[:, lanes])
    torch.testing.assert_close(rows_k[valid], rows_p[valid], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(best_k, best_p, rtol=1e-5, atol=1e-5)


def _arenas(dev, n=300_000, F=28, B=255, seed=6):
    """Two equal arenas (kernel, plain) over random bins and g/h."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    h = torch.from_numpy((rng.rand(n) * 0.25 + 0.01).astype(np.float32))
    out = []
    for _ in range(2):
        a = pk.Arena(n, F, 6, dev)
        pk.init_pristine(a, bins.to(dev))
        a.payload[0, :n] = g.to(dev)
        a.payload[1, :n] = h.to(dev)
        out.append(a)
    return out


@pytest.mark.parametrize("start,cnt", [(0, 300_000), (12_345, 40_000),
                                       (777, 1), (5, 0)])
def test_segment_histogram_matches_plain(start, cnt, dev):
    ak, _ = _arenas(dev)
    seg = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
    got = pk.segment_histogram(ak, seg, 255)
    torch.cuda.synchronize()
    want = pk.segment_histogram_plain(ak, seg, 255)
    assert torch.equal(got[..., 2], want[..., 2])
    ak.payload[0].abs_()
    scale = pk.segment_histogram_plain(ak, seg, 255)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("xr", [0, 1])
def test_partition_segment_matches_plain(in_place, xr, dev):
    ak, ap = _arenas(dev)
    n = ak.num_data
    work0 = pk.pristine_work0(n)
    goleft = (torch.arange(256, device=dev) < 100).to(torch.uint8)
    goleft[7] = 1                    # a missing-style bin routed left
    # the root's split off the pristine block, then a child split in place
    sc = torch.tensor([0, n, work0, 2 * work0, 0, 0, 3, xr],
                      dtype=torch.int32, device=dev)
    if in_place:
        for a in (ak, ap):
            pk.partition_segment_plain(a, sc.clone(), goleft)
        sc = torch.tensor([work0 + 512, 100_000, work0 + 512, 3 * work0, 0, 0,
                           11, xr], dtype=torch.int32, device=dev)
    sc_p = sc.clone()
    pk.partition_segment(ak, sc, goleft)
    torch.cuda.synchronize()
    pk.partition_segment_plain(ap, sc_p, goleft)
    assert torch.equal(sc, sc_p)
    assert torch.equal(ak.rid, ap.rid)
    assert torch.equal(ak.bins, ap.bins)
    assert torch.equal(ak.payload, ap.payload)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_scatter_segments_matches_plain(dtype, dev):
    ak, _ = _arenas(dev)
    n = ak.num_data
    rng = np.random.RandomState(3)
    ak.rid[:n] = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    L, live = 255, 250
    cuts = np.sort(rng.choice(np.arange(1, n), live - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    seg = np.zeros((L, 2), np.int32)
    seg[:live, 0], seg[:live, 1] = bounds[:-1], np.diff(bounds)
    seg = torch.from_numpy(seg).to(dev)
    vals = (torch.randn(L, device=dev) if dtype == torch.float32
            else torch.arange(L, dtype=torch.int32, device=dev))
    nl = torch.tensor([live], dtype=torch.int32, device=dev)
    out_k = torch.full((n,), -1, dtype=dtype, device=dev)
    out_p = out_k.clone()
    pk.scatter_segments(ak, seg, vals, nl, out_k)
    torch.cuda.synchronize()
    pk.scatter_segments_plain(ak, seg, vals, nl, out_p)
    assert torch.equal(out_k, out_p)


def test_grown_tree_matches_cpu(dev):
    """One 63-leaf tree grown through the four kernels on the card against
    the same tree grown through the plain versions on the CPU.  Gradients
    and hessians are multiples of 1/8 whose sums stay below 2^21, so every
    histogram sum is exact in f32 whatever the order of the atomics, and the
    two trees must agree split for split."""
    rng = np.random.RandomState(9)
    n, F, B = 50_000, 8, 64
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    grad = torch.from_numpy((rng.randint(-8, 9, n) / 8).astype(np.float32))
    hess = torch.from_numpy((rng.randint(1, 9, n) / 8).astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        arena = pk.Arena(n, F, 4, d)
        pk.init_pristine(arena, bins.to(d))
        nb = torch.full((F,), B, dtype=torch.int32, device=d)
        z = torch.zeros(F, dtype=torch.int32, device=d)
        tree, ids, trunc = grow_tree_partition(
            arena, grad.to(d), hess.to(d), torch.ones(F, dtype=torch.bool,
                                                      device=d),
            nb, z, z, SplitParams(min_data_in_leaf=20), max_leaves=63,
            max_bin=B, emit="leaf_ids")
        out[d.type] = (tree, ids.cpu(), bool(trunc))
    (tk, ik, fk), (tp, ip, fp) = out["cuda"], out["cpu"]
    assert not fk and not fp
    assert int(tk.num_leaves) == int(tp.num_leaves) == 63
    assert torch.equal(tk.split_feature.cpu(), tp.split_feature)
    assert torch.equal(tk.threshold_bin.cpu(), tp.threshold_bin)
    assert torch.equal(ik, ip)
    torch.testing.assert_close(tk.leaf_value.cpu(), tp.leaf_value, rtol=1e-6,
                               atol=0.0)


def _code_arenas(dev, n=300_000, F=28, B=255, seed=7):
    """Two equal quantized arenas (kernel, plain) over random bins and
    codes; the codes also returned as [2, n] int8 on the card."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    codes = torch.from_numpy(np.stack([
        rng.randint(-127, 128, n), rng.randint(0, 128, n)]).astype(np.int8))
    out = []
    for _ in range(2):
        a = pk.Arena(n, F, 6, dev, quantized=True)
        pk.init_pristine(a, bins.to(dev))
        a.payload[:, :n] = codes.to(dev)
        out.append(a)
    return out, codes.to(dev)


@pytest.mark.parametrize("start,cnt", [(0, 300_000), (12_345, 40_000),
                                       (777, 1), (5, 0)])
def test_segment_histogram_int8_matches_plain(start, cnt, dev):
    (ak, _), _ = _code_arenas(dev)
    seg = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
    got = pk.segment_histogram(ak, seg, 255)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, pk.segment_histogram_plain(ak, seg, 255))


@pytest.mark.parametrize("start", [0, 4096])
def test_fused_refresh_histogram_matches_plain(start, dev):
    (ak, ap), codes = _code_arenas(dev)
    n = ak.num_data
    fresh = torch.flip(codes, dims=[1]).contiguous()
    for a in (ak, ap):
        a.payload.zero_()
    seg = torch.tensor([start, n - start], dtype=torch.int32, device=dev)
    got = pk.fused_refresh_histogram(ak, fresh, seg, 255)
    torch.cuda.synchronize()
    want = pk.fused_refresh_histogram_plain(ap, fresh, seg, 255)
    assert torch.equal(got, want)
    assert torch.equal(ak.payload, ap.payload)
    assert torch.equal(ak.payload[:, start:n], fresh[:, :n - start])
    assert torch.equal(ak.bins, ap.bins) and torch.equal(ak.rid, ap.rid)


@pytest.mark.parametrize("in_place", [False, True])
def test_partition_segment_codes_matches_plain(in_place, dev):
    (ak, ap), _ = _code_arenas(dev)
    n = ak.num_data
    work0 = pk.pristine_work0(n)
    goleft = (torch.arange(256, device=dev) < 90).to(torch.uint8)
    sc = torch.tensor([0, n, work0, 2 * work0, 0, 0, 5, 1],
                      dtype=torch.int32, device=dev)
    if in_place:
        for a in (ak, ap):
            pk.partition_segment_plain(a, sc.clone(), goleft)
        sc = torch.tensor([work0 + 256, 90_000, work0 + 256, 3 * work0, 0, 0,
                           20, 0], dtype=torch.int32, device=dev)
    sc_p = sc.clone()
    pk.partition_segment(ak, sc, goleft)
    torch.cuda.synchronize()
    pk.partition_segment_plain(ap, sc_p, goleft)
    assert torch.equal(sc, sc_p)
    assert torch.equal(ak.rid, ap.rid)
    assert torch.equal(ak.bins, ap.bins)
    assert torch.equal(ak.payload, ap.payload)


@pytest.mark.parametrize("quantized", [False, True])
def test_compact_carry_matches_plain(quantized, dev):
    """255 leaf segments (250 live) over a permuted arena, compacted past
    them."""
    if quantized:
        (ak, ap), _ = _code_arenas(dev)
    else:
        ak, ap = _arenas(dev)
    n = ak.num_data
    rng = np.random.RandomState(4)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    for a in (ak, ap):
        a.rid[:n] = perm
    L, live = 255, 250
    cuts = np.sort(rng.choice(np.arange(1, n), live - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    order = rng.permutation(live)      # leaf order is not column order
    seg = np.full((L, 2), 4096, np.int32)   # dead leaves: never read
    seg[:live, 0], seg[:live, 1] = bounds[:-1][order], np.diff(bounds)[order]
    seg = torch.from_numpy(seg).to(dev)
    nl = torch.tensor([live], dtype=torch.int32, device=dev)
    dst0 = 2 * pk.pristine_work0(n)
    used_k = pk.compact_carry(ak, seg, nl, dst0)
    torch.cuda.synchronize()
    used_p = pk.compact_carry_plain(ap, seg, nl, dst0)
    assert torch.equal(used_k.cpu(), used_p.cpu())
    assert int(used_k[0]) == n
    assert torch.equal(ak.rid, ap.rid)
    assert torch.equal(ak.bins, ap.bins)
    assert torch.equal(ak.payload, ap.payload)


def _layout_arenas(dev, n, G, quantized, seed):
    """Two equal arenas (kernel, plain) of n rows over G bin planes with
    random bins, payload and row ids in the whole arena, not only the
    pristine block, so every copied column carries distinct data."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        a = pk.Arena(n, G, 6, dev, quantized=quantized)
        out.append(a)
    cap = out[0].cap
    bins = torch.from_numpy(rng.randint(0, 256, (G, cap)).astype(np.uint8))
    rid = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, cap,
                                       dtype=np.int64).astype(np.int32))
    if quantized:
        pay = torch.from_numpy(rng.randint(-128, 128, (2, cap)).astype(np.int8))
    else:
        pay = torch.from_numpy(rng.randn(2, cap).astype(np.float32))
    for a in out:
        a.bins.copy_(bins.to(dev))
        a.payload.copy_(pay.to(dev))
        a.rid.copy_(rid.to(dev))
    return out


def _carry_layout(kind, n, rng):
    """Leaf row counts of one layout, summing to at most n: 'tiny' (0, 1
    and 2 rows), 'skewed' (one leaf of half the rows, the rest geometric
    down to 20) and 'even' (255 equal leaves)."""
    if kind == "tiny":
        return rng.choice([0, 1, 2], 255)
    if kind == "skewed":
        rest = np.maximum(20, (n / 4 * 0.96 ** np.arange(254)).astype(int))
        rest = np.maximum(20, (rest * (n // 2) // rest.sum()))
        return np.concatenate([[n // 2], rest])
    return np.full(255, n // 255)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G", [28, 40])
@pytest.mark.parametrize("kind", ["tiny", "skewed", "even"])
@pytest.mark.parametrize("dst_aligned", [True, False])
def test_compact_carry_layouts(kind, G, quantized, dst_aligned, dev):
    """K6 on layouts the 16-byte copies must handle: leaves of 0 to 2 rows
    (units spanning leaves), one leaf of half the rows beside small ones,
    equal leaves; sources at any column in a shuffled leaf order, 40 live
    of 255 for the tiny layout (dead segments hold garbage); dst0
    256-aligned or not; G = 28 and 40.  Exact, every plane, and nothing
    outside the block written."""
    n = 200_000
    rng = np.random.RandomState(G + 7 * dst_aligned + len(kind))
    ak, ap = _layout_arenas(dev, n, G, quantized, seed=3)
    counts = _carry_layout(kind, n, rng)
    L = len(counts)
    live = 40 if kind == "tiny" else L
    starts = np.full(L, 2 ** 30, np.int64)      # dead leaves: never read
    pos = 3
    for leaf in rng.permutation(live):
        pos += int(rng.randint(0, 40))
        starts[leaf] = pos
        pos += int(counts[leaf])
    total = int(counts[:live].sum())
    dst0 = -(-pos // 2048) * 2048 + (256 * 3 if dst_aligned else 1001)
    assert dst0 + total <= ak.cap
    seg = torch.from_numpy(np.stack([starts, counts], 1).astype(np.int32)
                           ).to(dev)
    nl = torch.tensor([live], dtype=torch.int32, device=dev)
    used_k = pk.compact_carry(ak, seg, nl, dst0)
    torch.cuda.synchronize()
    used_p = pk.compact_carry_plain(ap, seg, nl, dst0)
    assert int(used_k[0]) == int(used_p[0]) == total
    assert torch.equal(ak.bins, ap.bins)
    assert torch.equal(ak.payload, ap.payload)
    assert torch.equal(ak.rid, ap.rid)


def _root_code_arenas(dev, n, G, B, ncodes, seed):
    """Two equal quantized arenas over random bins and code planes, and
    fresh [2, ncodes] codes for K5, on the card."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8))
    old = torch.from_numpy(rng.randint(-127, 128, (2, n)).astype(np.int8))
    out = []
    for _ in range(2):
        a = pk.Arena(n, G, 3, dev, quantized=True)
        a.bins[:, :n] = bins.to(dev)
        a.bins[:, n:] = 7
        a.payload[:, :n] = old.to(dev)
        out.append(a)
    fresh = torch.from_numpy(np.stack([
        rng.randint(-127, 128, ncodes), rng.randint(0, 128, ncodes)]
    ).astype(np.int8)).to(dev)
    return out, fresh


@pytest.mark.parametrize("G", [28, 40])
@pytest.mark.parametrize("B", [63, 255])
@pytest.mark.parametrize("start,cnt,extra", [
    (0, (1 << 20) + 1, 0),          # the slabs, every code used
    (4096, 1 << 20, 5_000),         # a row a thread, cnt < ncodes
    (777, (1 << 20) + 3_001, 17),   # the slabs from an odd start
    (13, 300_001, 99)])             # a row a thread from an odd start
def test_fused_refresh_histogram_cases(start, cnt, extra, G, B, dev):
    """K5 on both bodies (segments of at most 2^20 rows a row a thread,
    above that the slabs), G = 28 (one slab) and 40 (two), B = 63 and
    255, starts 0, 4096 and odd, cnt below the codes' length: the
    histogram, the code planes (written at [start, start + cnt) only) and
    the untouched bins and row ids exact."""
    n = start + cnt + 4_000
    (ak, ap), fresh = _root_code_arenas(dev, n, G, B, cnt + extra,
                                        seed=G + B + start)
    seg = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
    got = pk.fused_refresh_histogram(ak, fresh, seg, B)
    torch.cuda.synchronize()
    want = pk.fused_refresh_histogram_plain(ap, fresh, seg, B)
    assert int(want[..., 2].sum()) == G * cnt
    assert torch.equal(got, want)
    assert torch.equal(ak.payload, ap.payload)
    assert torch.equal(ak.payload[:, start:start + cnt], fresh[:, :cnt])
    assert torch.equal(ak.bins, ap.bins) and torch.equal(ak.rid, ap.rid)


def test_quantized_carried_tree_matches_cpu(dev):
    """One 63-leaf quantized tree on a carried root, compacted by K6, on the
    card against the same tree through the plain versions on the CPU.  The
    histograms are exact integers on both, so the trees agree split for
    split and the carried row order is equal."""
    rng = np.random.RandomState(10)
    n, F, B = 60_000, 8, 64
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    grad = torch.from_numpy(rng.randn(n).astype(np.float32))
    hess = torch.from_numpy((rng.rand(n) * 0.25 + 0.01).astype(np.float32))
    g_code, h_code, gs, hs = qz.quantize_gradients(grad, hess,
                                                   qz.quantize_key(3, 1))
    work0 = pk.pristine_work0(n)
    n_al = -(-n // pk.TILE) * pk.TILE
    slots = (work0, work0 + n_al + pk.TILE)
    bump0 = slots[1] + n_al + pk.TILE
    out = {}
    for d in (dev, torch.device("cpu")):
        arena = pk.Arena(n, F, 6, d, quantized=True)
        pk.init_pristine(arena, bins.to(d))
        arena.bins[:, slots[0]:slots[0] + n] = bins.to(d)[:, perm.long().to(d)]
        arena.rid[slots[0]:slots[0] + n] = perm.to(d)
        nb = torch.full((F,), B, dtype=torch.int32, device=d)
        z = torch.zeros(F, dtype=torch.int32, device=d)
        tree, ids, trunc = grow_tree_partition(
            arena, g_code.to(d), h_code.to(d),
            torch.ones(F, dtype=torch.bool, device=d), nb, z, z,
            SplitParams(min_data_in_leaf=20), max_leaves=63, max_bin=B,
            emit="leaf_ids", quant_scales=(gs.to(d), hs.to(d)),
            carried_root=slots[0], carried_bump0=bump0, carry_dst=slots[1])
        out[d.type] = (tree, ids.cpu(), bool(trunc),
                       arena.rid[slots[1]:slots[1] + n].cpu())
    (tk, ik, fk, rk), (tp, ip, fp, rp) = out["cuda"], out["cpu"]
    assert not fk and not fp
    assert int(tk.num_leaves) == int(tp.num_leaves) == 63
    assert torch.equal(tk.split_feature.cpu(), tp.split_feature)
    assert torch.equal(tk.threshold_bin.cpu(), tp.threshold_bin)
    assert torch.equal(ik, ip)
    assert torch.equal(rk, rp)
    assert torch.equal(torch.sort(rk).values,
                       torch.arange(n, dtype=torch.int32))
    torch.testing.assert_close(tk.leaf_value.cpu(), tp.leaf_value, rtol=1e-6,
                               atol=0.0)


def _higgs_like(n, seed):
    """chip_smoke.py's Higgs-shaped generator: features and labels."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32)
    w = rng.randn(28)
    logits = X @ w * 0.5 + 0.8 * np.sin(X[:, 0] * 2) * X[:, 1]
    return X, (logits + rng.randn(n) > 0).astype(np.float32)


def test_quantized_codes_card_vs_cpu(dev):
    """The first quantized tree's codes of chip_smoke.py's 20k-row parity
    data, on the card and on the CPU: where the two can part."""
    import lightgbm_tpu_torch as lt
    X, y = _higgs_like(20_000, 11)
    n = len(y)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "tpu_quantized_grad": True}
    got = {}
    for d in (dev, torch.device("cpu")):
        g = lt.Booster(params, lt.Dataset(X, y, device=d), device=d)._gbdt
        score = torch.full((n,), g.objective.boost_from_score(0),
                           dtype=torch.float32, device=d)
        grad, hess = g.objective.get_gradients(score)
        key = qz.quantize_key(g._quant_seed, 0)
        got[d.type] = (g, grad, hess, key,
                       qz.quantize_gradients(grad, hess, key))
    gp, grad_c, hess_c, key, (gcc, hcc, gsc, hsc) = got["cpu"]
    _, grad_k, hess_k, _, (gck, hck, gsk, hsk) = got["cuda"]
    same = qz.quantize_gradients(grad_c.to(dev), hess_c.to(dev), key)
    for a, b in zip(same, (gcc, hcc, gsc, hsc)):
        assert torch.equal(a.cpu(), b)
    grad_k, hess_k = grad_k.cpu(), hess_k.cpu()
    assert float((grad_k - grad_c).abs().max()) <= 1e-6
    assert float((hess_k - hess_c).abs().max()) <= 1e-6
    codes_differ = int((gck.cpu() != gcc).sum() + (hck.cpu() != hcc).sum())
    assert codes_differ <= n // 1000
    hist = pk.code_histogram_plain(gp.arena.bins[:, :n],
                                   torch.stack([gcc, hcc]), gp.max_bin)
    g_bins = {d: qz.dequantize_hist(hist.to(d), gsc.to(d),
                                    hsc.to(d))[0, :, 0]
              for d in ("cpu", dev)}
    sums = {d: float(v.sum()) for d, v in g_bins.items()}
    assert abs(sums["cpu"] - sums[dev]) <= 1e-5 * float(
        g_bins["cpu"].abs().sum())
    print("\ncodes card vs cpu (%d rows, first tree): gradients differ in "
          "%d rows, hessians in %d; %d codes differ; scales equal: %s; "
          "feature 0's g sum over its bins from one integer histogram: CPU "
          "%r, card %r" % (n, int((grad_k != grad_c).sum()),
                           int((hess_k != hess_c).sum()), codes_differ,
                           bool(gsk.cpu() == gsc and hsk.cpu() == hsc),
                           sums["cpu"], sums[dev]))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G", [28, 80])
def test_partition_pred_hist_matches_plain(quantized, G, dev):
    """The bagged root pass at 0.8 of the rows; G=80 at B=255 needs two
    shared-memory chunks of features (66 + 14)."""
    n = 300_000 if G == 28 else 100_000
    if quantized:
        (ak, ap), _ = _code_arenas(dev, n=n, F=G)
    else:
        ak, ap = _arenas(dev, n=n, F=G)
    rng = np.random.RandomState(12)
    pred = torch.from_numpy((rng.rand(n) < 0.8).astype(np.uint8)).to(dev)
    work0 = pk.pristine_work0(n)
    n_al = -(-n // pk.TILE) * pk.TILE
    sc = torch.tensor([0, n, work0, work0 + n_al, 0, 0, 0, 0],
                      dtype=torch.int32, device=dev)
    sc_p = sc.clone()
    got = pk.partition_segment_pred(ak, sc, pred, hist_stream=0, max_bin=255)
    torch.cuda.synchronize()
    want = pk.partition_segment_pred_plain(ap, sc_p, pred, 0, 255)
    assert torch.equal(sc, sc_p)
    assert int(sc[pk.SC_CNT_A]) == int(pred.sum())
    assert torch.equal(ak.rid, ap.rid)
    assert torch.equal(ak.bins, ap.bins)
    assert torch.equal(ak.payload, ap.payload)
    if quantized:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        assert torch.equal(got[..., 2], want[..., 2])
        rows = ap.payload[:, work0:work0 + int(sc[pk.SC_CNT_A])].clone()
        ap.payload[0, work0:work0 + rows.shape[1]] = rows[0].abs()
        seg = sc[[pk.SC_DST_A, pk.SC_CNT_A]].contiguous()
        scale = pk.segment_histogram_plain(ap, seg, 255)
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_predict_leaf_inner_card_vs_cpu(dev):
    """A 63-leaf tree grown on the CPU, walked over the same bins with every
    missing type on the card and on the CPU."""
    rng = np.random.RandomState(14)
    n, F, B = 200_000, 8, 64
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    grad = torch.from_numpy(rng.randn(n).astype(np.float32))
    hess = torch.from_numpy((rng.rand(n) + 0.1).astype(np.float32))
    arena = pk.Arena(n, F, 4, "cpu")
    pk.init_pristine(arena, bins)
    nb = torch.full((F,), B, dtype=torch.int32)
    db = torch.from_numpy(rng.randint(0, B, F).astype(np.int32))
    mt = torch.arange(F, dtype=torch.int32) % 3
    tree, _, _ = grow_tree_partition(
        arena, grad, hess, torch.ones(F, dtype=torch.bool), nb, db, mt,
        SplitParams(min_data_in_leaf=20), max_leaves=63, max_bin=B)
    depth = int(tree.leaf_depth.max())
    bins_rows = bins.t().contiguous()
    want = predict_leaf_inner(bins_rows, tree, nb, db, depth=depth)
    on_card = type(tree)(*(t.to(dev) for t in tree))
    for d in (depth, depth + 3):
        got = predict_leaf_inner(bins_rows.to(dev), on_card, nb.to(dev),
                                 db.to(dev), depth=d)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("quantized", [False, True])
def test_bagged_tree_matches_cpu(quantized, dev):
    """One 63-leaf tree on a bag of 0.8 of the rows, its root by K3 in pred
    mode with the hist_stream histogram, on the card against the CPU.
    Gradients and hessians are multiples of 1/128 up to 127/128, so every
    f32 sum is exact whatever its order, and quantized the scales are
    exactly 1/128 and every dequantized sum exact too (the root's sum over
    bins is an f32 sum in each library's order)."""
    rng = np.random.RandomState(15)
    n, F, B = 60_000, 8, 64
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    g = rng.randint(-127, 128, n)
    h = rng.randint(1, 128, n)
    g[0], h[0] = 127, 127
    grad = torch.from_numpy((g / 128).astype(np.float32))
    hess = torch.from_numpy((h / 128).astype(np.float32))
    kw = {}
    if quantized:
        grad, hess, gs, hs = qz.quantize_gradients(grad, hess,
                                                   qz.quantize_key(3, 2))
    in_bag = torch.from_numpy((rng.rand(n) < 0.8).astype(np.uint8))
    out = {}
    for d in (dev, torch.device("cpu")):
        arena = pk.Arena(n, F, 6, d, quantized=quantized)
        pk.init_pristine(arena, bins.to(d))
        if quantized:
            kw = dict(quant_scales=(gs.to(d), hs.to(d)))
        nb = torch.full((F,), B, dtype=torch.int32, device=d)
        z = torch.zeros(F, dtype=torch.int32, device=d)
        tree, ids, trunc = grow_tree_partition(
            arena, grad.to(d), hess.to(d),
            torch.ones(F, dtype=torch.bool, device=d), nb, z, z,
            SplitParams(min_data_in_leaf=20), max_leaves=63, max_bin=B,
            emit="leaf_ids", in_bag=in_bag.to(d), **kw)
        out[d.type] = (tree, ids.cpu(), bool(trunc))
    (tk, ik, fk), (tp, ip, fp) = out["cuda"], out["cpu"]
    assert not fk and not fp
    assert int(tk.num_leaves) == int(tp.num_leaves) == 63
    assert int(tk.leaf_count.sum()) == int(in_bag.sum())
    assert torch.equal(tk.split_feature.cpu(), tp.split_feature)
    assert torch.equal(tk.threshold_bin.cpu(), tp.threshold_bin)
    assert torch.equal(tk.leaf_count.cpu(), tp.leaf_count)
    assert torch.equal(ik, ip)
    assert torch.equal(ik < 0, in_bag == 0)
    torch.testing.assert_close(tk.leaf_value.cpu(), tp.leaf_value, rtol=1e-6,
                               atol=0.0)


# --------------------------------------------------------------------------- #
# K7 leaf_histogram, the label engine, K8 partition_ablate
# --------------------------------------------------------------------------- #
def _leaf_inputs(dev, n, G, B, seed, quantized):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, (n, G)).astype(np.uint8))
    if quantized:
        g = torch.from_numpy(rng.randint(-127, 128, n).astype(np.int8))
        h = torch.from_numpy(rng.randint(0, 128, n).astype(np.int8))
        ids = torch.from_numpy(rng.randint(0, 8, n).astype(np.uint8))
    else:
        g = torch.from_numpy(rng.randn(n).astype(np.float32))
        h = torch.from_numpy((rng.rand(n) * 0.25 + 0.01).astype(np.float32))
        ids = torch.from_numpy(rng.randint(-1, 7, n).astype(np.int32))
    return [t.to(dev) for t in (bins, g, h, ids)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B", [16, 255])
@pytest.mark.parametrize("G", [28, 80])
def test_leaf_histogram_matches_plain(G, B, quantized, dev):
    """K7 at the root (every row in leaf 0) and on a masked child (one
    leaf of eight); G=80 at B=255 needs two feature chunks (66 + 14)."""
    from lightgbm_tpu_torch.ops import histogram_kernel as hk
    n = 300_000 if G == 28 else 100_000
    bins, g, h, ids = _leaf_inputs(dev, n, G, B, G + B, quantized)
    fn = hk.leaf_histogram_quantized if quantized else hk.leaf_histogram
    plain = (hk.leaf_histogram_quantized_plain if quantized
             else hk.leaf_histogram_plain)
    for leaf_ids, leaf in ((torch.zeros_like(ids), 0), (ids, 5)):
        leaf_t = torch.tensor([leaf], dtype=torch.int32, device=dev)
        got = fn(bins, g, h, leaf_ids, leaf_t, B)
        torch.cuda.synchronize()
        want = plain(bins, g, h, leaf_ids, leaf_t, B)
        assert int(want[0, :, 2].sum()) == int((leaf_ids.int() == leaf).sum())
        if quantized:
            assert got.dtype == torch.int32 and torch.equal(got, want)
            continue
        assert torch.equal(got[..., 2], want[..., 2])
        scale = plain(bins, g.abs(), h, leaf_ids, leaf_t, B)
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_label_tree_matches_cpu(dev):
    """One 63-leaf label-engine tree on the card (K7 and K1) against the
    same tree on the CPU, over a bag of 0.8 of the rows.  Gradients and
    hessians are multiples of 1/8 whose sums stay below 2^21, so every
    histogram sum is exact in f32 whatever the order of the atomics."""
    from lightgbm_tpu_torch.ops import _cuda
    from lightgbm_tpu_torch.ops.grow import grow_tree_label
    rng = np.random.RandomState(16)
    n, F, B = 80_000, 8, 64
    bins = torch.from_numpy(rng.randint(0, B, (n, F)).astype(np.uint8))
    grad = torch.from_numpy((rng.randint(-8, 9, n) / 8).astype(np.float32))
    hess = torch.from_numpy((rng.randint(1, 9, n) / 8).astype(np.float32))
    row0 = torch.from_numpy(np.where(rng.rand(n) < 0.8, 0, -1)
                            .astype(np.int32))
    out = {}
    for d in (dev, torch.device("cpu")):
        _cuda.reset_launch_counts()
        nb = torch.full((F,), B, dtype=torch.int32, device=d)
        mt = torch.arange(F, dtype=torch.int32, device=d) % 3
        tree, ids = grow_tree_label(
            bins.to(d), grad.to(d), hess.to(d), row0.to(d),
            torch.ones(F, dtype=torch.bool, device=d), nb,
            torch.full((F,), 3, dtype=torch.int32, device=d), mt,
            SplitParams(min_data_in_leaf=20), max_leaves=63, max_bin=B,
            hist_impl="pallas")
        out[d.type] = (tree, ids.cpu(), dict(_cuda.LAUNCHES))
    (tk, ik, lk), (tp, ip, lp) = out["cuda"], out["cpu"]
    assert lk["leaf_histogram"] == 63 and lk["split_scan"] == 63 and not lp
    assert int(tk.num_leaves) == int(tp.num_leaves) == 63
    assert torch.equal(tk.split_feature.cpu(), tp.split_feature)
    assert torch.equal(tk.threshold_bin.cpu(), tp.threshold_bin)
    assert torch.equal(tk.default_left.cpu(), tp.default_left)
    assert torch.equal(tk.leaf_count.cpu(), tp.leaf_count)
    assert torch.equal(ik, ip)
    assert torch.equal(ik < 0, row0 < 0)
    torch.testing.assert_close(tk.leaf_value.cpu(), tp.leaf_value, rtol=1e-6,
                               atol=0.0)


@pytest.mark.parametrize("quantized", [False, True])
def test_partition_ablate_matches_plain(quantized, dev):
    """Every K8 stage against its plain version: the per-tile checksums of
    the read, decide, lookback and stage stages, the counts of the last
    two, and the full stage (K3); no stage before it moves a row."""
    n = 300_000
    if quantized:
        (ak, ap), _ = _code_arenas(dev, n=n)
    else:
        ak, ap = _arenas(dev, n=n)
    goleft = (torch.arange(256, device=dev) < 127).to(torch.uint8)
    dst_b = pk.pristine_work0(n)
    for stage in pk.ABLATE_STAGES:
        sc = torch.tensor([0, n, 0, dst_b, 0, 0, 2, 0], dtype=torch.int32,
                          device=dev)
        sc_p = sc.clone()
        got = pk.partition_ablate(ak, sc, goleft, stage)
        torch.cuda.synchronize()
        want = pk.partition_ablate_plain(ap, sc_p, goleft, stage)
        assert torch.equal(sc, sc_p), stage
        if stage != "full":
            assert torch.equal(got, want), stage
        assert torch.equal(ak.bins, ap.bins), stage
        assert torch.equal(ak.payload, ap.payload), stage
        assert torch.equal(ak.rid, ap.rid), stage


# --------------------------------------------------------------------------- #
# races of the single-pass K3 (ticket order, decoupled look-back, stream A
# in place) and of K7's row list: each case repeated, since a look-back race
# shows up intermittently
# --------------------------------------------------------------------------- #
REPEATS = 50


def _snapshot(a):
    return [t.clone() for t in (a.bins, a.payload, a.rid)]


def _restore(a, snap):
    for t, v in zip((a.bins, a.payload, a.rid), snap):
        t.copy_(v)


def _assert_arenas_equal(ak, ap, what):
    assert torch.equal(ak.rid, ap.rid), what
    assert torch.equal(ak.bins, ap.bins), what
    assert torch.equal(ak.payload, ap.payload), what


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("where", ["in_place", "out_of_place",
                                   "overlap_before"])
def test_partition_segment_repeated_matches_plain(where, quantized, dev):
    """K3 in decision mode at segment counts 0, 1, T-1, T, T+1 and several
    tiles, at an unaligned nonzero start, with stream A over the segment
    (dst_a == start), disjoint past it, or overlapping it from before
    (dst_a < start); every count 50 times from the same arena, each equal
    to the plain version."""
    n = 40_000
    if quantized:
        (ak, ap), _ = _code_arenas(dev, n=n)
    else:
        ak, ap = _arenas(dev, n=n)
    T = pk.partition_tile(ak.num_groups, quantized)
    goleft = (torch.arange(256, device=dev) < 110).to(torch.uint8)
    snap = _snapshot(ak)
    start = 4096 + 37
    for cnt in (0, 1, T - 1, T, T + 1, 7 * T + 123):
        dst_a = {"in_place": start, "out_of_place": start + cnt + 3,
                 "overlap_before": start - 701}[where]
        dst_b = start + 2 * cnt + 4099
        sc0 = torch.tensor([start, cnt, dst_a, dst_b, 0, 0, 9, 1],
                           dtype=torch.int32, device=dev)
        _restore(ap, snap)
        sc_p = sc0.clone()
        pk.partition_segment_plain(ap, sc_p, goleft)
        for rep in range(REPEATS):
            _restore(ak, snap)
            sc = sc0.clone()
            pk.partition_segment(ak, sc, goleft)
            torch.cuda.synchronize()
            assert torch.equal(sc, sc_p), (cnt, rep)
            _assert_arenas_equal(ak, ap, (cnt, rep))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G", [120, 300])
def test_partition_segment_wide_matches_plain(G, quantized, dev):
    """K3's other tile shapes: at G=120 a ring of two 512-row tiles, at
    G=300 one 512-row tile a block (no ring); in place and out of place,
    several tiles at an unaligned start, each 10 times."""
    n = 20_000
    assert pk.partition_tile(G, quantized) == pk.PART_TILE_SMALL
    if quantized:
        (ak, ap), _ = _code_arenas(dev, n=n, F=G)
    else:
        ak, ap = _arenas(dev, n=n, F=G)
    goleft = (torch.arange(256, device=dev) < 130).to(torch.uint8)
    snap = _snapshot(ak)
    start, cnt = 1000 + 9, 9 * pk.PART_TILE_SMALL + 77
    for dst_a in (start, start + cnt + 1):
        sc0 = torch.tensor([start, cnt, dst_a, 2 * start + 2 * cnt + 64, 0, 0,
                            G - 1, 0], dtype=torch.int32, device=dev)
        _restore(ap, snap)
        sc_p = sc0.clone()
        pk.partition_segment_plain(ap, sc_p, goleft)
        for rep in range(10):
            _restore(ak, snap)
            sc = sc0.clone()
            pk.partition_segment(ak, sc, goleft)
            torch.cuda.synchronize()
            assert torch.equal(sc, sc_p), (dst_a, rep)
            _assert_arenas_equal(ak, ap, (dst_a, rep))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("G", [28, 80])
def test_partition_pred_hist_in_place_matches_plain(quantized, G, dev):
    """K3's pred mode with the bag's histogram, stream A over the segment
    itself, 50 times: at G=80 the features past the shared-memory chunk
    are summed from the staged tile, which the in-place stores overwrite
    in the arena."""
    n = 60_000
    if quantized:
        (ak, ap), _ = _code_arenas(dev, n=n, F=G)
    else:
        ak, ap = _arenas(dev, n=n, F=G)
    rng = np.random.RandomState(13)
    start = 1000 + 5
    cnt = n - start
    pred = torch.from_numpy((rng.rand(n) < 0.8).astype(np.uint8)).to(dev)
    dst_b = pk.pristine_work0(n) + 3
    sc0 = torch.tensor([start, cnt, start, dst_b, 0, 0, 0, 0],
                       dtype=torch.int32, device=dev)
    snap = _snapshot(ak)
    _restore(ap, snap)
    sc_p = sc0.clone()
    want = pk.partition_segment_pred_plain(ap, sc_p, pred, 0, 255)
    n_a = int(sc_p[pk.SC_CNT_A])
    if not quantized:
        rows = ap.payload[:, start:start + n_a].clone()
        ap.payload[0, start:start + n_a] = rows[0].abs()
        scale = pk.segment_histogram_plain(
            ap, torch.tensor([start, n_a], dtype=torch.int32, device=dev), 255)
        ap.payload[:, start:start + n_a] = rows
    for rep in range(REPEATS):
        _restore(ak, snap)
        sc = sc0.clone()
        got = pk.partition_segment_pred(ak, sc, pred, hist_stream=0,
                                        max_bin=255)
        torch.cuda.synchronize()
        assert torch.equal(sc, sc_p), rep
        _assert_arenas_equal(ak, ap, rep)
        if quantized:
            assert torch.equal(got, want), rep
        else:
            assert torch.equal(got[..., 2], want[..., 2]), rep
            assert bool(((got - want).abs() <= 1e-5 * scale).all()), rep


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B", [16, 255])
@pytest.mark.parametrize("F", [3, 11, 28])
def test_leaf_histogram_row_list_cases(F, B, quantized, dev):
    """K7's select and accumulate passes: an empty leaf, leaf -2 (the
    grower's `done` leaf), every row in the leaf and a leaf of some rows,
    with F=3 and F=11 (byte loads) and F=28 (4-byte loads), the ids at an
    unaligned address and n not a multiple of 16, one row-list workspace
    reused by every call, each 50 times."""
    from lightgbm_tpu_torch.ops import histogram_kernel as hk
    n = 100_003
    bins, g, h, ids = _leaf_inputs(dev, n + 1, F, B, F * B, quantized)
    bins, g, h = bins[1:], g[1:], h[1:]
    ids = ids[1:]                        # 4 or 1 bytes past an alignment
    fn = hk.leaf_histogram_quantized if quantized else hk.leaf_histogram
    plain = (hk.leaf_histogram_quantized_plain if quantized
             else hk.leaf_histogram_plain)
    rows = hk.row_list(n, dev)
    cases = ((ids, 9), (ids, -2), (torch.zeros_like(ids), 0), (ids, 5))
    for leaf_ids, leaf in cases:
        leaf_t = torch.tensor([leaf], dtype=torch.int32, device=dev)
        want = plain(bins, g, h, leaf_ids, leaf_t, B)
        m = int((leaf_ids.int() == leaf).sum())
        assert int(want[0, :, 2].sum()) == m
        scale = None if quantized else plain(bins, g.abs(), h, leaf_ids,
                                             leaf_t, B)
        for rep in range(REPEATS):
            got = fn(bins, g, h, leaf_ids, leaf_t, B, rows)
            torch.cuda.synchronize()
            assert int(rows[n]) == m, (leaf, rep)
            if quantized or m == 0:
                assert torch.equal(got, want.to(got.dtype)), (leaf, rep)
                continue
            assert torch.equal(got[..., 2], want[..., 2]), (leaf, rep)
            assert bool(((got - want).abs() <= 1e-5 * scale).all()), \
                (leaf, rep)


def _segment_arena(dev, n, F, quantized, skewed, seed=21):
    """One arena over n rows: uniform bins over 255, or skewed features of
    2-3 bins with at least 95% of the rows in one bin (every third feature
    uniform); f32 g/h or int8 codes."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, 255, (F, n)).astype(np.uint8)
    if skewed:
        for f in range(F):
            if f % 3 == 2:
                continue
            nb = 2 + f % 2
            rare = rng.rand(n) >= 0.96
            bins[f] = np.where(rare, rng.randint(1, nb, n), 0)
    a = pk.Arena(n, F, 4, dev, quantized=quantized)
    pk.init_pristine(a, torch.from_numpy(bins).to(dev))
    if quantized:
        a.payload[:, :n] = torch.from_numpy(np.stack([
            rng.randint(-127, 128, n), rng.randint(0, 128, n)]
        ).astype(np.int8)).to(dev)
    else:
        a.payload[0, :n] = torch.from_numpy(rng.randn(n).astype(np.float32)
                                            ).to(dev)
        a.payload[1, :n] = torch.from_numpy(
            (rng.rand(n) * 0.25 + 0.01).astype(np.float32)).to(dev)
    return a


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("skewed", [False, True])
def test_segment_histogram_repeated_matches_plain(skewed, quantized, dev):
    """K2's block schedule: the root, a 40k child at an unaligned start,
    cnt 0, cnt 1, a few rows across a chunk boundary, on uniform and on
    skewed bins, each 50 times; int8 exact, f32 counts exact and g/h within
    1e-5 of the bin's |value| sum."""
    n = 1_000_003
    a = _segment_arena(dev, n, 28, quantized, skewed)
    for start, cnt in ((0, n), (12_345, 40_000), (5, 0), (777, 1),
                       (31, 40), (n - 70, 70)):
        seg = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
        want = pk.segment_histogram_plain(a, seg, 255)
        assert int(want[0, :, 2].sum()) == cnt
        scale = None
        if not quantized:
            p = a.payload[0].clone()
            a.payload[0].abs_()
            scale = pk.segment_histogram_plain(a, seg, 255)
            a.payload[0] = p
        for rep in range(REPEATS):
            got = pk.segment_histogram(a, seg, 255)
            torch.cuda.synchronize()
            if quantized:
                assert torch.equal(got, want), (start, cnt, rep)
                continue
            assert torch.equal(got[..., 2], want[..., 2]), (start, cnt, rep)
            assert bool(((got - want).abs() <= 1e-5 * scale).all()), \
                (start, cnt, rep)


@pytest.mark.parametrize("G", [3, 33, 80])
def test_segment_histogram_feature_passes(G, dev):
    """G below one warp, past one warp (a second pass over the chunk) and
    past the shared-memory budget (two feature chunks), f32 and int8."""
    for quantized in (False, True):
        a = _segment_arena(dev, 100_000, G, quantized, False, seed=G)
        seg = torch.tensor([333, 60_001], dtype=torch.int32, device=dev)
        got = pk.segment_histogram(a, seg, 255)
        torch.cuda.synchronize()
        want = pk.segment_histogram_plain(a, seg, 255)
        assert torch.equal(got[..., 2], want[..., 2].to(got.dtype))
        if quantized:
            assert torch.equal(got, want)
        else:
            a.payload[0].abs_()
            scale = pk.segment_histogram_plain(a, seg, 255)
            assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("skewed", [False, True])
def test_segment_histogram_int8_small_rows_threshold(skewed, dev):
    """K2's int8 mode takes a row a thread up to 2^20 rows and the slabs
    above: both sides of the threshold, at an unaligned start, on uniform
    and on skewed bins, exact, 10 times each."""
    n = (1 << 20) + 1_000
    a = _segment_arena(dev, n, 28, True, skewed, seed=9)
    for cnt in (1 << 20, (1 << 20) + 1):
        seg = torch.tensor([n - cnt - 3, cnt], dtype=torch.int32, device=dev)
        want = pk.segment_histogram_plain(a, seg, 255)
        assert int(want[0, :, 2].sum()) == cnt
        for rep in range(10):
            got = pk.segment_histogram(a, seg, 255)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (cnt, rep)


def _scan_inputs(dev, CH, F, B, seed):
    rng = np.random.default_rng(seed)
    hist = torch.from_numpy(np.stack([
        _rand_hist(rng, F, B, 40 * B) for _ in range(CH)])).to(dev)
    nb = torch.from_numpy(rng.integers(min(3, B), B + 1, F)).to(dev)
    db = torch.from_numpy(rng.integers(0, min(3, B), F)).to(dev)
    mt = torch.from_numpy(rng.integers(0, 3, F)).to(dev)
    fvec = sk.build_feature_statics(nb, db, mt, children=CH)
    svec = sk.child_vector(hist[:, 0, :, 0].sum(1), hist[:, 0, :, 1].sum(1),
                           hist[:, 0, :, 2].sum(1))
    pvec = sk.params_vector(SplitParams(min_data_in_leaf=20), dev)
    return hist, fvec, svec, pvec


@pytest.mark.parametrize("CH", [1, 2])
@pytest.mark.parametrize("B", [2, 63, 255, 256, 300, 1024])
def test_split_scan_bins_and_tickets(B, CH, dev):
    """K1 at B up to 1024, one child and two: 50 launches back to back on
    inputs that differ (the select's tickets must be back at zero after
    each launch), each against split_scan_plain: feature, threshold and
    default_left equal, gains within 1e-5."""
    F = 28
    inputs = [_scan_inputs(dev, CH, F, B, 100 * B + 10 * CH + k)
              for k in range(REPEATS)]
    outs = [sk.split_scan(*x) for x in inputs]
    torch.cuda.synchronize()
    lanes = [sk._OF, sk._OT, sk._ODL]
    for rep, (x, (rows_k, best_k)) in enumerate(zip(inputs, outs)):
        rows_p, best_p = sk.split_scan_plain(*x)
        valid = rows_p[:, sk._OG] > sk.NEG_GATE
        assert torch.equal(rows_k[:, sk._OG] > sk.NEG_GATE, valid), rep
        assert torch.equal(rows_k[valid][:, lanes], rows_p[valid][:, lanes])
        assert torch.equal(best_k[:, lanes], best_p[:, lanes]), rep
        torch.testing.assert_close(rows_k[valid][:, sk._OG],
                                   rows_p[valid][:, sk._OG], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(best_k, best_p, rtol=1e-5, atol=1e-5)
    assert int(sk._tickets(dev, _cuda.stream(dev), CH).abs().sum()) == 0


def test_split_scan_two_streams(dev):
    """K1 launched 50 times on each of two streams, alternating, with no
    synchronisation between them: each stream selects with its own tickets,
    so every launch agrees with split_scan_plain as in one stream."""
    F, B, CH = 28, 255, 2
    inputs = [[_scan_inputs(dev, CH, F, B, 7_000 + 100 * s + k)
               for k in range(REPEATS)] for s in range(2)]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for k in range(REPEATS):
        for s, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[s].append(sk.split_scan(*inputs[s][k]))
    torch.cuda.synchronize()
    lanes = [sk._OF, sk._OT, sk._ODL]
    for s, st in enumerate(streams):
        for k, (x, (rows_k, best_k)) in enumerate(zip(inputs[s], outs[s])):
            rows_p, best_p = sk.split_scan_plain(*x)
            valid = rows_p[:, sk._OG] > sk.NEG_GATE
            assert torch.equal(rows_k[valid][:, lanes],
                               rows_p[valid][:, lanes]), (s, k)
            assert torch.equal(best_k[:, lanes], best_p[:, lanes]), (s, k)
            torch.testing.assert_close(best_k, best_p, rtol=1e-5, atol=1e-5)
        with torch.cuda.stream(st):
            tickets = sk._tickets(dev, _cuda.stream(dev), CH)
        assert int(tickets.abs().sum()) == 0
