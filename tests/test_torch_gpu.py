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
- K2 in int8 mode, K5 fused_refresh_histogram, K6 compact_carry and K3 with
  the code payload: exact (integer atomics are order-independent);
- a grown tree on dyadic gradients (every sum exact in f32): the same
  splits and leaf ids, leaf values rtol 1e-6;
- a quantized tree on a carried root, compacted by K6: the same splits,
  thresholds, leaf ids and carried row order, leaf values rtol 1e-6;
- quantization: the same f32 gradients give equal codes and scales on the
  card and the CPU; from each device's own binary-logloss gradients the
  gradients agree to 1e-6, at most one code in a thousand differs, and one
  integer histogram dequantized and summed over a feature's bins agrees to
  1e-5 of its |value| sum (`-s` prints what was found).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops import split_kernel as sk
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
