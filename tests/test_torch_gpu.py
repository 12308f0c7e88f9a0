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
- K3 partition_segment: exact;
- K4 scatter_segments, set mode (f32 and int32) and add mode: bit for bit
  on a random cut of 300k rows (250 live of 255 segments) and at 10.5M
  rows on 255 even leaves, a skewed tree and a real carried tree's
  segments;
- K3 in pred mode with the hist_stream histogram (the bagged root): counts
  and planes exact; the histogram exact for codes, for f32 as K2's; at
  G=28 and at G=80, whose [G, 255, 3] histogram exceeds one block's shared
  memory (the kernel then walks its rows once more per feature chunk);
- the binned tree walk, KP2 walk_binned: equal leaves on the card and
  the CPU, and in its add and masked-add modes equal f32 scores (bit for
  bit); a one-leaf tree puts every row in leaf 0;
- K7's wider forms (uint16 bins at B 292 and 1023, an f64 payload, both):
  counts equal, sums within 1e-5 (f32) or 1e-12 (f64) of each bin's sum
  of |values|; KP2 over uint16 bins and bin sets wider than 256 bits,
  f32 and f64 scores: bit for bit;
- the general grower (CEGB on both engines, forced splits on both,
  pooled quantized, f64 on the label engine, uint16 categorical bins):
  three 31-leaf rounds at 20k rows on the card and the CPU from the
  CPU's gradients rounded to 1/64, the same trees (split features,
  thresholds, every row's leaf; leaf values rtol 1e-5);
- KP1 predict_ensemble, every mode of its row tiles and of its
  small-batch walk against its plain version on the card, bit for bit,
  on f64 rows and on f32 rows: the fixture models ref50 (binary), cat50
  (multi-word categorical bitsets) and mc50 as k = 3 and k = 5, on rows
  with NaNs, zeros, values below 1e-35, negative and out-of-range
  categories, at 1, 7, 255, 257, 1000 and 100,003 rows; sums of all trees
  and of a third, early stop (k = 1, 3 and 5: the margin 2|sum| or the
  top two class sums' gap) at freqs that do not line up with a group,
  leaf indices, rows written at an offset, the launch counts of each
  path; a synthetic forest with a tree larger than a shared-memory stage
  (walked from global memory) at 28 and 100 features (the rows' features
  from the shared tile and through L1); DeviceEnsemble in small chunks
  against the host walk, f64 and f32 staging, and its device bytes
  against the estimate;
- serving: 8 threads x 200 predicts of 1-256 rows on one booster, each
  bit for bit its rows' host walk (DeviceEnsemble's staging under its
  lock); the port's Server on the card, its warmup launching each bucket
  once, in-process and HTTP clients bit for bit the host walk, one KP1
  launch a device batch, no build, no host batch, no breaker failure;
- K2 in int8 mode, K5 fused_refresh_histogram, K6 compact_carry and K3 with
  the code payload: exact (integer atomics are order-independent);
- a grown tree on dyadic gradients (every sum exact in f32): the same
  splits and leaf ids, leaf values rtol 1e-6; the same for a bagged tree,
  f32 and quantized, with -1 at the out-of-bag rows;
- a quantized tree on a carried root, compacted by K6: the same splits,
  thresholds, leaf ids and carried row order, leaf values rtol 1e-6;
- the fused paths' score (carried and pristine, f32 and quantized, three
  rounds): after every tree's K4 add, bit for bit the score the replaced
  `score += delta * shrink` gives;
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
- the label engine past 2^24 rows (2^24 + 2^20 rows, 2 features, a bin
  of more than 2^24 rows): K7's root histogram against its plain version
  (counts equal below 2^24, the bin past it within one unit an add of
  K7's blocks, g/h as K2's), and a 7-leaf tree against the CPU's (the
  same splits, counts and leaf ids, leaf values rtol 1e-4);
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
  and 40, B = 63 and 255: exact;
- the rounds as CUDA graphs (ops/graphs.py), on each of the ten training
  paths (carried, pristine, bagged and valid-set, f32 and quantized; the
  label engine, unbagged and bagged), five rounds at 20k rows against the
  same booster run eagerly, with a new feature mask and quantization key
  every round: the score, each round's tree, the carried row order and
  the validation score bit for bit (f32 gradients rounded to dyadic
  values, so K2's and K7's f32 atomics add them exactly); two more
  rounds' launch counts equal the graphs' captured counts times their
  replays, and the eager twin's; RoundGraphs on a plain function: eager
  warm-up, capture, replays that read a rewritten input, launch counts,
  and a capture that reads a host value raising;
- the lambdarank widths: K2 f32 at G = 137 (a root of 300k rows and a 40k
  child) and K1 at F = 137, B = 255, tolerances as above; lambdarank
  gradients of one score on the card and the CPU within 1e-5 of each
  vector's largest magnitude; the L1 leaf refit exact unweighted and, for
  weights, within 4 f32 ulps of the total weight over the least weight
  times the residuals' step; lambdarank (fused), L1 (eager, a refit and a
  fetch a round) and Poisson (fused) through their round graphs against
  an eager twin, bit for bit on bounded dyadic gradients, with the
  kernels each path launches;
- multiclass (7 classes, 31 leaves, 18k rows): softmax f32 and quantized
  and one-vs-all f32 through their graphs (the gradients' and one a
  class) against an eager twin, bit for bit on bounded dyadic gradients
  (f32) over five rounds, the graphs' replays and the kernels launched;
  and three 7-class rounds on the card against the CPU, softmax and
  one-vs-all, each round's trees grown on both from the CPU's bounded
  dyadic gradients: the same splits and leaf of every row in each of the
  21 trees, leaf values rtol 1e-5, scores and raw predictions within
  5e-6 of their scale;
- categorical features and EFB bundles: KP2 over CPU-trained trees with
  categorical nodes, over EFB group columns and both, in every mode on
  the card against its plain version on the CPU, bit for bit; five rounds
  of the airline data (six categorical columns; carried f32 and
  quantized, a validation set, the label engine) and of Covertype's
  one-hot layout bundled by EFB (carried, the label engine) through
  their graphs against an eager twin, bit for bit on dyadic gradients,
  with no K1 launch on the categorical data.
- the boosting modes: GOSS's sample (the threshold of the top rows, the
  other rows by a stable sort of their uniform draw, the amplification)
  on the card against its CPU version on the same gradients and key, bit
  for bit, at 1M rows with ties at both boundaries, one class and three;
  GOSS (f32 and quantized, 2 warm-up rounds then sampled ones) through its
  graphs (the gradients' with the sample, the tree's) against an eager
  twin, bit for bit, K3's pred mode and KP2's masked add launched in the
  sampled rounds; DART's device prediction after every round, drops
  included, equal to the host walk of the rescaled trees, bit for bit.
- the public API: K4's add mode captured in a graph with its shrinkage a
  device scalar, replayed after the scalar is rewritten, bit for bit the
  plain add with the new value; custom gradients (objective=none, a
  numpy objective of the raw scores rounded to dyadic values) through the
  round graphs against an eager twin, f32 and quantized on the partition
  engine and f32 on the label engine, bit for bit; a learning-rate
  schedule on the carried arena: no graph captured beyond the
  unscheduled run's two, each round's rate in K4's score update (the
  score bit for bit its eager twin's), each drained tree shrunk by its
  own round's rate, and the model predicting the training score.
"""
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops import split_kernel as sk
from lightgbm_tpu_torch.ops.grow import predict_leaf_inner
from lightgbm_tpu_torch.ops.predict_kernel import walk_binned
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


def _scatter_layout(kind, dev):
    """(arena, seg, nl, rows) of one K4 layout, its rid plane holding a
    permutation of `rows` row ids at the live columns and garbage
    elsewhere: 'random' (300k rows cut at random into 250 live of 255
    segments from column 0), 'even' (255 equal leaves), 'skewed' (one leaf
    of half the rows, the rest geometric down to 20) and 'carried' (a real
    carried tree's leaf_seg, tools/carried_leaf_seg.json), the last three
    at 10.5M rows; even and skewed in a shuffled order at any column."""
    import json
    from pathlib import Path
    rng = np.random.RandomState(len(kind))
    if kind == "carried":
        path = Path(pk.__file__).resolve().parent.parent / "tools" / \
            "carried_leaf_seg.json"
        with open(path) as f:
            lay = json.load(f)
        seg = np.asarray(lay["seg"], np.int64)
        starts, counts, live, n = seg[:, 0], seg[:, 1], lay["nl"], lay["rows"]
    elif kind == "random":
        n, live = 300_000, 250
        cuts = np.sort(rng.choice(np.arange(1, n), live - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [n]])
        starts, counts = bounds[:-1], np.diff(bounds)
    else:
        n = 10_500_000
        counts = (_carry_layout(kind, n, rng) if kind == "skewed"
                  else np.full(255, n // 255))
        live = len(counts)
        starts = np.zeros(live, np.int64)
        pos = 0
        for leaf in rng.permutation(live):
            pos += int(rng.randint(0, 16))
            starts[leaf] = pos
            pos += int(counts[leaf])
    rows = int(counts[:live].sum())
    arena = pk.Arena(n, 1, 6, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    arena.rid.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, arena.rid.shape,
                                  generator=gen, dtype=torch.int32,
                                  device=dev))
    perm = torch.randperm(rows, generator=gen, device=dev).to(torch.int32)
    pos = 0
    for s0, c in zip(starts[:live].tolist(), counts[:live].tolist()):
        arena.rid[s0:s0 + c] = perm[pos:pos + c]
        pos += c
    L = 255
    seg = np.zeros((L, 2), np.int64)
    seg[:len(starts), 0], seg[:len(starts), 1] = starts, counts
    seg[live:] = (2 ** 30, 777)                 # dead segments: never read
    return (arena, torch.from_numpy(seg.astype(np.int32)).to(dev),
            torch.tensor([live], dtype=torch.int32, device=dev), rows)


@pytest.mark.parametrize("kind", ["random", "even", "skewed", "carried"])
@pytest.mark.parametrize("mode", ["set_f32", "set_i32", "add"])
def test_scatter_segments_matches_plain(mode, kind, dev):
    """K4 in set mode (f32 leaf values, int32 leaf ids) and in add mode
    (out + vals * s, two f32 roundings; zero, tiny and normal terms on
    normal and subnormal scores) against its plain version on the same
    inputs, bit for bit, the whole output compared (rows of no live segment
    keep their values)."""
    arena, seg, nl, rows = _scatter_layout(kind, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    L = seg.shape[0]
    if mode == "set_i32":
        vals = torch.arange(L, dtype=torch.int32, device=dev)
        out_k = torch.randint(-9, 9, (rows + 5,), generator=gen,
                              dtype=torch.int32, device=dev)
    else:
        # zeros, a term below the L2 reduction's range, and subnormal
        # scores: the add mode's exact cases
        vals = torch.randn(L, generator=gen, device=dev)
        vals[:3] = torch.tensor([0.0, -0.0, 1e-32], device=dev)
        out_k = torch.randn(rows + 5, generator=gen, device=dev) * 3
        out_k[::97] = torch.tensor(-2e-39, device=dev)
        out_k[::89] = torch.tensor(7e-42, device=dev)
    shrink = (torch.full((), 0.1, device=dev) if mode == "add" else None)
    out_p = out_k.clone()
    _cuda.reset_launch_counts()
    pk.scatter_segments(arena, seg, vals, nl, out_k, shrink=shrink)
    torch.cuda.synchronize()
    assert dict(_cuda.LAUNCHES) == {
        "scatter_segments_add" if shrink is not None
        else "scatter_segments": 1}
    pk.scatter_segments_plain(arena, seg, vals, nl, out_p, shrink=shrink)
    if mode == "add":
        out_k, out_p = out_k.view(torch.int32), out_p.view(torch.int32)
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
    missing type: KP2 on the card in each mode against its plain version
    on the CPU (predict_leaf_inner and the same f32 adds), bit for bit;
    and a one-leaf tree."""
    rng = np.random.RandomState(14)
    n, F, B = 200_003, 8, 64
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
    assert int(tree.num_leaves) == 63
    bins_rows = bins.t().contiguous()
    want = predict_leaf_inner(bins_rows, tree, nb, db)
    on_card = type(tree)(*(t.to(dev) for t in tree))
    args = (bins_rows.to(dev), on_card, nb.to(dev), db.to(dev))
    _cuda.reset_launch_counts()
    got = walk_binned(*args)
    assert torch.equal(got.cpu(), want)
    lv = torch.from_numpy(rng.randn(63).astype(np.float32))
    score = torch.from_numpy(rng.randn(n).astype(np.float32))
    ids = torch.from_numpy(np.where(rng.rand(n) < 0.8, rng.randint(0, 63, n),
                                    -1).astype(np.int32))
    for leaf_ids in (None, ids):
        s_cpu = score.clone()
        walk_binned(bins_rows, tree, nb, db, lv=lv, score=s_cpu,
                    leaf_ids=leaf_ids)
        s_dev = score.to(dev)
        walk_binned(*args, lv=lv.to(dev), score=s_dev,
                    leaf_ids=None if leaf_ids is None else leaf_ids.to(dev))
        assert torch.equal(s_dev.cpu().view(torch.int32),
                           s_cpu.view(torch.int32))
    assert dict(_cuda.LAUNCHES) == {"walk_binned": 1, "walk_binned_add": 1,
                                    "walk_binned_masked_add": 1}
    one = on_card._replace(num_leaves=torch.ones((), dtype=torch.int32,
                                                 device=dev))
    assert int(walk_binned(args[0], one, args[2], args[3]).abs().sum()) == 0


# --------------------------------------------------------------------------- #
# KP1 predict_ensemble
# --------------------------------------------------------------------------- #
_INTEROP = os.path.join(os.path.dirname(__file__), "fixtures", "interop")


def _fixture_trees(name):
    """A fixture model's trees parsed by the port's Tree.from_string."""
    from lightgbm_tpu_torch.models.tree import Tree
    with open(os.path.join(_INTEROP, name + ".txt")) as f:
        text = f.read()
    trees = []
    for blk in text.split("Tree=")[1:]:
        body = blk.split("\n\n")[0]
        body = body[body.index("\n") + 1:]
        if "end of trees" in body:
            body = body[:body.index("end of trees")]
        trees.append(Tree.from_string(body))
    return trees


def _fixture_rows(name, n, seed):
    """n rows drawn from a fixture's test set, with NaNs, exact zeros,
    "zero" values below 1e-35, negative and out-of-range categories."""
    test = np.loadtxt(os.path.join(_INTEROP, name))[:, 1:]
    rng = np.random.RandomState(seed)
    X = test[rng.randint(0, len(test), n)].copy()
    X[rng.rand(*X.shape) < 0.05] = np.nan
    X[rng.rand(*X.shape) < 0.05] = 0.0
    X[rng.rand(*X.shape) < 0.02] = 1e-36
    X[rng.rand(*X.shape) < 0.02] = -3.5
    X[rng.rand(*X.shape) < 0.01] = 1e6
    return X


PREDICT_CASES = {"binary": ("ref50", "binary.test", 1),
                 "categorical": ("cat50", "cat.test", 1),
                 "k3": ("mc50", "multiclass.test", 3),
                 "k5": ("mc50", "multiclass.test", 5)}


def _kp1_both_paths(tb, X, T, k, want, **kw):
    """KP1's row tiles and its small-batch walk on the card, each against
    want (the plain version on the card), bit for bit."""
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.ops.predict_kernel import predict_ensemble
    rows = X.shape[0]
    for small in (False, True):
        if kw.get("mode") == pr.MODE_LEAF:
            out = torch.full((rows, T), -5, dtype=torch.int32,
                             device=X.device)
        else:
            out = torch.full((k, rows), 7.0, dtype=torch.float64,
                             device=X.device)
        predict_ensemble(tb, X, T, k, out, small=small, **kw)
        assert torch.equal(out, want), (small, kw)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("rows", [1, 7, 255, 257, 1000, 100_003])
@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_ensemble_matches_plain(case, rows, dtype, dev):
    """KP1 on the card against its plain version on the same card, every
    mode, by row tiles and by the small-batch walk, bit for bit, on f64
    rows and on f32 rows (compared widened to f64): sums (all trees and a
    third of them, which ends inside a group), early stop (every 3 trees
    at margin 1, every 10 at margin 4, tested at the iteration boundaries
    of k trees; neither lines up with a group of 4 trees), leaf indices;
    and the wrapper's chunked entry (rows
    written at an offset) with the path the row count picks."""
    from lightgbm_tpu_torch.ops import predict as pr
    from lightgbm_tpu_torch.ops.predict_kernel import (predict_ensemble,
                                                       small_batch)
    model, data, k = PREDICT_CASES[case]
    trees = _fixture_trees(model)
    X = torch.from_numpy(_fixture_rows(data, rows, 5 + rows)).to(dev)
    if dtype == "f32":
        X = X.float()
    tb = pr.build_tables(trees, dev)
    T = len(trees)
    _cuda.reset_launch_counts()
    for t_used in (T, T // 3):
        _kp1_both_paths(tb, X, t_used, k,
                        pr.predict_ensemble_plain(tb, X, t_used, k))
    for freq, margin in ((3, 1.0), (10, 4.0)):
        want = pr.predict_ensemble_plain(
            tb, X, T, k, pr.MODE_SUM_EARLY_STOP, freq, margin)
        _kp1_both_paths(tb, X, T, k, want, mode=pr.MODE_SUM_EARLY_STOP,
                        freq=freq, margin=margin)
    _kp1_both_paths(tb, X, T, k,
                    pr.predict_ensemble_plain(tb, X, T, k, pr.MODE_LEAF),
                    mode=pr.MODE_LEAF)
    # rows 1.. of a larger output, as the chunked entry writes them
    big = torch.zeros((k, rows + 1), dtype=torch.float64, device=dev)
    predict_ensemble(tb, X, T, k, big, 1)
    assert torch.equal(big[:, 1:], pr.predict_ensemble_plain(tb, X, T, k))
    calls = 5
    small = small_batch(rows, T)
    assert dict(_cuda.LAUNCHES) == {
        "predict_ensemble": calls + (not small),
        "predict_ensemble_small": calls + small}


def _random_tree(rng, leaves, F):
    """A tree of `leaves` leaves grown as LightGBM grows one (a leaf splits
    into the next node id, keeping its id on the left), on random
    features below F with random thresholds, missing types and default
    sides."""
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(leaves)
    parent = np.full(leaves, -1)
    for node in range(leaves - 1):
        leaf = rng.randint(0, t.num_leaves)
        p = parent[leaf]
        if p >= 0:
            if t.left_child[p] == ~leaf:
                t.left_child[p] = node
            else:
                t.right_child[p] = node
        t.left_child[node], t.right_child[node] = ~leaf, ~t.num_leaves
        parent[leaf] = parent[t.num_leaves] = node
        t.split_feature[node] = rng.randint(0, F)
        t.threshold[node] = rng.choice([rng.randn(), 0.0, -1e-36])
        t.decision_type[node] = rng.randint(0, 3) << 2 | rng.randint(0, 2) << 1
        t.num_leaves += 1
    t.leaf_value = rng.randn(leaves) * 0.1
    return t


@pytest.mark.parametrize("F", [28, 300])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_predict_ensemble_large_tree_and_wide_rows(F, dtype, dev):
    """A synthetic forest whose one 2,000-leaf tree (3,999 items) is larger
    than a shared-memory stage, so KP1 walks it from global memory in the
    same loop, between groups staged in shared memory; at F = 300 the
    rows' features outgrow the shared tile (even the narrower tiles of
    20,000 rows over 132 SMs: 160 f64 or 192 f32 rows, 384 or 230 KB)
    and KP1 reads them through L1.
    Sums, early stop and leaves of both paths against the plain version,
    bit for bit, with f32 and f64 rows, and the groups as built."""
    from lightgbm_tpu_torch.ops import predict as pr
    rng = np.random.RandomState(F)
    sizes = [31] * 9 + [2000] + [255] * 11 + [7]
    trees = [_random_tree(rng, L, F) for L in sizes]
    tb = pr.build_tables(trees, dev)
    groups = tb.group_off.tolist()
    assert [9, 10] == groups[groups.index(9):groups.index(9) + 2]
    assert tb.stage_items <= pr._STAGE_ITEMS
    X = rng.randn(20_000, F)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    X[rng.rand(*X.shape) < 0.05] = 0.0
    Xd = torch.from_numpy(X).to(dev)
    if dtype == "f32":
        Xd = Xd.float()
    T = len(trees)
    for t_used in (T, 11, 5):
        _kp1_both_paths(tb, Xd, t_used, 1,
                        pr.predict_ensemble_plain(tb, Xd, t_used, 1))
    _kp1_both_paths(tb, Xd, T, 3, pr.predict_ensemble_plain(tb, Xd, T, 3))
    for k in (1, 3):
        want = pr.predict_ensemble_plain(tb, Xd, T, k,
                                         pr.MODE_SUM_EARLY_STOP, 3, 0.3)
        _kp1_both_paths(tb, Xd, T, k, want, mode=pr.MODE_SUM_EARLY_STOP,
                        freq=3, margin=0.3)
    _kp1_both_paths(tb, Xd, T, 1,
                    pr.predict_ensemble_plain(tb, Xd, T, 1, pr.MODE_LEAF),
                    mode=pr.MODE_LEAF)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_device_ensemble_chunks_match_the_host_walk(dtype, dev, monkeypatch):
    """DeviceEnsemble on the card with a small chunk (several chunks, each
    staged on its own), on f64 rows and on f32 rows (staged as f32): the
    sums equal the host walk of the same values as f64 bit for bit, the
    leaves the host leaves, and device_bytes the estimate."""
    from lightgbm_tpu_torch.ops import predict as pr
    monkeypatch.setattr(pr, "_CHUNK_BYTES", 8 * 4 * 1000 + 8)
    trees = _fixture_trees("cat50")
    X = _fixture_rows("cat.test", 9_001, 3).astype(dtype)
    ens = pr.DeviceEnsemble(trees, 1, device=dev)
    host = np.zeros(len(X))
    for t in trees:
        host += t.predict(X.astype(np.float64))
    np.testing.assert_array_equal(ens.predict_sum(X, len(trees))[0], host)
    step = pr._CHUNK_BYTES // (X.itemsize * X.shape[1])
    chunks = list(ens._chunks(X))
    assert [a for a, _ in chunks] == list(range(0, len(X), step))
    assert len(chunks) > 2
    assert {Xd.dtype for _, Xd in chunks} == {
        torch.float32 if dtype == np.float32 else torch.float64}
    leaf = ens.predict_leaf(X, len(trees))
    for i in (0, 17, len(trees) - 1):
        np.testing.assert_array_equal(
            leaf[:, i], trees[i].predict_leaf_index(X.astype(np.float64)))
    assert ens.device_bytes() == pr.estimate_device_bytes(trees, 1)
    np.testing.assert_array_equal(ens.predict_bucketed(X[:7], len(trees))[0],
                                  host[:7])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_scores_match_the_parent_formula(weighted, quantized, dev,
                                               monkeypatch):
    """Three rounds of the fused paths on the card (unweighted: the carried
    arena; weighted: the pristine root), 200k rows, 63 leaves: at every
    tree's K4 the live segments hold all n rows, and the score after K4's
    add mode equals the formula it replaces (a zeroed delta, K4 in set
    mode, `score += delta * torch.tensor(shrink)` on the card) bit for
    bit.  The check runs inside the rounds' CUDA graphs, so it reads no
    value on the host: each round adds its live rows and its verdict into
    one device tally."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import grow_partition as gp
    X, y = _higgs_like(200_000, seed=19)
    w = (np.random.RandomState(3).rand(len(y)).astype(np.float32) + 0.5
         if weighted else None)
    real = gp.scatter_segments
    tally = torch.zeros(2, dtype=torch.int64, device=dev)

    def check(arena, seg, vals, nl, out, shrink=None):
        delta = torch.zeros_like(out)
        real(arena, seg, vals, nl, delta)
        want = out + delta * torch.tensor(shrink, dtype=torch.float32)
        real(arena, seg, vals, nl, out, shrink=shrink)
        live = torch.arange(seg.shape[0], device=out.device) < nl
        tally.add_(torch.stack([
            (seg[:, 1].long() * live).sum(),
            (out.view(torch.int32) == want.view(torch.int32)).all().long()]))
    monkeypatch.setattr(gp, "scatter_segments", check)
    params = {"objective": "binary", "num_leaves": 63, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbose": -1,
              "tpu_quantized_grad": quantized}
    bst = lt.train(params, lt.Dataset(X, y, weight=w, device=dev),
                   num_boost_round=3, device=dev)
    assert bst._gbdt._quantized is quantized
    assert bool(bst._gbdt._carried_active) is not weighted
    assert bst.num_trees() == 3
    assert tally.tolist() == [3 * len(y), 3]


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


def test_label_engine_past_2_24_rows(dev):
    """The label engine past K1's 2^24-row limit, where the split scan
    keeps integer count cumsums (ops/grow.py KERNEL_SCAN_ROWS): 2^24 + 2^20
    rows, 2 features, max_bin 15, 7 leaves; feature 0 mostly one value, so
    one of its bins holds more than 2^24 rows, a count an f32 word rounds.
    K7's root histogram on the card against its plain version there
    (counts equal below 2^24; past it the plain version's count is the
    exact one rounded once to f32, K7's within one unit an add of its
    blocks' f32 atomics, as measured: 17290022 and 17290020 for 17290021
    rows on an H100; g/h as K2's tolerance), and the card's tree against the
    port's CPU run of the same data: split features, thresholds, default
    directions, leaf counts and every row's leaf equal, leaf values rtol
    1e-4 (the f32 sums are reassociated).  The gradients step by bin, so
    the gains of the chosen splits stand far apart."""
    from lightgbm_tpu_torch.ops import histogram_kernel as hk
    from lightgbm_tpu_torch.ops.grow import KERNEL_SCAN_ROWS, grow_tree_label
    n, F, B = (1 << 24) + (1 << 20), 2, 15
    assert n >= KERNEL_SCAN_ROWS
    rng = np.random.RandomState(24)
    b0 = np.where(rng.rand(n) < 0.97, 0, rng.randint(1, B, n))
    b1 = rng.randint(0, B, n)
    big = int((b0 == 0).sum())
    assert big > 1 << 24
    bins = torch.from_numpy(np.stack([b0, b1], 1).astype(np.uint8))
    step = rng.randn(2, B) * 2
    grad = torch.from_numpy((step[0, b0] + step[1, b1] + 0.1 * rng.randn(n))
                            .astype(np.float32))
    hess = torch.from_numpy((rng.rand(n) * 0.5 + 0.5).astype(np.float32))
    bins_d, grad_d, hess_d = bins.to(dev), grad.to(dev), hess.to(dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf0 = torch.zeros(1, dtype=torch.int32, device=dev)
    got = hk.leaf_histogram(bins_d, grad_d, hess_d, zeros, leaf0, B,
                            hk.row_list(n, dev))
    want = hk.leaf_histogram_plain(bins_d, grad_d, hess_d, zeros, leaf0, B)
    scale = hk.leaf_histogram_plain(bins_d, grad_d.abs(), hess_d, zeros,
                                    leaf0, B)
    del zeros
    faults = []
    cnt_k, cnt_p = got[..., 2].cpu(), want[..., 2].cpu()
    # an f32 count word holds no odd count past 2^24: the plain version
    # rounds the exact count once, K7's blocks add their exact counts with
    # f32 atomics, each add past 2^24 rounding (ROADMAP queue 3); every
    # other bin's count is exact on both
    exact = torch.from_numpy(np.stack([
        np.bincount(b0, minlength=B), np.bincount(b1, minlength=B)]))
    past = exact >= 1 << 24
    assert int(past.sum()) == 1 and bool(past[0, 0])
    if not torch.equal(cnt_k[~past], cnt_p[~past]):
        faults.append("K7 root counts below 2^24 differ")
    if float(cnt_p[0, 0]) != float(np.float32(big)):
        faults.append("plain count %r, exact %d" % (float(cnt_p[0, 0]), big))
    if abs(float(cnt_k[0, 0]) - big) > hk.LEAF_HIST_BLOCKS:
        faults.append("K7 count %r, exact %d" % (float(cnt_k[0, 0]), big))
    rel = float(((got - want).abs()[..., :2] / scale[..., :2].clamp_min(
        1e-30)).max())
    if rel > 1e-5:
        faults.append("K7 root g/h: error %.3g of the |value| sums" % rel)
    out = []
    for d in (dev, torch.device("cpu")):
        nb = torch.full((F,), B, dtype=torch.int32, device=d)
        z = torch.zeros(F, dtype=torch.int32, device=d)
        tree, ids = grow_tree_label(
            bins.to(d), grad.to(d), hess.to(d),
            torch.zeros(n, dtype=torch.int32, device=d),
            torch.ones(F, dtype=torch.bool, device=d), nb, z, z,
            SplitParams(min_data_in_leaf=20), max_leaves=7, max_bin=B,
            hist_impl="pallas")
        out.append((tree, ids.cpu()))
    (tk, ik), (tp, ip) = out
    nl = int(tp.num_leaves)
    if int(tk.num_leaves) != nl:
        faults.append("leaves: card %d, CPU %d" % (int(tk.num_leaves), nl))
    for name in ("split_feature", "threshold_bin", "default_left",
                 "leaf_count"):
        a, b = getattr(tk, name).cpu(), getattr(tp, name)
        if not torch.equal(a, b):
            faults.append("%s: card %s, CPU %s" % (name, a.tolist(),
                                                   b.tolist()))
    if not torch.equal(ik, ip):
        faults.append("%d rows in other leaves" % int((ik != ip).sum()))
    lv_k, lv_p = tk.leaf_value.cpu()[:nl], tp.leaf_value[:nl]
    if not torch.allclose(lv_k, lv_p, rtol=1e-4, atol=0.0):
        faults.append("leaf values: card %s, CPU %s" % (lv_k.tolist(),
                                                        lv_p.tolist()))
    assert nl == 7
    assert not faults, "; ".join(faults)


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


# --------------------------------------------------------------------------- #
# the rounds as CUDA graphs (ops/graphs.py) against the same rounds eagerly
# --------------------------------------------------------------------------- #
GRAPH_PATHS = {
    "carried_f32": {}, "carried_quantized": dict(quantized=True),
    "pristine_f32": dict(weighted=True),
    "pristine_quantized": dict(weighted=True, quantized=True),
    "bagged_f32": dict(bagged=True),
    "bagged_quantized": dict(bagged=True, quantized=True),
    "valid_f32": dict(valid=True), "valid_quantized": dict(valid=True,
                                                           quantized=True),
    "label_f32": dict(label=True),
    "label_bagged_f32": dict(label=True, bagged=True),
}


class _EagerRounds:
    """A booster's graphs replaced by plain calls: the eager twin."""

    def run(self, key, warm_key, fn):
        return fn()


def _dyadic_gradients(g):
    """The booster's f32 gradients rounded to multiples of 1/64 and its
    hessians to multiples of 1/64 in [1/64, 1]: every histogram sum of
    20k rows is then exact in f32, whatever order the atomics add in."""
    real = g.objective.get_gradients

    def get(score):
        grad, hess = real(score)
        return (torch.round(grad * 64) / 64,
                torch.clamp(torch.round(hess * 64), min=1) / 64)
    g.objective.get_gradients = get


def _graph_boosters(dev, flags):
    import lightgbm_tpu_torch as lt
    X, y = _higgs_like(20_000, seed=23)
    Xv, yv = _higgs_like(5_000, seed=24)
    w = (np.random.RandomState(3).rand(len(y)).astype(np.float32) + 0.5
         if flags.get("weighted") else None)
    params = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
              "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1,
              "feature_fraction": 0.8,
              "tpu_quantized_grad": bool(flags.get("quantized"))}
    if flags.get("bagged"):
        params.update(bagging_fraction=0.8, bagging_freq=1)
    if flags.get("valid"):
        params["metric"] = "auc"
    if flags.get("label"):
        params.update(tpu_tree_engine="label", tpu_histogram_impl="pallas")
    out = []
    for _ in range(2):
        ds = lt.Dataset(X, y, weight=w, device=dev)
        bst = lt.Booster(params, ds, device=dev)
        if flags.get("valid"):
            bst.add_valid(lt.Dataset(Xv, yv, reference=ds, device=dev), "v")
        if not flags.get("quantized"):
            _dyadic_gradients(bst._gbdt)
        out.append(bst)
    out[1]._gbdt._graphs = _EagerRounds()
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graph_rounds_match_eager(path, dev):
    """Five rounds of a 31-leaf booster at 20k rows through its CUDA graphs
    (round 1 eagerly, then a capture for each key, then replays) against
    its twin run eagerly, with a new feature mask (feature_fraction 0.8)
    and, quantized, a new key every round.  After every round, bit for
    bit: the training score, the round's packed tree (the deferred
    rounds' pinned copy: fused, bagged and label-engine runs; the
    valid-set runs' host tree), the carried row order and each validation
    score; f32 gradients dyadic, quantized ones as the objective gives
    them.  The trees of consecutive rounds differ, so no
    replay returned a stale tree.  Then two more rounds each: the launch
    counts of the graph booster equal its graphs' captured counts times
    their replays, and the eager twin's launch counts."""
    flags = GRAPH_PATHS[path]
    a, b = _graph_boosters(dev, flags)
    ga, gb = a._gbdt, b._gbdt
    deferred = not flags.get("valid")
    trees = []
    for r in range(5):
        a.update()
        b.update()
        torch.cuda.synchronize()
        assert torch.equal(_bits(ga.score), _bits(gb.score)), r
        if deferred:
            ea, eb = ga._inflight[-1], gb._inflight[-1]
            ea["event"].synchronize()
            eb["event"].synchronize()
            assert torch.equal(ea["host"], eb["host"]), r
            trees.append(ea["host"].clone())
        else:
            ta, tb = ga.models[-1].to_string(), gb.models[-1].to_string()
            assert ta == tb, r
            trees.append(ta)
        if ga._carried_active:
            s = ga._carry_slots[ga._carry_parity]
            assert ga._carry_parity == gb._carry_parity
            rid = ga.arena.rid[s:s + ga.num_data]
            assert torch.equal(rid, gb.arena.rid[s:s + gb.num_data]), r
        for (_, va, _m), (_, vb, _n) in zip(ga.valid_states,
                                            gb.valid_states):
            assert torch.equal(_bits(va.score), _bits(vb.score)), r
    for t0, t1 in zip(trees, trees[1:]):
        assert not (torch.equal(t0, t1) if deferred else t0 == t1)
    stats = ga._graphs.stats()
    assert len(stats) == (2 if ga._carried_active else 1)
    assert sum(x["replays"] for x in stats) == 4
    assert all(x["nodes"] > x["launches"] > 0 for x in stats)
    before = {k: g.replays for k, g in ga._graphs.graphs.items()}
    counts = []
    for bst in (a, b):
        _cuda.reset_launch_counts()
        for _ in range(2):
            bst.update()
        torch.cuda.synchronize()
        counts.append(dict(_cuda.LAUNCHES))
    want = {}
    for k, g in ga._graphs.graphs.items():
        for name, c in g.launches.items():
            want[name] = want.get(name, 0) + c * (g.replays - before[k])
    if flags.get("valid"):
        # after each fetch: the training score by K4's add mode, the
        # validation score by KP2's add mode
        want["scatter_segments_add"] = want.get("scatter_segments_add",
                                                0) + 2
        want["walk_binned_add"] = 2
    else:
        assert ga._tree_fetches == 0
    if flags.get("bagged"):
        assert want["walk_binned_masked_add"] == 2
    assert counts[0] == counts[1] == want
    assert a.model_to_string() == b.model_to_string()
    assert a.num_trees() == 7


def test_round_graphs_capture_replay_and_fault(dev):
    """RoundGraphs on a plain function over a static input: the first call
    for a warm-up key runs eagerly, the next captures and replays, later
    calls replay and see the input rewritten in between; K1's launches
    count once a replay; a function that reads a host value cannot be
    captured and the call raises."""
    from lightgbm_tpu_torch.ops.graphs import RoundGraphs
    x = torch.zeros(1000, device=dev)
    hist, fvec, svec, pvec = _scan_inputs(dev, 1, 28, 63, 5)
    graphs = RoundGraphs(dev)

    def fn():
        return (x * 2 + 1, sk.split_scan(hist, fvec, svec, pvec)[1])
    _cuda.reset_launch_counts()
    outs = []
    for k in range(4):
        x.fill_(float(k))
        y, best = graphs.run("k", "w", fn)
        outs.append((float(y[0]), best.clone()))
    assert [o[0] for o in outs] == [1.0, 3.0, 5.0, 7.0]
    want = sk.split_scan_plain(hist, fvec, svec, pvec)[1]
    for _, best in outs:
        torch.testing.assert_close(best, want, rtol=1e-5, atol=1e-5)
    (g,) = graphs.graphs.values()
    assert g.replays == 3 and g.nodes >= 2 and g.seconds > 0
    assert dict(g.launches) == {"split_scan": 1}
    assert dict(_cuda.LAUNCHES) == {"split_scan": 4}

    def reads_host():
        return (x + float(x.sum()),)
    graphs.run("bad", "w2", reads_host)             # eager: allowed
    with pytest.raises(RuntimeError):
        graphs.run("bad", "w2", reads_host)
    assert "bad" not in graphs.graphs
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 6000.0


# --------------------------------------------------------------------------- #
# lambdarank at MSLR width and the pointwise objectives on the card
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("start,cnt", [(0, 300_000), (12_345, 40_000)])
def test_segment_histogram_mslr_width(start, cnt, dev):
    """K2 f32 at G = 137 (five slabs, the last one partial, over several
    feature chunks at B = 255): counts equal, g/h within 1e-5 of each
    bin's |value| sum."""
    a = _segment_arena(dev, 300_000, 137, False, False, seed=137)
    seg = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
    got = pk.segment_histogram(a, seg, 255)
    torch.cuda.synchronize()
    want = pk.segment_histogram_plain(a, seg, 255)
    assert torch.equal(got[..., 2], want[..., 2])
    a.payload[0].abs_()
    scale = pk.segment_histogram_plain(a, seg, 255)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("CH", [1, 2])
def test_split_scan_mslr_width(CH, dev):
    """K1 at F = 137, B = 255: feature, threshold and default_left equal,
    gains and the selected rows rtol 1e-5."""
    hist, fvec, svec, pvec = _scan_inputs(dev, CH, 137, 255, 137 + CH)
    rows_k, best_k = sk.split_scan(hist, fvec, svec, pvec)
    torch.cuda.synchronize()
    rows_p, best_p = sk.split_scan_plain(hist, fvec, svec, pvec)
    lanes = [sk._OF, sk._OT, sk._ODL]
    valid = rows_p[:, sk._OG] > sk.NEG_GATE
    assert torch.equal(rows_k[valid][:, lanes], rows_p[valid][:, lanes])
    assert torch.equal(best_k[:, lanes], best_p[:, lanes])
    torch.testing.assert_close(best_k, best_p, rtol=1e-5, atol=1e-5)


def _rank_case(sizes, seed=11, F=8):
    """Queries of the given sizes graded 0-4 by a noisy linear utility
    (chip_smoke.py's MSLR-shaped generator on fewer features)."""
    rng = np.random.RandomState(seed)
    sizes = np.asarray(sizes)
    n = int(sizes.sum())
    X = rng.randn(n, F).astype(np.float32)
    util = X[:, :4] @ rng.randn(4) + 0.3 * rng.randn(n)
    y = np.zeros(n, np.float32)
    start = 0
    for sz in sizes:
        order = np.argsort(-util[start:start + sz])
        for lo, hi, grade in ((0, 2, 4), (2, 6, 3), (6, 15, 2), (15, 40, 1)):
            y[start + order[lo * sz // 120:hi * sz // 120]] = grade
        start += sz
    return X, y, sizes


@pytest.mark.parametrize("weighted", [False, True])
def test_lambdarank_gradients_card_vs_cpu(weighted, dev):
    """The lambdarank gradients of one score on the card and on the CPU:
    queries of 1 to 128 documents (buckets of 8 to 128 slots) and 300 of
    120, tied scores and zeros of both signs: within 1e-5 of each vector's
    largest magnitude (f32 pair sums reduced in each device's order, one
    ulp of exp())."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    X, y, g = _rank_case([1, 3, 8, 9, 17, 33, 70, 128] * 4 + [120] * 300)
    meta = Metadata(len(y))
    meta.set_label(y)
    if weighted:
        meta.set_weights(np.random.RandomState(2).rand(len(y)) + 0.5)
    meta.set_query(g)
    score = np.round(np.random.RandomState(3).randn(len(y)) * 2) / 2
    score[::11] = -0.0
    score = torch.from_numpy(score.astype(np.float32))
    out = []
    for d in (dev, torch.device("cpu")):
        obj = create_objective("lambdarank", Config({}))
        obj.init(meta, len(y), d)
        out.append([t.cpu() for t in obj.get_gradients(score.to(d))])
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_renew_leaf_percentiles_card_vs_cpu(dev):
    """The leaf refit of L1/quantile on the card and the CPU: plain
    (exact: sorts and gathers) and weighted (the CDF's f32 cumulative sum
    in each device's order: within 4 ulps of the total weight over the
    least row weight, times the residuals' 0.1 step)."""
    from lightgbm_tpu_torch.ops.quantile import renew_leaf_percentiles
    rng = np.random.RandomState(9)
    n, L = 200_000, 255
    res = torch.from_numpy(np.round(rng.randn(n) * 3, 1).astype(np.float32))
    lids = torch.from_numpy(rng.randint(-1, L - 3, n).astype(np.int32))
    w = torch.from_numpy((rng.rand(n) + 0.2).astype(np.float32))
    for alpha in (0.5, 0.9):
        got = renew_leaf_percentiles(res.to(dev), lids.to(dev), alpha, L)
        want = renew_leaf_percentiles(res, lids, alpha, L)
        assert torch.equal(got.cpu(), want)
        got = renew_leaf_percentiles(res.to(dev), lids.to(dev), alpha, L,
                                     w.to(dev))
        want = renew_leaf_percentiles(res, lids, alpha, L, w)
        atol = 4 * 1.2e-7 * float(w.sum()) / float(w.min()) * 0.1
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


def _dyadic_bounded(g):
    """The booster's f32 gradients rounded to multiples of 1/256 in
    [-2, 2] and its hessians to multiples of 1/256 in [1/256, 2]: every
    histogram sum of 18k rows (below 2^15.2, in steps of 2^-8) is then
    exact in f32, whatever order the atomics add in."""
    real = g.objective.get_gradients

    def get(score):
        grad, hess = real(score)
        return (torch.clamp(torch.round(grad * 256), -512, 512) / 256,
                torch.clamp(torch.round(hess * 256), 1, 512) / 256)
    g.objective.get_gradients = get


@pytest.mark.parametrize("objective", ["lambdarank", "regression_l1",
                                       "poisson"])
def test_objective_graph_rounds_match_eager(objective, dev):
    """Five rounds of a 31-leaf booster through its CUDA graphs against
    its twin run eagerly, dyadic gradients (`_dyadic_bounded`): lambdarank on
    the fused pristine path (300 queries of 60 documents), L1 on the
    eager path with a refit and a fetch a round, Poisson fused: the
    score and every tree bit for bit, one graph replayed every round
    after the first; lambdarank and Poisson launch K2, K3, K1 and K4's add
    mode and no other training kernel, L1 K4's set mode for its leaf ids."""
    import lightgbm_tpu_torch as lt
    if objective == "lambdarank":
        X, y, g = _rank_case([60] * 300, F=12)
    else:
        X, y = _higgs_like(18_000, seed=25)
        g = None
        if objective == "poisson":
            y = np.random.RandomState(4).poisson(1.0 + y).astype(np.float32)
    params = {"objective": objective, "num_leaves": 31, "learning_rate": 0.1,
              "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1}
    boosters = []
    for _ in range(2):
        bst = lt.Booster(params, lt.Dataset(X, y, group=g, device=dev),
                         device=dev)
        _dyadic_bounded(bst._gbdt)
        boosters.append(bst)
    a, b = boosters
    b._gbdt._graphs = _EagerRounds()
    _cuda.reset_launch_counts()
    for r in range(5):
        a.update()
        b.update()
        torch.cuda.synchronize()
        assert torch.equal(_bits(a._gbdt.score), _bits(b._gbdt.score)), r
    assert a.model_to_string() == b.model_to_string()
    stats = a._gbdt._graphs.stats()
    assert len(stats) == 1 and stats[0]["replays"] == 4
    renew = objective == "regression_l1"
    assert a._gbdt._tree_fetches == (5 if renew else 0)
    counts = dict(_cuda.LAUNCHES)
    k4 = "scatter_segments" if renew else "scatter_segments_add"
    for name in ("segment_histogram", "partition_segment", "split_scan", k4):
        assert counts.get(name, 0) > 0, name
    others = set(counts) - {"segment_histogram", "partition_segment",
                            "split_scan", k4}
    assert not others, others


def _covertype_like(n, seed, k=7, F=54):
    """chip_smoke.py's Covertype-shaped generator, cut to n rows: labels a
    shuffled vector of the 7 classes' scaled counts, each row a normal
    draw shifted by its class's mean vector."""
    counts = np.array([211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                       20_510], np.float64) * n / 581_012
    c = np.floor(counts).astype(np.int64)
    c[np.argsort(-(counts - c))[:n - int(c.sum())]] += 1
    rng = np.random.RandomState(seed)
    means = rng.randn(k, F) * np.where(np.arange(F) < 12, 0.6, 0.15)
    y = np.repeat(np.arange(k), c)
    rng.shuffle(y)
    return (rng.randn(n, F) + means[y]).astype(np.float32), \
        y.astype(np.float32)


MC_PARAMS = {"num_class": 7, "num_leaves": 31, "learning_rate": 0.1,
             "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1}


@pytest.mark.parametrize("objective,quantized", [
    ("multiclass", False), ("multiclass", True), ("multiclassova", False)])
def test_multiclass_graph_rounds_match_eager(objective, quantized, dev):
    """Five rounds of a 7-class, 31-leaf booster at 18k rows through its
    graphs (the gradients' graph and one a class; class 0's and the
    gradients' first calls eager, the other classes capturing in round 1)
    against its twin run eagerly: the [7, n] score and every tree bit for
    bit (f32: bounded dyadic gradients); the replays; K2, K3, K1 and K4's
    add mode launched (quantized: their int8 modes and K5), no other
    training kernel, K6 and K7 among them."""
    import lightgbm_tpu_torch as lt
    X, y = _covertype_like(18_000, seed=5)
    params = dict(MC_PARAMS, objective=objective,
                  tpu_quantized_grad=quantized)
    boosters = []
    for _ in range(2):
        bst = lt.Booster(params, lt.Dataset(X, y, device=dev), device=dev)
        if not quantized:
            _dyadic_bounded(bst._gbdt)
        boosters.append(bst)
    a, b = boosters
    b._gbdt._graphs = _EagerRounds()
    _cuda.reset_launch_counts()
    for r in range(5):
        a.update()
        b.update()
        torch.cuda.synchronize()
        assert torch.equal(_bits(a._gbdt.score), _bits(b._gbdt.score)), r
    assert a.model_to_string() == b.model_to_string()
    g = a._gbdt
    assert g.num_tree_per_iteration == 7 and g._carried_active is False
    stats = g._graphs.stats()
    assert len(stats) == 8
    assert sum(x["replays"] for x in stats) == (7 * 5 - 1) + (5 - 1)
    assert g._tree_fetches == 0
    sfx = "_i8" if quantized else ""
    must = {"segment_histogram" + sfx, "partition_segment" + sfx,
            "split_scan", "scatter_segments_add"}
    if quantized:
        must.add("fused_root_histogram")
    counts = dict(_cuda.LAUNCHES)
    assert must <= set(counts) and not set(counts) - must, counts


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_round_card_vs_cpu(objective, dev):
    """Three 7-class rounds of a 31-leaf booster at 18k rows on the card
    (its rounds run eagerly) and on the CPU, every round's trees grown on
    both from the same gradients: the CPU booster's of its own score,
    rounded to bounded dyadic values, so that every histogram sum is exact
    on both whatever order the card's atomics add in (each device's own
    gradients round exp() differently, and a near tie of two gains can
    then take another feature).  Every tree with the same split features,
    thresholds and leaf of every row, leaf values rtol 1e-5 (K1's leaf
    output against the plain version's), the [7, n] scores and raw
    predictions within 5e-6 of their scale."""
    import lightgbm_tpu_torch as lt
    X, y = _covertype_like(18_000, seed=9)
    params = dict(MC_PARAMS, objective=objective)
    a = lt.Booster(params, lt.Dataset(X, y, device=dev), device=dev)
    b = lt.Booster(params, lt.Dataset(X, y, device="cpu"), device="cpu")
    _dyadic_bounded(b._gbdt)
    cpu_get = b._gbdt.objective.get_gradients
    last = []

    def cpu_gradients(score):
        out = cpu_get(score)
        last[:] = out
        return out

    b._gbdt.objective.get_gradients = cpu_gradients
    a._gbdt.objective.get_gradients = lambda score: tuple(
        t.to(dev) for t in last)
    a._gbdt._graphs = _EagerRounds()
    for _ in range(3):
        b.update()
        a.update()
    assert a.num_trees() == b.num_trees() == 21      # drained
    ta, tb = a._gbdt.models, b._gbdt.models
    for s, t in zip(ta, tb):
        n = s.num_leaves - 1
        assert s.num_leaves == t.num_leaves > 1
        np.testing.assert_array_equal(s.split_feature[:n], t.split_feature[:n])
        np.testing.assert_array_equal(s.threshold_in_bin[:n],
                                      t.threshold_in_bin[:n])
        np.testing.assert_array_equal(s.predict_leaf_index(X),
                                      t.predict_leaf_index(X))
        np.testing.assert_allclose(s.leaf_value[:n + 1], t.leaf_value[:n + 1],
                                   rtol=1e-5, atol=1e-9)
    want = b._gbdt.score.numpy()
    scale = 5e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(a._gbdt.score.cpu().numpy(), want, rtol=0,
                               atol=scale)
    np.testing.assert_allclose(a.predict(X, raw_score=True),
                               b.predict(X, raw_score=True), rtol=0,
                               atol=scale)


# --------------------------------------------------------------------------- #
# categorical features and EFB bundles
# --------------------------------------------------------------------------- #
def _airline_like(n, seed, airports=60):
    """Rows of the airline layout (six category columns as codes, DepTime,
    Distance) and a label from per-category effects."""
    rng = np.random.RandomState(seed)
    cards = {0: 12, 1: 31, 2: 7, 4: 22, 5: airports, 6: airports}
    X = np.zeros((n, 8), np.float32)
    score = np.zeros(n)
    for j, c in cards.items():
        codes = rng.randint(0, c, n)
        X[:, j] = codes
        score += np.random.RandomState(100 + j).randn(c)[codes]
    X[:, 3] = rng.randint(0, 2400, n)
    X[:, 7] = np.round(rng.gamma(2.0, 400.0, n))
    score += (X[:, 3] > 1700) * 0.7 + rng.randn(n)
    return X, (score > 0.5).astype(np.float32)


AIRLINE_CATS = [0, 1, 2, 4, 5, 6]


def _onehot_like(n, seed, k=1):
    """Covertype's layout: 10 numbers, then 4 and 40 one-hot columns (the
    row's area and soil type); k classes (k = 1: a binary label)."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = rng.randn(n, 10)
    area, soil = rng.randint(0, 4, n), rng.randint(0, 40, n)
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    s = X[:, 0] + np.random.RandomState(7).randn(40)[soil] + 0.3 * area \
        + 0.5 * rng.randn(n)
    if k == 1:
        return X, (s > 0.5).astype(np.float32)
    return X, np.clip(np.floor(s + 2), 0, k - 1).astype(np.float32)


def _mixed_like(n, seed):
    """The airline columns followed by 12 one-hot columns: categorical
    features beside an EFB bundle."""
    X, y = _airline_like(n, seed)
    rng = np.random.RandomState(seed + 1)
    oh = np.zeros((n, 12), np.float32)
    pick = rng.randint(0, 12, n)
    oh[np.arange(n), pick] = 1.0
    y = np.where(pick % 3 == 0, 1.0 - y, y).astype(np.float32)
    return np.column_stack([X, oh]), y


@pytest.mark.parametrize("kind", ["categorical", "bundled", "both"])
def test_walk_binned_categories_and_bundles_card_vs_cpu(kind, dev):
    """KP2 over trees with categorical nodes (their bin sets as 256-bit
    sets), over EFB group columns (decoded through the bundle maps) and
    both: three 31-leaf trees trained on the CPU, each in the device form
    the validation sets walk (gbdt._tree_to_device), walked on the card in
    every mode against the plain version on the CPU, bit for bit, and the
    plain walk's leaves the host walk's of the raw rows."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.gbdt import _tree_to_device, bundle_maps
    n = 120_001
    if kind == "categorical":
        X, y = _airline_like(n, 31)
        kw = dict(categorical_feature=AIRLINE_CATS)
    elif kind == "bundled":
        X, y = _onehot_like(n, 32)
        kw = {}
    else:
        X, y = _mixed_like(n, 33)
        kw = dict(categorical_feature=AIRLINE_CATS)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "learning_rate": 0.2}
    bst = lt.train(params, lt.Dataset(X, y, device="cpu", **kw), 3,
                   device="cpu")
    g = bst._gbdt
    ds = g.train_set
    assert (g.is_categorical is not None) is (kind != "bundled")
    assert (ds.bundle is not None) is (kind != "categorical")
    bins = ds.device_bins("cpu")
    maps = bundle_maps(ds, "cpu")
    maps_dev = bundle_maps(ds, dev)
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(np.where(rng.rand(n) < 0.7,
                                    rng.randint(0, 31, n), -1)
                           .astype(np.int32))
    cats = 0
    for tree in g.models:
        t_cpu = _tree_to_device(tree, "cpu", g.max_bin)
        t_dev = _tree_to_device(tree, dev, g.max_bin)
        cats += int(t_cpu.is_cat.sum())
        want = walk_binned(bins, t_cpu, g.num_bins, g.default_bins,
                           bundle=maps)
        np.testing.assert_array_equal(want.numpy(),
                                      tree.predict_leaf_index(X))
        args = (bins.to(dev), t_dev, g.num_bins.to(dev),
                g.default_bins.to(dev))
        got = walk_binned(*args, bundle=maps_dev)
        assert torch.equal(got.cpu(), want)
        lv = torch.from_numpy(rng.randn(tree.num_leaves).astype(np.float32))
        score = torch.from_numpy(rng.randn(n).astype(np.float32))
        for leaf_ids in (None, ids.clamp_max(tree.num_leaves - 1)):
            s_cpu = score.clone()
            walk_binned(bins, t_cpu, g.num_bins, g.default_bins, lv=lv,
                        score=s_cpu, leaf_ids=leaf_ids, bundle=maps)
            s_dev = score.to(dev)
            walk_binned(*args, lv=lv.to(dev), score=s_dev,
                        leaf_ids=None if leaf_ids is None
                        else leaf_ids.to(dev), bundle=maps_dev)
            assert torch.equal(s_dev.cpu().view(torch.int32),
                               s_cpu.view(torch.int32))
    assert (cats > 0) is (kind != "bundled")


# name -> (data, extra params)
CAT_GRAPH_PATHS = {
    "categorical_carried": ("airline", {}),
    "categorical_quantized": ("airline", {"tpu_quantized_grad": True}),
    "categorical_valid": ("airline", {"metric": "auc"}),
    "categorical_label": ("airline", {"tpu_tree_engine": "label",
                                      "tpu_histogram_impl": "pallas"}),
    "efb_carried": ("onehot", {}),
    "efb_label": ("onehot", {"tpu_tree_engine": "label",
                             "tpu_histogram_impl": "pallas"}),
}


@pytest.mark.parametrize("path", sorted(CAT_GRAPH_PATHS))
def test_categorical_and_bundled_graph_rounds_match_eager(path, dev):
    """Five rounds of a 31-leaf booster at 20k rows, the airline data with
    six categorical columns or Covertype's one-hot layout bundled by EFB,
    through its CUDA graphs against its twin run eagerly (f32 gradients
    dyadic): the training score, each round's tree (the deferred rounds'
    pinned copy, the valid-set run's host tree) and the validation score
    bit for bit; the trees hold categorical splits on the airline data
    and split on bundled features on the one-hot data; K1 never runs on
    the categorical data."""
    import lightgbm_tpu_torch as lt
    data, extra = CAT_GRAPH_PATHS[path]
    if data == "airline":
        X, y = _airline_like(20_000, 41)
        Xv, yv = _airline_like(5_000, 42)
        kw = dict(categorical_feature=AIRLINE_CATS)
    else:
        X, y = _onehot_like(20_000, 43)
        Xv, yv = _onehot_like(5_000, 44)
        kw = {}
    params = dict({"objective": "binary", "num_leaves": 31,
                   "learning_rate": 0.1, "min_data_in_leaf": 20,
                   "verbose": -1}, **extra)
    valid = "metric" in extra
    boosters = []
    for _ in range(2):
        ds = lt.Dataset(X, y, device=dev, **kw)
        bst = lt.Booster(params, ds, device=dev)
        if valid:
            bst.add_valid(lt.Dataset(Xv, yv, reference=ds, device=dev), "v")
        if not extra.get("tpu_quantized_grad"):
            _dyadic_gradients(bst._gbdt)
        boosters.append(bst)
    a, b = boosters
    b._gbdt._graphs = _EagerRounds()
    ga, gb = a._gbdt, b._gbdt
    _cuda.reset_launch_counts()
    for r in range(5):
        a.update()
        b.update()
        torch.cuda.synchronize()
        assert torch.equal(_bits(ga.score), _bits(gb.score)), r
        if valid:
            assert ga.models[-1].to_string() == gb.models[-1].to_string(), r
        else:
            ea, eb = ga._inflight[-1], gb._inflight[-1]
            ea["event"].synchronize()
            eb["event"].synchronize()
            assert torch.equal(ea["host"], eb["host"]), r
        for (_, va, _m), (_, vb, _n) in zip(ga.valid_states,
                                            gb.valid_states):
            assert torch.equal(_bits(va.score), _bits(vb.score)), r
    counts = dict(_cuda.LAUNCHES)
    assert a.model_to_string() == b.model_to_string()
    assert sum(x["replays"] for x in ga._graphs.stats()) == 4
    if data == "airline":
        assert ga.is_categorical is not None
        assert sum(t.num_cat for t in ga.models) > 0
        assert counts.get("split_scan", 0) == 0, counts
    else:
        assert ga.bundle is not None and counts.get("split_scan", 0) > 0
        grouped = [f for grp in ga.train_set.bundle.groups if len(grp) > 1
                   for f in grp]
        assert any(int(f) in grouped for t in ga.models
                   for f in t.split_feature_inner[:t.num_leaves - 1])


# --------------------------------------------------------------------------- #
# the boosting modes: GOSS's sample, its graphs, DART's rescaled trees
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 3])
def test_goss_sample_card_vs_cpu(k, dev):
    """The sample of 1M rows on the card against the CPU on the same
    gradients and key (the card's key an int64 [2] device tensor, as the
    round graph reads it): the predicate, gradients and hessians bit for
    bit.  A block of rows repeats another's gradients, so the score ties
    at the top_k boundary too."""
    from lightgbm_tpu_torch.models.goss import goss_sample
    from lightgbm_tpu_torch.ops import threefry
    rng = np.random.RandomState(31 + k)
    n = 1_000_000
    top_k, other_k = n // 5, n // 10
    g = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    h = torch.from_numpy((rng.rand(k, n) + 0.1).astype(np.float32))
    g[:, :n // 4] = g[:, n // 4:n // 2]
    h[:, :n // 4] = h[:, n // 4:n // 2]
    key = threefry.split(threefry.PRNGKey(3))[1]
    want = goss_sample(g, h, key, (n - top_k) / other_k, top_k, other_k)
    got = goss_sample(g.to(dev), h.to(dev),
                      torch.tensor(key, dtype=torch.int64, device=dev),
                      (n - top_k) / other_k, top_k, other_k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(want[2].sum()) >= top_k + other_k


@pytest.mark.parametrize("quantized", [False, True])
def test_goss_graph_rounds_match_eager(quantized, dev):
    """Five GOSS rounds at learning_rate 0.5 (two of every row, then three
    sampled) of a 31-leaf booster at 20k rows through its graphs against
    an eager twin: the training score, the in-sample predicate and each
    round's packed tree (pinned copy) bit for bit (f32 gradients dyadic);
    the sampled rounds launch K3's pred mode and KP2's masked add."""
    import lightgbm_tpu_torch as lt
    X, y = _higgs_like(20_000, seed=25)
    params = {"objective": "binary", "boosting": "goss", "num_leaves": 31,
              "learning_rate": 0.5, "max_bin": 63, "min_data_in_leaf": 20,
              "verbose": -1, "feature_fraction": 0.8,
              "tpu_quantized_grad": quantized}
    boosters = []
    for _ in range(2):
        bst = lt.Booster(params, lt.Dataset(X, y, device=dev), device=dev)
        if not quantized:
            _dyadic_gradients(bst._gbdt)
        boosters.append(bst)
    a, b = boosters
    b._gbdt._graphs = _EagerRounds()
    ga, gb = a._gbdt, b._gbdt
    for r in range(5):
        _cuda.reset_launch_counts()
        a.update()
        b.update()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        assert torch.equal(_bits(ga.score), _bits(gb.score)), r
        assert (ga._bag_pred is None) == (gb._bag_pred is None) == (r < 2)
        if r >= 2:
            assert torch.equal(ga._bag_pred, gb._bag_pred), r
            assert int(ga._bag_pred.sum()) >= 20_000 * 3 // 10
            sfx = "_i8" if quantized else ""
            assert counts["partition_segment_pred" + sfx] == 2, counts
            assert counts["walk_binned_masked_add"] == 2, counts
        ea, eb = ga._inflight[-1], gb._inflight[-1]
        ea["event"].synchronize()
        eb["event"].synchronize()
        assert torch.equal(ea["host"], eb["host"]), r
    stats = ga._graphs.stats()
    # gradients and tree, warm-up and sampled: four keys, each warmed or
    # captured at its first call
    assert len(stats) == 4
    assert a.model_to_string() == b.model_to_string()


def test_dart_device_prediction_follows_dropped_trees(dev):
    """DART rescales old trees in place every round it drops some: after
    every round KP1's prediction (its tables cached on the model's length
    and generation) equals the host walk of the trees, bit for bit; a
    drop bumps the generation."""
    import lightgbm_tpu_torch as lt
    X, y = _higgs_like(20_000, seed=26)
    params = {"objective": "binary", "boosting": "dart", "num_leaves": 31,
              "learning_rate": 0.3, "max_bin": 63, "verbose": -1,
              "drop_rate": 0.5, "skip_drop": 0.0}
    bst = lt.Booster(params, lt.Dataset(X, y, device=dev), device=dev)
    g = bst._gbdt
    dropped = 0
    for r in range(6):
        gen = g._model_gen
        bst.update()
        assert g._model_gen == gen + bool(g._drop_index)
        dropped += len(g._drop_index)
        raw = bst.predict(X[:5000], raw_score=True)
        host = bst.predict(X[:5000], raw_score=True, device=False)
        np.testing.assert_array_equal(raw, host)
    assert dropped >= 3
    np.testing.assert_allclose(g.score[:5000].cpu().numpy(), raw, rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------- #
# the general grower: K7 and KP2 widened, CEGB, forced splits, pooling, f64,
# uint16 bins
# --------------------------------------------------------------------------- #
WIDE_FORMS = {"u16": (True, np.float32, 292), "u16_1023": (True, np.float32,
                                                          1023),
              "f64": (False, np.float64, 255), "u16_f64": (True, np.float64,
                                                           292)}


@pytest.mark.parametrize("form", sorted(WIDE_FORMS))
def test_leaf_histogram_wide_forms_match_plain(form, dev):
    """K7 on uint16 bins (B 292 and 1023) and with an f64 payload, at the
    root and on one leaf of eight: counts equal, sums within 1e-5 of each
    bin's sum of |values| in f32 and 1e-12 in f64 (shared atomics add in
    a varying order; the plain version sums in f64)."""
    from lightgbm_tpu_torch.ops import histogram_kernel as hk
    wide, dtype, B = WIDE_FORMS[form]
    rng = np.random.RandomState(B)
    n, F = 300_000, 8
    b = rng.randint(0, B, (n, F))
    bins = torch.from_numpy(b.astype(np.uint16).view(np.int16) if wide
                            else b.astype(np.uint8)).to(dev)
    g = torch.from_numpy(rng.randn(n).astype(dtype)).to(dev)
    h = torch.from_numpy((rng.rand(n) + 0.05).astype(dtype)).to(dev)
    ids = torch.from_numpy(rng.randint(-1, 7, n).astype(np.int32)).to(dev)
    name = "leaf_histogram" + ("_u16" if wide else "") + (
        "_f64" if dtype == np.float64 else "")
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for leaf_ids, leaf in ((torch.zeros_like(ids), 0), (ids, 5)):
        leaf_t = torch.tensor([leaf], dtype=torch.int32, device=dev)
        _cuda.reset_launch_counts()
        got = hk.leaf_histogram(bins, g, h, leaf_ids, leaf_t, B)
        torch.cuda.synchronize()
        assert dict(_cuda.LAUNCHES) == {name: 1}
        want = hk.leaf_histogram_plain(bins, g, h, leaf_ids, leaf_t, B)
        assert got.dtype == want.dtype == getattr(torch, np.dtype(dtype).name)
        assert torch.equal(got[..., 2], want[..., 2])
        assert int(want[..., 2].sum()) == F * int((leaf_ids == leaf).sum())
        scale = hk.leaf_histogram_plain(bins, g.abs(), h, leaf_ids, leaf_t, B)
        assert bool(((got - want).abs() <= tol * scale).all())


@pytest.mark.parametrize("score_dtype", ["f32", "f64"])
def test_walk_binned_wide_card_vs_cpu(score_dtype, dev):
    """KP2 over uint16 bins and bin sets wider than 256 bits (the airline
    layout with 300 airports: Origin and Dest have more than 256 bins),
    two 31-leaf label-engine trees trained on the CPU, walked on the card
    in every mode against the plain version on the CPU, f32 or f64
    scores, bit for bit."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.gbdt import _tree_to_device
    n = 120_001
    X, y = _airline_like(n, 41, airports=300)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "learning_rate": 0.2, "tpu_tree_engine": "label",
              "min_data_per_group": 20, "cat_smooth": 5.0}
    bst = lt.train(params, lt.Dataset(X, y, device="cpu",
                                      categorical_feature=AIRLINE_CATS), 2,
                   device="cpu")
    g = bst._gbdt
    bins = g.train_set.device_bins("cpu")
    assert bins.dtype == torch.int16 and g.max_bin > 256
    dtype = torch.float64 if score_dtype == "f64" else torch.float32
    sfx = "_u16" + ("_f64" if score_dtype == "f64" else "")
    rng = np.random.RandomState(6)
    ids = torch.from_numpy(np.where(rng.rand(n) < 0.7,
                                    rng.randint(0, 31, n), -1)
                           .astype(np.int32))
    cats = 0
    for tree in g.models:
        t_cpu = _tree_to_device(tree, "cpu", g.max_bin)
        t_dev = _tree_to_device(tree, dev, g.max_bin)
        cats += int(t_cpu.is_cat.sum())
        want = walk_binned(bins, t_cpu, g.num_bins, g.default_bins)
        np.testing.assert_array_equal(want.numpy(),
                                      tree.predict_leaf_index(X))
        args = (bins.to(dev), t_dev, g.num_bins.to(dev),
                g.default_bins.to(dev))
        _cuda.reset_launch_counts()
        got = walk_binned(*args)
        assert torch.equal(got.cpu(), want)
        lv = torch.from_numpy(rng.randn(tree.num_leaves)).to(dtype)
        score = torch.from_numpy(rng.randn(n)).to(dtype)
        for leaf_ids in (None, ids.clamp_max(tree.num_leaves - 1)):
            s_cpu = score.clone()
            walk_binned(bins, t_cpu, g.num_bins, g.default_bins, lv=lv,
                        score=s_cpu, leaf_ids=leaf_ids)
            s_dev = score.to(dev)
            walk_binned(*args, lv=lv.to(dev), score=s_dev,
                        leaf_ids=None if leaf_ids is None
                        else leaf_ids.to(dev))
            assert torch.equal(s_dev.cpu(), s_cpu)
        assert dict(_cuda.LAUNCHES) == {"walk_binned_u16": 1,
                                        "walk_binned_add" + sfx: 1,
                                        "walk_binned_masked_add" + sfx: 1}
    assert cats > 0


def _card_and_cpu(dev, X, y, params, rounds=3, **ds_kw):
    """`rounds` rounds of one booster on the card (its rounds eager) and
    one on the CPU, both from the CPU booster's gradients rounded to
    multiples of 1/64 (`_dyadic_gradients`): every histogram sum is then
    exact on both devices, whatever order the card's atomics add in.
    Returns both boosters, drained, and the card's launch counts."""
    import lightgbm_tpu_torch as lt
    a = lt.Booster(params, lt.Dataset(X, y, device=dev, **ds_kw), device=dev)
    b = lt.Booster(params, lt.Dataset(X, y, device="cpu", **ds_kw),
                   device="cpu")
    _dyadic_gradients(b._gbdt)
    cpu_get = b._gbdt.objective.get_gradients
    last = []

    def cpu_gradients(score):
        out = cpu_get(score)
        last[:] = out
        return out

    b._gbdt.objective.get_gradients = cpu_gradients
    a._gbdt.objective.get_gradients = lambda score: tuple(
        t.to(dev) for t in last)
    a._gbdt._graphs = _EagerRounds()
    _cuda.reset_launch_counts()
    for _ in range(rounds):
        b.update()
        a.update()
    assert a.num_trees() == b.num_trees() == rounds
    counts = dict(_cuda.LAUNCHES)
    for s, t in zip(a._gbdt.models, b._gbdt.models):
        n = s.num_leaves - 1
        assert s.num_leaves == t.num_leaves > 1
        np.testing.assert_array_equal(s.split_feature[:n], t.split_feature[:n])
        np.testing.assert_array_equal(s.threshold_in_bin[:n],
                                      t.threshold_in_bin[:n])
        np.testing.assert_array_equal(s.predict_leaf_index(X),
                                      t.predict_leaf_index(X))
        np.testing.assert_allclose(s.leaf_value[:n + 1], t.leaf_value[:n + 1],
                                   rtol=1e-5, atol=1e-9)
    return a, b, counts


GENERAL_CASES = {
    "cegb_carried": dict(cegb_tradeoff=1.0, cegb_penalty_split=1e-6,
                         cegb_penalty_feature_coupled=[0.0, 2.0] * 14),
    "cegb_label": dict(tpu_tree_engine="label", cegb_tradeoff=1.0,
                       cegb_penalty_feature_coupled=[0.0, 2.0] * 14),
    "forced_partition": dict(forced=True),
    "forced_label": dict(forced=True, tpu_tree_engine="label"),
    "pooled_quantized": dict(tpu_quantized_grad=True,
                             histogram_pool_size=28 * 63 * 12 * 8
                             / (1 << 20)),
    "f64_label": dict(tpu_double_precision=True),
}


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_general_grower_card_vs_cpu(case, dev, tmp_path):
    """Each option of the general grower, 20k Higgs-like rows, 31 leaves,
    3 rounds on the card and on the CPU from the same dyadic gradients:
    the same trees (split features, thresholds, every row's leaf; leaf
    values rtol 1e-5), and the card's rounds launched the kernels of their
    path: K1 and K3 on the partition engine (K2 on a pooled recompute),
    K7 on the label engine (its f64 form with tpu_double_precision)."""
    import json
    extra = dict(GENERAL_CASES[case])
    X, y = _higgs_like(20_000, seed=27)
    params = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
              "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1}
    if extra.pop("forced", False):
        fs = tmp_path / "forced.json"
        fs.write_text(json.dumps({"feature": 5, "threshold": 0.0,
                                  "left": {"feature": 7, "threshold": 0.5},
                                  "right": {"feature": 9,
                                            "threshold": -0.5}}))
        extra["forcedsplits_filename"] = str(fs)
    params.update(extra)
    a, b, counts = _card_and_cpu(dev, X, y, params)
    ga = a._gbdt
    label = not ga._use_partition_engine
    assert label is (params.get("tpu_tree_engine") == "label"
                     or case == "f64_label")
    if label:
        k7 = "leaf_histogram" + ("_f64" if case == "f64_label" else "")
        assert counts.get(k7, 0) > 0, counts
    else:
        assert counts.get("partition_segment", 0) + counts.get(
            "partition_segment_i8", 0) > 0, counts
    if case.startswith("cegb"):
        np.testing.assert_array_equal(ga._cegb_used.cpu().numpy(),
                                      b._gbdt._cegb_used.numpy())
    if case.startswith("forced"):
        for t in ga.models:
            assert t.split_feature[0] == 5
            assert t.split_feature[t.left_child[0]] == 7
            assert t.split_feature[t.right_child[0]] == 9
    if case == "pooled_quantized":
        assert 4 <= ga._hist_slots < 31 and ga._quantized
        assert counts["segment_histogram_i8"] > 3 * 30, counts
    if case == "f64_label":
        assert ga.score.dtype == torch.float64
        want = b._gbdt.score.numpy()
        np.testing.assert_allclose(ga.score.cpu().numpy(), want, rtol=0,
                                   atol=1e-12 * float(np.abs(want).max()))


def test_uint16_label_engine_card_vs_cpu(dev):
    """The airline layout with 300 airports (uint16 bins, bin sets wider
    than 256) on the label engine, card against CPU from the same dyadic
    gradients: the same trees; K7's uint16 form launched."""
    X, y = _airline_like(20_000, 43, airports=300)
    params = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.2,
              "verbose": -1, "tpu_tree_engine": "label",
              "min_data_per_group": 20, "cat_smooth": 5.0}
    a, b, counts = _card_and_cpu(dev, X, y, params,
                                 categorical_feature=AIRLINE_CATS)
    assert a._gbdt.train_set.device_bins(dev).dtype == torch.int16
    assert counts.get("leaf_histogram_u16", 0) > 0, counts
    assert sum(t.num_cat for t in a._gbdt.models) > 0


# --------------------------------------------------------------------------- #
# the public API: K4's device shrinkage, custom gradients, schedules
# --------------------------------------------------------------------------- #
def test_scatter_segments_add_reads_shrink_at_replay(dev):
    """K4's add mode with its shrinkage a one-value device tensor, in a
    captured graph: each replay reads the value written before it, bit for
    bit the plain add with that value (and the launch counted a
    replay)."""
    from lightgbm_tpu_torch.ops.graphs import RoundGraphs
    arena, seg, nl, rows = _scatter_layout("skewed", dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    vals = torch.randn(seg.shape[0], generator=gen, device=dev)
    out = torch.randn(rows + 5, generator=gen, device=dev)
    s = torch.zeros((), dtype=torch.float32, device=dev)
    graphs = RoundGraphs(dev)

    def fn():
        pk.scatter_segments(arena, seg, vals, nl, out, shrink=s)
        return (out,)
    want = out.clone()
    _cuda.reset_launch_counts()
    for rate in (0.1, 0.05, 0.3, 1.0 / 3.0):
        s.fill_(rate)
        graphs.run("k4", "k4", fn)
        pk.scatter_segments_plain(arena, seg, vals, nl, want,
                                  shrink=torch.full((), rate, device=dev))
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert graphs.stats()[0]["replays"] == 3
    assert dict(_cuda.LAUNCHES) == {"scatter_segments_add": 4}


def _dyadic_fobj(preds, ds):
    """Binary logloss of the raw scores, gradients rounded to 1/64 and
    hessians to [1/64, 1] in steps of 1/64 (every histogram sum exact)."""
    y = ds.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return (np.round((p - y) * 64) / 64,
            np.maximum(np.round(p * (1.0 - p) * 64), 1) / 64)


API_GRAPH_PATHS = {
    "f32": {},
    "quantized": {"tpu_quantized_grad": True},
    "label_f32": {"tpu_tree_engine": "label", "tpu_histogram_impl": "pallas"},
}


@pytest.mark.parametrize("path", sorted(API_GRAPH_PATHS))
def test_custom_gradient_graph_rounds_match_eager(path, dev):
    """Five rounds of objective=none on custom gradients (staged from the
    host into the held buffers) through the round graphs against an eager
    twin: the score and each round's packed tree bit for bit, the trees
    deferred (no fetch), one graph replayed at every round after the
    first, and no boost-from-average."""
    import lightgbm_tpu_torch as lt
    X, y = _higgs_like(20_000, seed=23)
    params = dict({"objective": "none", "num_leaves": 31,
                   "learning_rate": 0.1, "max_bin": 63,
                   "min_data_in_leaf": 20, "verbose": -1,
                   "feature_fraction": 0.8}, **API_GRAPH_PATHS[path])
    a, b = (lt.Booster(params, lt.Dataset(X, y, device=dev), device=dev)
            for _ in range(2))
    b._gbdt._graphs = _EagerRounds()
    ga, gb = a._gbdt, b._gbdt
    assert ga.objective is None and ga._held
    for r in range(5):
        a.update(fobj=_dyadic_fobj)
        b.update(fobj=_dyadic_fobj)
        torch.cuda.synchronize()
        assert torch.equal(_bits(ga.score), _bits(gb.score)), r
        ea, eb = ga._inflight[-1], gb._inflight[-1]
        ea["event"].synchronize()
        eb["event"].synchronize()
        assert torch.equal(ea["host"], eb["host"]), r
    stats = ga._graphs.stats()
    assert len(stats) == 1 and stats[0]["replays"] == 4
    assert ga._tree_fetches == 0 and not ga._carried_active
    assert a.model_to_string() == b.model_to_string()
    np.testing.assert_allclose(a.predict(X, raw_score=True),
                               ga.score.cpu().numpy(), rtol=0, atol=1e-5)


def test_schedule_rate_reaches_k4_at_replay(dev):
    """A learning-rate schedule on the carried arena through
    Booster.reset_parameter before each round, against an eager twin on
    dyadic gradients: the score after every round bit for bit the twin's
    (K4 read each round's rate from the device scalar), the two carried
    graphs of the unscheduled run and no more, every round past the first
    replayed, the drained trees shrunk by their own rounds' rates, and
    the model's prediction equal to the training score."""
    import lightgbm_tpu_torch as lt
    X, y = _higgs_like(20_000, seed=23)
    params = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
              "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1}
    rates = [0.1, 0.1, 0.05, 0.3, 0.2, 0.05]
    a, b = (lt.Booster(params, lt.Dataset(X, y, device=dev), device=dev)
            for _ in range(2))
    for bst in (a, b):
        _dyadic_gradients(bst._gbdt)
    b._gbdt._graphs = _EagerRounds()
    ga, gb = a._gbdt, b._gbdt
    for r, rate in enumerate(rates):
        for bst in (a, b):
            bst.reset_parameter({"learning_rate": rate})
            bst.update()
        torch.cuda.synchronize()
        assert torch.equal(_bits(ga.score), _bits(gb.score)), r
    assert ga._carried_active and ga._tree_fetches == 0
    stats = ga._graphs.stats()
    assert len(stats) == 2 and sum(x["replays"] for x in stats) == 5
    assert a.num_trees() == len(rates)
    # the first tree's bias (boost from average) resets its shrinkage to 1
    assert [t.shrinkage for t in ga.models] == pytest.approx(
        [1.0] + rates[1:], rel=1e-12)
    assert a.model_to_string() == b.model_to_string()
    np.testing.assert_allclose(a.predict(X, raw_score=True),
                               ga.score.cpu().numpy(), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# serving on the card: concurrent callers of one ensemble, the server
# --------------------------------------------------------------------------- #
def _ref50_booster(dev):
    import lightgbm_tpu_torch as lt
    with open(os.path.join(_INTEROP, "ref50.txt")) as f:
        return lt.Booster(model_str=f.read(), device=dev)


def test_concurrent_callers_of_one_booster_get_their_own_rows(dev):
    """8 threads x 200 predicts of 1-256 rows each on one booster, each
    call its own rows (f64, or f32, which the staging keeps f32), the
    interpreter switching threads every 10 us: every result equals the
    host walk of its rows bit for bit.  The booster's DeviceEnsemble
    stages each call's X in pinned memory of its own.  It used to stage
    X through two pinned buffers shared by every caller, with no lock, so
    two callers could fill one buffer and a call got another call's rows
    back.  So, and without the build's lock, on an H100: one run failed
    in all 8 threads at once (their first launches built the kernels
    into the same files), another in 19 calls (wrong rows, or a buffer
    another thread had just reallocated, which ended 7 of the 8
    threads)."""
    import sys
    import threading
    bst = _ref50_booster(dev)
    pool = _fixture_rows("binary.test", 4096, 29)
    pool32 = pool.astype(np.float32)
    host = bst.predict(pool, raw_score=True, device=False)
    host32 = bst.predict(pool32.astype(np.float64), raw_score=True,
                         device=False)
    rng = np.random.RandomState(31)
    jobs = [[(rng.randint(0, len(pool), rng.randint(1, 257)),
              rng.rand() < 0.25) for _ in range(200)] for _ in range(8)]
    bad, done = [], []

    def caller(mine):
        try:
            for idx, f32 in mine:
                got = bst.predict(pool32[idx] if f32 else pool[idx],
                                  raw_score=True)
                if not np.array_equal(got, (host32 if f32 else host)[idx]):
                    bad.append(len(idx))
            done.append(len(mine))
        except Exception as exc:   # noqa: BLE001 — fail the test, not the thread
            bad.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sum(done) == 1600 and not bad, (len(bad), bad[:10])
    assert bst._gbdt._dev_ens_cache is not None


def test_server_on_the_card_matches_the_host_walk(dev):
    """The port's Server on the card (every batch on KP1: the device-work
    floor at 1 row-tree), its buckets warmed at load (each launched once,
    no build or launch after it but one small-batch walk a device batch),
    answering threads in process and over HTTP: every response bit for
    bit the host walk's, converted and raw, no batch on the host, no
    breaker failure."""
    import threading
    from lightgbm_tpu_torch.obs import default_registry
    from lightgbm_tpu_torch.obs import device as obs_device
    from lightgbm_tpu_torch.serving import Server, ServingClient
    with open(os.path.join(_INTEROP, "ref50.txt")) as f:
        text = f.read()
    srv = Server({"serve_min_device_work": 1, "serve_max_batch_rows": 256,
                  "serve_batch_wait_ms": 2.0, "serve_port": 0,
                  "verbosity": -1}, device=dev)
    _cuda.build()
    _cuda.reset_launch_counts()
    srv.load_model("default", model_str=text)
    warm = srv.registry.get("default").warmed_buckets
    assert warm == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert _cuda.LAUNCHES["predict_ensemble_small"] == len(warm)
    httpd = srv.serve_http(block=False)
    host_bst = _ref50_booster("cpu")
    pool = _fixture_rows("binary.test", 2000, 37)
    want = host_bst.predict(pool, device=False)
    raw_want = host_bst.predict(pool, raw_score=True, device=False)
    rng = np.random.RandomState(41)
    jobs = [[(int(rng.randint(0, 1800)), int(rng.choice([1, 2, 7, 16, 64,
                                                         200])))
             for _ in range(25)] for _ in range(6)]
    bad = []
    builds = obs_device.compile_counts()
    _cuda.reset_launch_counts()

    def caller(i, mine):
        client = ServingClient(port=httpd.server_address[1], timeout=60)
        try:
            for a, n in mine:
                got = (client.predict(pool[a:a + n]) if i % 2
                       else srv.predict(pool[a:a + n]))
                if not np.array_equal(got, want[a:a + n]):
                    bad.append((i, a, n))
        except Exception as exc:   # noqa: BLE001 — fail the test, not the thread
            bad.append(repr(exc))

    try:
        threads = [threading.Thread(target=caller, args=(i, j))
                   for i, j in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not bad, bad[:10]
        snap = srv.stats_snapshot()["models"]["default"]
        assert snap["requests"] == 150 and snap["errors"] == 0
        assert snap["host_batches"] == 0 and snap["host_fallback"] == 0
        assert snap["breaker"]["consecutive_failures"] == 0
        assert snap["breaker"]["open_count"] == 0
        assert (_cuda.LAUNCHES["predict_ensemble_small"]
                == snap["device_batches"] > 0)
        assert sum(_cuda.LAUNCHES.values()) == snap["device_batches"]
        assert obs_device.compile_counts() == builds
        raw, on_card = srv.registry.get("default").predict(pool[:256],
                                                           raw_score=True)
        assert on_card and np.array_equal(raw, raw_want[:256])
    finally:
        srv.shutdown()
        default_registry().remove(model="default")
