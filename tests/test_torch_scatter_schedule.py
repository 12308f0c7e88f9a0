"""A numpy model of K4's schedule (csrc/scatter_segments.cu), and K4's
add mode against the score update it replaces.

K4 sets (or adds) each live leaf's value at the rows of its segment
(leaf l < nl at seg[l] = (start, count) of the arena's rid plane) in one
launch whose grid never learns the rows on the host.  Every block scans
the live counts into an exclusive prefix in shared memory (the offset of
every K-th leaf; K6's scan, modelled by
test_torch_carry_schedule.block_prefix).  The live rows, in leaf-index
order, are cut into warp units of 32 * UNIT rows that warps take
warp-stride; lane l takes rows l + 32 k (k < UNIT) of its unit, finding
the leaf of its first row by a binary search of the prefix and a walk of
at most K - 1 counts (live_segments.cuh `find_leaf`), then walking on
to the leaf of each later row.

The model walks those steps and checks, over seeded layouts, that every
live row is written exactly once, with its own leaf's value; that no other
row is written; that every row id load lies inside a live segment of the
rid plane; and that a warp's loads at each step read consecutive columns
wherever its 32 rows lie in one leaf.  The constants are read from the
kernel's source.

Two more CPU cases hold the add mode to the code it replaces: K4's plain
add mode is bit-equal to `score += delta * shrink`, and on a CPU fused run
(carried and pristine, f32 and quantized) every tree's live segments hold
all n rows and leave the scores that formula gives.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import grow_partition as gp
from lightgbm_tpu_torch.ops import partition_kernel as pk
from test_torch_carry_schedule import block_prefix, find_leaf

CSRC = Path(pk.__file__).resolve().parent.parent / "csrc"
LEAF_SEG = Path(pk.__file__).resolve().parent.parent / "tools" / \
    "carried_leaf_seg.json"


def _constants():
    text = (CSRC / "scatter_segments.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int %s = (\d+);" % name, text)
        assert m, name
        return int(m.group(1))
    return dict(threads=const("SCATTER_THREADS"), unit=const("UNIT"),
                cap=const("PREFIX_CAP"))


C = _constants()


def schedule(starts, counts, live, cap, grid=1056, walk=True):
    """Walk K4: (reads [cap], the times each rid column's row is written;
    leaf [cap], the leaf whose value it receives, -1 where none).
    walk=False drops a lane's walk to the leaf of its later rows (a fault
    the model must catch)."""
    T, UNIT = C["threads"], C["unit"]
    pre, K, total = block_prefix(counts, live, threads=T, cap=C["cap"])
    assert total == counts[:live].sum()
    reads = np.zeros(cap, np.int64)
    leaf = np.full(cap, -1, np.int64)
    if total == 0:
        return reads, leaf
    W = 32 * UNIT
    nw = -(-total // W)
    # warp-stride: warp g = (b * T + t) >> 5 takes units g, g + grid * T / 32
    warps = grid * T // 32
    taken = np.zeros(nw, np.int64)
    for g in range(warps):
        taken[g::warps] += 1
    np.testing.assert_array_equal(taken, np.ones(nw, np.int64))
    # every lane of every unit: its first row j0, its leaf by the search
    j0 = (np.arange(nw, dtype=np.int64)[:, None] * W
          + np.arange(32)).reshape(-1)
    j0 = j0[j0 < total]
    m, off, cnt = find_leaf(pre, K, counts, live, j0)
    cnt_of = np.concatenate([counts[:live], [0]])
    cols = []
    for k in range(UNIT):
        j = j0 + 32 * k
        on = j < total
        if walk:
            while True:
                step = on & (j >= off + cnt)
                if not step.any():
                    break
                off = np.where(step, off + cnt, off)
                m = np.where(step, m + 1, m)
                cnt = np.where(step, cnt_of[np.minimum(m, live)], cnt)
        col = starts[np.minimum(m, len(starts) - 1)] + (j - off)
        assert np.all((col[on] >= 0) & (col[on] < cap))
        np.add.at(reads, col[on], 1)
        leaf[col[on]] = m[on]
        cols.append(np.where(on, col, -1))
    # a warp's load at step k: consecutive columns where its rows share a
    # leaf (the lanes of one unit are consecutive entries of j0)
    cols = np.stack(cols, 1)
    for k in range(UNIT):
        c = cols[:len(cols) // 32 * 32, k].reshape(-1, 32)
        whole = (c >= 0).all(1)
        lm = leaf[np.maximum(c, 0)]
        one_leaf = whole & (lm == lm[:, :1]).all(1)
        assert np.all((np.diff(c, axis=1) == 1).all(1)[one_leaf])
    return reads, leaf


def _check(starts, counts, live, cap, **kw):
    """Every live row written once with its own leaf's value, no other row
    written: the rid plane holds a permutation of the live rows at the
    live columns and garbage elsewhere."""
    reads, leaf = schedule(starts, counts, live, cap, **kw)
    want = np.full(cap, -1, np.int64)
    for m in range(live):
        want[starts[m]:starts[m] + counts[m]] = m
    np.testing.assert_array_equal(reads, want >= 0)
    np.testing.assert_array_equal(leaf, want)
    total = int(counts[:live].sum())
    rid = np.full(cap, -7, np.int64)
    rid[want >= 0] = np.random.RandomState(0).permutation(total)
    written = np.bincount(rid[reads > 0], minlength=total)
    np.testing.assert_array_equal(written, np.ones(total, np.int64))
    return total


def layout(rng, counts, L=None, live=None, gap=23, align=1):
    """Starts for the counts in a shuffled leaf order with random gaps
    (aligned to `align`), every leaf past live dead; the plane's length, a
    multiple of 2048 as the arena's."""
    L = len(counts) if L is None else L
    live = len(counts) if live is None else live
    counts = np.concatenate([np.asarray(counts, np.int64),
                             np.full(L - len(counts), 777)])
    starts = np.full(L, 12_345, np.int64)
    pos = 0
    for leaf in rng.permutation(live):
        pos = -(-pos // align) * align + rng.randint(0, gap + 1) * align
        starts[leaf] = pos
        pos += counts[leaf]
    cap = -(-max(pos, 12_345 + 777) // 2048) * 2048
    return starts, counts, cap


def _run(rng, counts, L=None, live=None, **kw):
    starts, counts, cap = layout(rng, counts, L, live, **kw)
    return _check(starts, counts, len(counts) if live is None else live, cap)


@pytest.mark.parametrize("seed", range(6))
def test_random_layouts(seed):
    """Leaves of 0 to 300 rows, starts on any column."""
    rng = np.random.RandomState(seed)
    _run(rng, rng.randint(0, 300, rng.randint(1, 120)))


def test_tiny_and_empty_leaves():
    """Leaves of 0, 1 and 2 rows: most units span several leaves."""
    rng = np.random.RandomState(7)
    _run(rng, rng.choice([0, 1, 2], 400))


@pytest.mark.parametrize("live", [0, 1, 37])
def test_fewer_live_than_segments(live):
    """nl < L: the dead segments' garbage is never read; nl = 0 writes
    nothing."""
    rng = np.random.RandomState(8)
    total = _run(rng, rng.randint(1, 500, 40), L=60, live=live)
    assert (total == 0) == (live == 0)


@pytest.mark.parametrize("rows", [1, 16, 17, 513, 5000])
def test_one_leaf(rows):
    """A tree of one leaf (a degenerate round): every row of its segment,
    from an unaligned start."""
    starts, counts = np.array([5]), np.array([rows])
    _check(starts, counts, 1, 8192)


def test_even_main_path_layout():
    """The smoke's layout, cut: 255 equal leaves at any column."""
    rng = np.random.RandomState(10)
    _run(rng, np.full(255, 411))


def test_skewed_tree():
    """One leaf of half the rows, the rest geometric down to 20, at the
    bump allocator's 256-column alignment."""
    rng = np.random.RandomState(9)
    rest = np.maximum(20, (2_000 * 0.97 ** np.arange(254)).astype(int))
    _run(rng, np.concatenate([[rest.sum()], rest]), align=pk.ALLOC)


def test_carried_leaf_seg():
    """A real carried tree's 255 live segments at 10.5M rows in their
    6-fold arena (tools/carried_leaf_seg.json)."""
    with open(LEAF_SEG) as f:
        lay = json.load(f)
    seg = np.asarray(lay["seg"], np.int64)
    total = _check(seg[:, 0], seg[:, 1], lay["nl"], lay["cap"])
    assert total == lay["rows"]


@pytest.mark.parametrize("live", [4096, 4097, 9000])
def test_past_the_shared_prefix(live):
    """More live leaves than PREFIX_CAP: the prefix keeps every K-th
    leaf's offset (K = 2, 3) and the search walks the rest."""
    rng = np.random.RandomState(live)
    _run(rng, rng.choice([0, 1, 3, 20], live))


def test_a_lane_that_does_not_walk_is_caught():
    """The model has teeth: a lane that reads each later row from its
    first row's leaf writes the next leaves' rows with the wrong value
    (and reads columns of no leaf)."""
    rng = np.random.RandomState(11)
    starts, counts, cap = layout(rng, rng.randint(1, 40, 50))
    with pytest.raises(AssertionError):
        _check(starts, counts, 50, cap, walk=False)
    _check(starts, counts, 50, cap)


# --------------------------------------------------------------------------- #
# add mode against `score += delta * shrink`
# --------------------------------------------------------------------------- #
def _bits(t):
    return t.view(torch.int32)


def _parent_formula(arena, seg, vals, nl, score, shrink):
    """The fused paths' update before K4's add mode: a zeroed delta, K4 in
    set mode, then `score += delta * torch.tensor(shrink)`."""
    delta = torch.zeros_like(score)
    pk.scatter_segments_plain(arena, seg, vals, nl, delta)
    return score + delta * torch.as_tensor(shrink, dtype=torch.float32)


@pytest.mark.parametrize("shrink", [0.1, 0.05, 1.0 / 3.0])
def test_plain_add_is_the_score_update(shrink):
    """K4's plain add mode is bit-equal to the parent formula, values of
    every magnitude and sign, zeros, signed zeros and subnormal scores
    included."""
    rng = np.random.RandomState(12)
    n, L = 5000, 31
    arena = pk.Arena(n, 2, 3, "cpu")
    perm = rng.permutation(n).astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, n), L - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    starts = np.zeros(L, np.int64)
    pos = 0
    for leaf in rng.permutation(L):
        pos += int(rng.randint(0, 9))
        starts[leaf] = pos
        c = bounds[leaf + 1] - bounds[leaf]
        arena.rid[pos:pos + c] = torch.from_numpy(
            perm[bounds[leaf]:bounds[leaf + 1]])
        pos += c
    seg = torch.from_numpy(np.stack([starts, np.diff(bounds)], 1)
                           .astype(np.int32))
    vals = torch.from_numpy((rng.randn(L) * 10.0 ** rng.randint(-8, 3, L))
                            .astype(np.float32))
    vals[0], vals[1] = 0.0, -0.0
    nl = torch.tensor([L], dtype=torch.int32)
    score = torch.from_numpy((rng.randn(n) * 10.0 ** rng.randint(-6, 4, n))
                             .astype(np.float32))
    score[:50] = -0.0
    score[50:100] = 3e-41
    want = _parent_formula(arena, seg, vals, nl, score, shrink)
    pk.scatter_segments(arena, seg, vals, nl, score,
                        shrink=torch.tensor(shrink, dtype=torch.float32))
    assert torch.equal(_bits(score), _bits(want))


def _fused_data(n=900, F=6, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_run_scores_match_the_parent_formula(weighted, quantized,
                                                   monkeypatch):
    """Three rounds on the fused paths (unweighted: the carried arena;
    weighted: the pristine root): at every tree's K4 the live segments
    hold all n rows, and the score after the add equals the parent
    formula's bit for bit."""
    X, y = _fused_data()
    n = len(y)
    w = np.random.RandomState(3).rand(n) + 0.5 if weighted else None
    seen = []
    real = gp.scatter_segments

    def check(arena, seg, vals, nl, out, shrink=None):
        assert shrink is not None and out.dtype == torch.float32
        live = int(nl[0])
        want = _parent_formula(arena, seg, vals, nl, out.clone(), shrink)
        real(arena, seg, vals, nl, out, shrink=shrink)
        seen.append((int(seg[:live, 1].sum()),
                     torch.equal(_bits(out), _bits(want))))
    monkeypatch.setattr(gp, "scatter_segments", check)
    params = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
              "max_bin": 63, "min_data_in_leaf": 20, "verbose": -1,
              "tpu_quantized_grad": quantized}
    bst = lt.train(params, lt.Dataset(X, y, weight=w, device="cpu"),
                   num_boost_round=3, device="cpu")
    g = bst._gbdt
    assert g._quantized is quantized
    assert bool(g._carried_active) is not weighted
    assert seen == [(n, True)] * 3
