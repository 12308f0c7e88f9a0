"""A numpy model of K6's schedule (csrc/compact_carry.cu).

K6 copies the live leaf segments (leaf l < nl at seg[l] = (start, count)),
every plane, into one dense block at dst0 in leaf-index order, in one
launch whose grid never learns the rows on the host.  Every block scans
the live counts into an exclusive prefix in shared memory (the offset of
every K-th leaf, K = 1 up to PREFIX_CAP live leaves), block-wide: a run
of leaves a thread, warp scans by shuffles, the warps' totals.  The
destination [dst0, dst0 + used) is cut into UNIT-column units aligned on
the planes; threads take them grid-stride.  A thread finds the leaf of its
unit's first column by a binary search of the prefix and a walk of at most
K - 1 counts; a unit inside one leaf and inside the block reads each
plane's source columns as the aligned 16-byte words that hold them and
joins them by word selects and funnel shifts (16 columns of a byte plane;
four words of four columns of a 4-byte plane); any other unit finds each
of its columns' sources, walking the leaves, and gathers them.

The model walks those steps as the kernel does and checks, over seeded
layouts, that every destination column of every plane is written exactly
once, from the right source column; that nothing outside the block is
written; that every 16-byte load is aligned and inside its plane; and that
the word joins equal the byte and word slices they stand for.  The
constants are read from the kernel's source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from lightgbm_tpu_torch.ops import partition_kernel as pk

CSRC = Path(pk.__file__).resolve().parent.parent / "csrc"


def _constants():
    text = (CSRC / "compact_carry.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int %s = (\d+);" % name, text)
        assert m, name
        return int(m.group(1))
    return dict(threads=const("CARRY_THREADS"), unit=const("UNIT"),
                cap=const("PREFIX_CAP"))


C = _constants()
U32 = np.uint64(0xFFFFFFFF)


# --------------------------------------------------------------------------- #
# the word joins: shift_bytes and shift_words
# --------------------------------------------------------------------------- #
def funnelshift_r(lo, hi, r):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> (r & 31)."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(r & 31)) & U32).astype(np.uint32)


def shift_bytes(x, y, sh):
    """Bytes sh..sh+15 of the 32 bytes x:y (two [4] uint32 words each), by
    the kernel's selects and funnel shifts."""
    w = list(x) + list(y)
    w0, w1, w2, w3, w4, w5, w6, w7 = w
    if sh & 8:
        w0, w1, w2, w3, w4, w5 = w2, w3, w4, w5, w6, w7
    if sh & 4:
        w0, w1, w2, w3, w4 = w1, w2, w3, w4, w5
    r = (sh & 3) * 8
    return np.array([funnelshift_r(a, b, r) for a, b in
                     ((w0, w1), (w1, w2), (w2, w3), (w3, w4))], np.uint32)


def shift_words(x, y, q):
    """Words q..q+3 of the 8 words x:y."""
    w0, w1, w2, w3 = x
    w4, w5, w6 = y[0], y[1], y[2]
    if q & 2:
        w0, w1, w2, w3, w4 = w2, w3, w4, w5, w6
    if q & 1:
        w0, w1, w2, w3 = w1, w2, w3, w4
    return np.array([w0, w1, w2, w3], np.uint32)


def test_shift_bytes_is_the_byte_slice():
    rng = np.random.RandomState(0)
    for _ in range(20):
        raw = rng.randint(0, 256, 32).astype(np.uint8)
        words = raw.view("<u4")
        for sh in range(16):
            got = shift_bytes(words[:4], words[4:], sh).view(np.uint8)
            np.testing.assert_array_equal(got, raw[sh:sh + 16])


def test_shift_words_is_the_word_slice():
    rng = np.random.RandomState(1)
    for _ in range(20):
        w = rng.randint(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
        for q in range(1, 4):
            np.testing.assert_array_equal(shift_words(w[:4], w[4:], q),
                                          w[q:q + 4])


# --------------------------------------------------------------------------- #
# the schedule
# --------------------------------------------------------------------------- #
def block_prefix(counts, live):
    """(pre, K, total): one block's scan as the kernel runs it."""
    T = C["threads"]
    K = max(1, -(-live // C["cap"]))
    per = -(-live // T)
    lo = np.minimum(np.arange(T) * per, live)
    hi = np.minimum(lo + per, live)
    sums = np.array([counts[a:b].sum() for a, b in zip(lo, hi)], np.int64)
    incl = sums.reshape(-1, 32).copy()
    o = 1
    while o < 32:                                  # __shfl_up_sync steps
        up = np.zeros_like(incl)
        up[:, o:] = incl[:, :-o]
        incl = incl + up
        o <<= 1
    warp_sum = incl[:, 31]
    base = np.concatenate([[0], np.cumsum(warp_sum)[:-1]])
    excl = (base[:, None] + incl).reshape(-1) - sums
    ng = -(-live // K)
    pre = np.full(max(ng, 1), -1, np.int64)
    for t in range(T):
        run = excl[t]
        for leaf in range(lo[t], hi[t]):
            if leaf % K == 0:
                pre[leaf // K] = run
            run += counts[leaf]
    assert np.all(pre[:ng] >= 0)                   # every group written
    return pre[:ng], K, int(base[-1] + incl[-1, 31])


def find_leaf(pre, K, counts, live, j):
    """The kernel's find_leaf for each j: (m, off, cnt) arrays."""
    lo = np.zeros_like(j)
    hi = np.full_like(j, len(pre))
    while np.any(hi - lo > 1):
        act = hi - lo > 1
        mid = (lo + hi) >> 1
        le = pre[np.minimum(mid, len(pre) - 1)] <= j
        lo = np.where(act & le, mid, lo)
        hi = np.where(act & ~le, mid, hi)
    m = lo * K
    off = pre[lo]
    cnt_of = np.concatenate([counts[:live], [0]])
    cnt = cnt_of[np.minimum(m, live)]
    for _ in range(K + 1):
        step = j >= off + cnt
        off = np.where(step, off + cnt, off)
        m = np.where(step, m + 1, m)
        cnt = np.where(step, cnt_of[np.minimum(m, live)], cnt)
    assert not np.any(j >= off + cnt)
    return m, off, cnt


def schedule(starts, counts, live, dst0, cap, grid=528, whole_leaf=True):
    """Walk K6: (src [cap] of the byte planes, src [cap] of the 4-byte
    planes, writes [cap] of each), -1 where nothing is written.
    whole_leaf=False drops the check that the unit lies in one leaf (a
    fault the model must catch)."""
    T, UNIT = C["threads"], C["unit"]
    pre, K, total = block_prefix(counts, live)
    assert total == counts[:live].sum()
    src = {k: np.full(cap, -1, np.int64) for k in ("byte", "word")}
    writes = {k: np.zeros(cap, np.int64) for k in ("byte", "word")}
    if total == 0:
        return src, writes, total
    end = dst0 + total
    u0 = dst0 // UNIT
    nu = -(-end // UNIT) - u0
    # grid-stride: thread (b, t) takes b * T + t, then grid * T further
    taken = np.zeros(nu, np.int64)
    for b in range(grid):
        for t0 in range(b * T, nu, grid * T):
            taken[t0:t0 + T] += 1
    np.testing.assert_array_equal(taken, np.ones(nu, np.int64))
    D = (u0 + np.arange(nu)) * UNIT
    d_lo = np.maximum(D, dst0)
    d_hi = np.minimum(D + UNIT, end)
    j = d_lo - dst0
    m, off, cnt = find_leaf(pre, K, counts, live, j)
    s = starts[np.minimum(m, len(starts) - 1)] + (j - off)
    fast = (d_lo == D) & (d_hi == D + UNIT)
    if whole_leaf:
        fast &= j + UNIT <= off + cnt
    k16 = np.arange(UNIT)
    # byte planes: aligned words at s - sh (and + 16 when sh > 0)
    sf, Df = s[fast], D[fast]
    sh = sf & 15
    base = sf - sh
    assert np.all(base % 16 == 0) and np.all(base >= 0)
    assert np.all(np.where(sh > 0, base + 32, base + 16) <= cap)
    cols = (Df[:, None] + k16).reshape(-1)
    np.add.at(writes["byte"], cols, 1)
    src["byte"][cols] = (base[:, None] + sh[:, None] + k16).reshape(-1)
    # 4-byte planes: words at s - q + 4 i, i < 4 (and i = 4 when q > 0)
    q = sf & 3
    wbase = sf - q
    assert np.all(wbase % 4 == 0) and np.all(wbase >= 0)
    assert np.all(np.where(q > 0, wbase + 20, wbase + 16) <= cap)
    np.add.at(writes["word"], cols, 1)
    i4, k4 = k16 // 4, k16 % 4
    src["word"][cols] = (wbase[:, None] + 4 * i4 + q[:, None] + k4
                         ).reshape(-1)
    # any other unit: each column's source, walking the leaves
    for u in np.nonzero(~fast)[0]:
        mm, oo, cc = int(m[u]), int(off[u]), int(cnt[u])
        sc = int(s[u])
        for d in range(int(d_lo[u]), int(d_hi[u])):
            jd = d - dst0
            if jd >= oo + cc:
                while jd >= oo + cc:
                    oo += cc
                    mm += 1
                    cc = int(counts[mm]) if mm < live else 0
                sc = int(starts[mm]) + (jd - oo)
            for k in ("byte", "word"):
                writes[k][d] += 1
                src[k][d] = sc
            sc += 1
    return src, writes, total


def expected_sources(starts, counts, live):
    return np.concatenate([np.arange(starts[l], starts[l] + counts[l])
                           for l in range(live)] + [np.zeros(0, np.int64)])


def _check(starts, counts, live, dst0, cap, **kw):
    src, writes, total = schedule(starts, counts, live, dst0, cap, **kw)
    want = expected_sources(starts, counts, live)
    inside = np.zeros(cap, bool)
    inside[dst0:dst0 + total] = True
    for k in ("byte", "word"):
        np.testing.assert_array_equal(writes[k][inside], 1)
        assert not writes[k][~inside].any()
        np.testing.assert_array_equal(src[k][dst0:dst0 + total], want)
    return total


def layout(rng, counts, L=None, live=None, gap=23, align=1):
    """Source starts for the counts, placed in a shuffled leaf order with
    random gaps from column 0 (aligned to `align`), every leaf past live
    dead (garbage that must not be read)."""
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
    return starts, counts, pos


def _run(rng, counts, dst_off, L=None, live=None, align=1, **kw):
    starts, counts, used = layout(rng, counts, L, live, align=align)
    dst0 = -(-used // 2048) * 2048 + dst_off
    cap = -(-(dst0 + used + 1) // 2048) * 2048
    return _check(starts, counts, len(counts) if live is None else live,
                  dst0, cap, **kw)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dst_off", [0, 256, 7, 1001])
def test_random_layouts(seed, dst_off):
    """Leaves of 0 to 300 rows at any column, dst0 256-aligned or not."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 300, rng.randint(1, 120))
    _run(rng, counts, dst_off)


@pytest.mark.parametrize("dst_off", [0, 5])
def test_tiny_leaves(dst_off):
    """Leaves of 0, 1 and 2 rows: most units span several leaves."""
    rng = np.random.RandomState(7)
    _run(rng, rng.choice([0, 1, 2], 400), dst_off)


@pytest.mark.parametrize("live", [0, 1, 37])
def test_fewer_live_than_segments(live):
    """nl < L: the dead segments' garbage is never read; nl = 0 writes
    nothing."""
    rng = np.random.RandomState(8)
    total = _run(rng, rng.randint(1, 500, 40), 3, L=60, live=live)
    assert (total == 0) == (live == 0)


@pytest.mark.parametrize("dst_off", [0, 256, 11])
def test_skewed_tree(dst_off):
    """One leaf of half the rows, the rest geometric down to 20, at the
    bump allocator's 256-column alignment, as a carried tree's leaf_seg."""
    rng = np.random.RandomState(9)
    rest = np.maximum(20, (2_000 * 0.97 ** np.arange(254)).astype(int))
    counts = np.concatenate([[rest.sum()], rest])
    _run(rng, counts, dst_off, align=pk.ALLOC)


def test_even_main_path_layout():
    """The smoke's layout, cut: 255 equal leaves at any column."""
    rng = np.random.RandomState(10)
    _run(rng, np.full(255, 411), 0, align=1)


@pytest.mark.parametrize("live", [4096, 4097, 9000])
def test_past_the_shared_prefix(live):
    """More live leaves than PREFIX_CAP: the prefix keeps every K-th
    leaf's offset (K = 2, 3) and the search walks the rest."""
    rng = np.random.RandomState(live)
    _run(rng, rng.choice([0, 1, 3], live), 9)


def test_a_unit_spanning_leaves_is_caught():
    """The model has teeth: taking a unit's 16 columns from its first
    leaf without checking that they lie in it copies the next leaf's rows
    wrongly."""
    rng = np.random.RandomState(11)
    starts, counts, used = layout(rng, rng.randint(1, 40, 50))
    dst0 = -(-used // 2048) * 2048
    cap = dst0 + 4096
    with pytest.raises(AssertionError):
        _check(starts, counts, 50, dst0, cap, whole_leaf=False)
    _check(starts, counts, 50, dst0, cap)
