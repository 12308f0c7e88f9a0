"""A numpy model of K2's block schedule (csrc/segment_histogram.cu, its
body in csrc/seg_hist.cuh, which K5 runs as well with its codes read in
segment order).

K2 histograms arena columns [start, start+cnt) with a fixed grid of
`partition_kernel.HIST_BLOCKS` blocks that never learns the count on the
host.  It cuts the planes into CHUNK-column chunks from the chunk holding
the start; block b takes spans of SPAN_ROWS rows (spans b, b + grid, ...)
and returns at once when b * SPAN_ROWS reaches the chunked count, before it
touches memory; inside a span warp w takes chunks w, w + WARPS, ...; a lane
loads its feature's CHUNK bins with 16-byte loads and masks the columns
outside the segment; features come in slabs of 32, one lane each.
gridDim.y splits the features, whole slabs at a time, when the
sub-histogram exceeds the shared-memory budget.

The model walks those loops as the kernel does (the innermost one
vectorized) and checks that every row of the segment is counted exactly
once, that no block past the active count does anything, that every
working block has rows, and that every load is aligned and inside its
plane.  int8 segments of at most SMALL_ROWS rows take a row a thread
instead, grid-stride; the model checks that loop alike.  The schedule's
constants are read from the kernel's source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from lightgbm_tpu_torch.ops import partition_kernel as pk

CSRC = Path(pk.__file__).resolve().parent.parent / "csrc"


def _constants():
    text = (CSRC / "seg_hist.cuh").read_text()
    hist = (CSRC / "histogram.cuh").read_text()

    def const(src, name):
        m = re.search(r"constexpr int %s = ([0-9* ]+);" % name, src)
        assert m, name
        return int(np.prod([int(x) for x in m.group(1).split("*")]))
    return dict(chunk=const(text, "CHUNK"),
                span=const(text, "SPAN_ROWS"),
                slab=const(text, "SLAB"),
                threads=const(text, "SEG_THREADS"),
                small_rows=1 << int(re.search(
                    r"constexpr long long SMALL_ROWS = 1 << (\d+);",
                    text).group(1)),
                max_smem=const(hist, "HIST_MAX_SMEM"))


C = _constants()


def schedule(start, cnt, cap, grid_x, G=28, B=255, head_aware=True):
    """Walk K2's loops: (rows counted per segment row [cnt], per-block
    (working, chunks), per-feature owners).  head_aware=False counts the
    chunks as if the segment started on a chunk boundary (a fault the
    model must catch)."""
    chunk, span_chunks = C["chunk"], C["span"] // C["chunk"]
    warps = C["threads"] // 32
    assert cap % chunk == 0
    c0 = start // chunk
    nch = (start + cnt + chunk - 1) // chunk - c0 if cnt > 0 else 0
    if not head_aware:
        nch = -(-cnt // chunk)
    counted = np.zeros(cnt, np.int64)
    blocks = []
    slab = C["slab"]
    # g, h, count a bin; the 3 B words of a feature rounded up to 32
    slab_bytes = -(-3 * B // 32) * 32 * slab * 4
    f_chunk = min(C["max_smem"] // slab_bytes * slab, G)
    assert -(-f_chunk // slab) * slab_bytes <= C["max_smem"]
    owners = np.zeros(G, np.int64)
    for by in range(-(-G // f_chunk)):
        f0 = by * f_chunk
        nf = min(f_chunk, G - f0)
        for fb in range(0, nf, slab):
            for lane in range(32):
                if fb + lane < nf:
                    owners[f0 + fb + lane] += 1
    lanes = np.arange(chunk)
    for b in range(grid_x):
        if b * span_chunks >= nch:
            blocks.append((False, 0))          # returns before any access
            continue
        visited = []
        for sp in range(b * span_chunks, nch, grid_x * span_chunks):
            hi = min(sp + span_chunks, nch)
            for w in range(warps):
                visited.append(np.arange(sp + w, hi, warps))
        cs = np.concatenate(visited)
        col0 = (c0 + cs) * chunk
        # every lane's two 16-byte loads of its plane: aligned, in the plane
        assert np.all(col0 % 16 == 0)
        assert np.all(col0 >= 0) and np.all(col0 + chunk <= cap)
        cols = (col0[:, None] + lanes[None, :]).reshape(-1)
        cols = cols[(cols >= start) & (cols < start + cnt)]
        counted += np.bincount(cols - start, minlength=cnt)
        blocks.append((True, len(cs)))
    return counted, blocks, owners


def _check(start, cnt, cap, grid_x, **kw):
    counted, blocks, owners = schedule(start, cnt, cap, grid_x, **kw)
    np.testing.assert_array_equal(counted, np.ones(cnt, np.int64))
    assert np.all(owners == 1)
    span = C["span"]
    nrows = (-(-(start + cnt) // C["chunk"]) - start // C["chunk"]) \
        * C["chunk"] if cnt else 0
    for b, (working, nchunks) in enumerate(blocks):
        assert working == (b * span < nrows), b
        assert not working or nchunks > 0
    return sum(w for w, _ in blocks)


@pytest.mark.parametrize("start", [0, 5, 31, 32, 33, 4095, 4096, 123_457])
@pytest.mark.parametrize("cnt", [0, 1, 2, 31, 32, 33, 100, 4095, 4096,
                                 4097, 40_000])
def test_every_row_once(start, cnt):
    cap = -(-(start + cnt + 1) // 2048) * 2048
    working = _check(start, cnt, cap, pk.HIST_BLOCKS)
    if cnt == 0:
        assert working == 0


@pytest.mark.parametrize("G", [3, 28, 33, 64, 80, 100])
def test_feature_passes_and_chunks(G):
    """Features past 32 take another pass (another slab); at B=255 a
    feature chunk holds two slabs, so G=80 and G=100 take two (gridDim.y)."""
    _check(777, 9_000, 16_384, 7, G=G)


def test_a_small_grid_loops_over_spans():
    """Fewer blocks than spans: each block takes several spans."""
    _check(13, 300_000, 2048 * 160, 3)


def test_child_wakes_few_blocks():
    """A 40k-row child wakes ceil(its chunked rows / SPAN_ROWS) blocks."""
    working = _check(12_345, 40_000, 2048 * 64, pk.HIST_BLOCKS)
    chunked = (-(-(12_345 + 40_000) // C["chunk"]) - 12_345 // C["chunk"]) \
        * C["chunk"]
    assert working == -(-chunked // C["span"]) < pk.HIST_BLOCKS


def test_root_tiling():
    """The 10.5M-row Higgs root from the pristine block: every row once,
    every block of the grid at work."""
    n = 10_500_000
    _G, cap = pk.arena_geometry(n, 28, 3)
    working = _check(0, n, cap, pk.HIST_BLOCKS)
    assert working == pk.HIST_BLOCKS


def test_a_misplaced_chunk_count_is_caught():
    """The model has teeth: counting the chunks from the start instead of
    from its chunk's boundary leaves the tail of an unaligned segment
    uncounted."""
    counted, _, _ = schedule(5, 4096, 16_384, 4, head_aware=False)
    assert np.any(counted == 0)
    counted, _, _ = schedule(5, 4096, 16_384, 4)
    assert np.all(counted == 1)


def small_schedule(cnt, grid_x):
    """Walk the small int8 loop: (rows counted [cnt], working blocks).  A
    block works while b * threads < cnt; thread t of block b takes rows
    b * threads + t, then a grid of blocks further."""
    threads = C["threads"]
    counted = np.zeros(cnt, np.int64)
    working = []
    for b in range(grid_x):
        working.append(b * threads < cnt)
        if not working[-1]:
            continue
        rows = np.arange(b * threads, cnt, grid_x * threads)
        rows = (rows[:, None] + np.arange(threads)[None, :]).reshape(-1)
        counted += np.bincount(rows[rows < cnt], minlength=cnt)
        assert np.any(rows < cnt)              # a working block has rows
    return counted, working


@pytest.mark.parametrize("cnt", [0, 1, 511, 512, 513, 40_000, 135_168,
                                 135_169, "small_rows"])
def test_small_int8_segments_every_row_once(cnt):
    """Up to SMALL_ROWS rows, int8: every row once, and only the blocks
    with rows at work (a 40k-row child wakes 79 of the 264)."""
    cnt = C["small_rows"] if cnt == "small_rows" else cnt
    counted, working = small_schedule(cnt, pk.HIST_BLOCKS)
    np.testing.assert_array_equal(counted, np.ones(cnt, np.int64))
    assert sum(working) == min(-(-cnt // C["threads"]), pk.HIST_BLOCKS)
