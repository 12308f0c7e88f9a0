"""The partition engine's arena and its kernels K2, K3 and K4.

Port of lightgbm_tpu/ops/partition_pallas.py.  Rows live grouped by leaf
in an arena whose planes share one column index; a leaf's segment is a
contiguous column range, as in the JAX arena.  The JAX arena exists in bf16
residue planes (three planes per f32 payload, three byte planes per row id)
and moves rows with one-hot matrix products, because a TPU has no fast
scatter.  On Hopper a scatter is cheap, so this arena holds the payloads as
they are, about 40 bytes a row at G=28 instead of 96:

- `bins`  uint8 [G, cap]: the feature (group) bins;
- `gh`    f32   [2, cap]: gradient and hessian;
- `rid`   int32 [cap]:    the row id.

Three kernels, each a wrapper that launches the CUDA kernel of
`csrc/<name>.cu` for CUDA tensors and runs the plain PyTorch version
beside it for CPU tensors:

- K2 `segment_histogram`: the [G, B, 3] (sum g, sum h, count) histogram of
  one segment (`_seg_hist_kernel`, f32 mode);
- K3 `partition_segment`: the stable two-way split of a segment by a
  go-left mask over one channel's bins (`_partition_kernel`, decision
  mode);
- K4 `scatter_segments`: per-row values from the live segments
  (`_compact_rows_kernel` together with its consumer's sort by row id).

The kernels read a segment's start and count, and write the child counts,
through a small device int32 vector `sc` (the SMEM scalars of the Pallas
kernels), so a grow loop never syncs the host per split.

Geometry (`arena_geometry`, `pristine_work0`) keeps the JAX formulas, so
the bump allocator runs out of room on the same trees.
"""
from __future__ import annotations

import torch

from . import _cuda

TILE = 2048        # the JAX kernels' tile: kept for the geometry formulas
ALLOC = 256        # bump-allocation granularity (partition_pallas.FLUSH_W)

# sc layout (csrc/partition_segment.cu)
SC_START, SC_CNT, SC_DST_A, SC_DST_B, SC_CNT_B, SC_CNT_A, SC_CHAN, SC_XR = \
    range(8)
SC_LEN = 8

PARTITION_BLOCKS = 1024   # fixed grids: the host never learns a segment size
HIST_BLOCKS = 264
SCATTER_BLOCKS = 64


def arena_geometry(num_data: int, num_features: int, factor: int = 3) -> tuple:
    """(G, cap): the JAX sizing formula (`factor` row footprints plus a
    16-tile tail), with the channel count reduced to the G bin planes."""
    base = -(-max(num_data, 1) // TILE) * TILE
    cap = max(factor, 3) * base + 16 * TILE
    return max(num_features, 1), cap


def pristine_work0(num_data: int) -> int:
    """First work-region column of the pristine layout: the pristine row
    block [0, align(n)) plus one guard tile."""
    return -(-max(num_data, 1) // TILE) * TILE + TILE


class Arena:
    """The arena planes, the K3 scratch planes and the K3 block counts.

    The pristine block [0, n) holds the rows in row order and is never
    overwritten by a partition: the root's first split writes its larger
    child to `work0` instead (grow_partition).  Only the g/h planes of the
    pristine block change, once per tree."""

    def __init__(self, num_data: int, num_groups: int, factor: int, device):
        G, cap = arena_geometry(num_data, num_groups, factor)
        self.num_data = num_data
        self.num_groups = G
        self.cap = cap
        self.bins = torch.zeros((G, cap), dtype=torch.uint8, device=device)
        self.gh = torch.zeros((2, cap), dtype=torch.float32, device=device)
        self.rid = torch.zeros(cap, dtype=torch.int32, device=device)
        self.device = self.bins.device
        # K3 writes stream A here before copying it to dstA
        scap = max(num_data, 1)
        self.scap = scap
        self.s_bins = torch.empty((G, scap), dtype=torch.uint8, device=device)
        self.s_gh = torch.empty((2, scap), dtype=torch.float32, device=device)
        self.s_rid = torch.empty(scap, dtype=torch.int32, device=device)
        self.block_counts = torch.zeros(PARTITION_BLOCKS, dtype=torch.int32,
                                        device=device)


def init_pristine(arena: Arena, bins_t: torch.Tensor) -> None:
    """Write the per-dataset planes (bins [G, n] uint8 and row ids) into
    the pristine block once; per-tree assembly then only refreshes g/h."""
    G, n = bins_t.shape
    if G != arena.num_groups or n != arena.num_data:
        raise ValueError("bins_t %s does not fit the arena (G=%d, n=%d)"
                         % (tuple(bins_t.shape), arena.num_groups,
                            arena.num_data))
    arena.bins[:, :n] = bins_t
    arena.rid[:n] = torch.arange(n, dtype=torch.int32, device=arena.device)


# --------------------------------------------------------------------------- #
# K2: segment histogram
# --------------------------------------------------------------------------- #
def segment_histogram_plain(arena: Arena, seg: torch.Tensor,
                            max_bin: int) -> torch.Tensor:
    """The histogram accumulated in f64 and rounded once to f32: a sum of
    tens of thousands of rows in one f32 accumulator would itself be off
    by more than the kernel's tolerance."""
    start, cnt = (int(v) for v in seg.tolist())
    G = arena.num_groups
    dev = arena.bins.device
    b = arena.bins[:, start:start + cnt].long()                  # [G, m]
    flat = (torch.arange(G, device=dev)[:, None] * max_bin + b).reshape(-1)
    gh = arena.gh[:, start:start + cnt].double()
    g = gh[0].expand(G, cnt).reshape(-1)
    h = gh[1].expand(G, cnt).reshape(-1)
    vals = torch.stack([g, h, torch.ones_like(g)], dim=1)
    out = torch.zeros((G * max_bin, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, flat, vals)
    return out.reshape(G, max_bin, 3).to(torch.float32)


def segment_histogram(arena: Arena, seg: torch.Tensor,
                      max_bin: int) -> torch.Tensor:
    """[G, max_bin, 3] f32 histogram of arena columns [seg[0],
    seg[0]+seg[1]); seg is an int32 device pair (a view into sc works)."""
    if not 1 <= max_bin <= 256:
        raise ValueError("max_bin must be in [1, 256], got %d" % max_bin)
    dev = arena.device
    _cuda.require(seg, "seg", torch.int32, dev, (2,))
    if not _cuda.plain_or_cuda(dev):
        return segment_histogram_plain(arena, seg, max_bin)
    G = arena.num_groups
    out = torch.zeros((G, max_bin, 3), dtype=torch.float32, device=dev)
    rc = _cuda.fn("lgbt_segment_histogram")(
        arena.bins.data_ptr(), arena.gh.data_ptr(), seg.data_ptr(),
        out.data_ptr(), G, max_bin, arena.cap, HIST_BLOCKS, _cuda.stream())
    _cuda.check(rc, "segment_histogram")
    return out


def segment_histogram_bytes(cnt: int, G: int, max_bin: int) -> int:
    """Bytes K2 must move: each row's G bins and g/h read once, the
    histogram written once."""
    return cnt * (G + 8) + G * max_bin * 3 * 4


# --------------------------------------------------------------------------- #
# K3: partition
# --------------------------------------------------------------------------- #
def partition_segment_plain(arena: Arena, sc: torch.Tensor,
                            goleft: torch.Tensor) -> None:
    start, cnt, dst_a, dst_b, _, _, chan, xr = (int(v) for v in sc.tolist())
    cols = torch.arange(start, start + cnt, device=arena.bins.device)
    go = goleft[arena.bins[chan, start:start + cnt].long()] != 0
    is_a = go ^ bool(xr)
    ca, cb = cols[is_a], cols[~is_a]
    na, nb = int(ca.numel()), int(cb.numel())
    for plane in (arena.bins, arena.gh):
        a_rows, b_rows = plane[:, ca], plane[:, cb]
        plane[:, dst_a:dst_a + na] = a_rows
        plane[:, dst_b:dst_b + nb] = b_rows
    a_rid, b_rid = arena.rid[ca], arena.rid[cb]
    arena.rid[dst_a:dst_a + na] = a_rid
    arena.rid[dst_b:dst_b + nb] = b_rid
    sc[SC_CNT_B] = nb
    sc[SC_CNT_A] = na


def partition_segment(arena: Arena, sc: torch.Tensor,
                      goleft: torch.Tensor) -> None:
    """Stable split of [sc[START], +sc[CNT]) in place on the arena: rows with
    (goleft[bins[sc[CHAN], col]] != 0) XOR sc[XR] go to stream A at
    sc[DST_A] (which may equal the start), the others to stream B at
    sc[DST_B] (which must not overlap the segment).  Writes the counts to
    sc[CNT_A] and sc[CNT_B]."""
    dev = arena.device
    _cuda.require(sc, "sc", torch.int32, dev, (SC_LEN,))
    _cuda.require(goleft, "goleft", torch.uint8, dev, (256,))
    if not _cuda.plain_or_cuda(dev):
        partition_segment_plain(arena, sc, goleft)
        return
    rc = _cuda.fn("lgbt_partition_segment")(
        arena.bins.data_ptr(), arena.gh.data_ptr(), arena.rid.data_ptr(),
        arena.cap, arena.s_bins.data_ptr(), arena.s_gh.data_ptr(),
        arena.s_rid.data_ptr(), arena.scap, sc.data_ptr(), goleft.data_ptr(),
        arena.block_counts.data_ptr(), PARTITION_BLOCKS, arena.num_groups,
        _cuda.stream())
    _cuda.check(rc, "partition_segment")


def partition_bytes(cnt: int, G: int) -> int:
    """Bytes K3 must move: each row's planes read once and written once."""
    return 2 * cnt * (G + 12)


# --------------------------------------------------------------------------- #
# K4: per-row values from the live segments
# --------------------------------------------------------------------------- #
def scatter_segments_plain(arena: Arena, seg: torch.Tensor,
                           vals: torch.Tensor, nl: torch.Tensor,
                           out: torch.Tensor) -> None:
    """The composition K4 replaces: compact the live segments into a
    (rowid, value) stream, then put each value at its row."""
    live = int(nl.reshape(-1)[0])
    rids, stream = [], []
    for (start, cnt), v in zip(seg[:live].tolist(), vals[:live]):
        rids.append(arena.rid[start:start + cnt].long())
        stream.append(v.expand(cnt))
    if rids:
        out.index_put_((torch.cat(rids),), torch.cat(stream).to(out.dtype))


def scatter_segments(arena: Arena, seg: torch.Tensor, vals: torch.Tensor,
                     nl: torch.Tensor, out: torch.Tensor) -> None:
    """out[rid[start_l + i]] = vals[l] for every live leaf l < nl[0] and row
    i of its segment; seg [L, 2] int32 (start, count).  vals and out are
    both f32 (leaf values) or both int32 (leaf ids)."""
    dev = arena.device
    L = seg.shape[0]
    _cuda.require(seg, "seg", torch.int32, dev, (L, 2))
    _cuda.require(nl, "nl", torch.int32, dev, (1,))
    if vals.dtype not in (torch.float32, torch.int32):
        raise TypeError("vals must be float32 or int32, got %s" % vals.dtype)
    _cuda.require(vals, "vals", vals.dtype, dev, (L,))
    _cuda.require(out, "out", vals.dtype, dev)
    if not _cuda.plain_or_cuda(dev):
        scatter_segments_plain(arena, seg, vals, nl, out)
        return
    name = ("lgbt_scatter_segments_f32" if vals.dtype == torch.float32
            else "lgbt_scatter_segments_i32")
    rc = _cuda.fn(name)(arena.rid.data_ptr(), seg.data_ptr(), vals.data_ptr(),
                        nl.data_ptr(), out.data_ptr(), L, SCATTER_BLOCKS,
                        _cuda.stream())
    _cuda.check(rc, "scatter_segments")


def scatter_bytes(n: int, L: int) -> int:
    """Bytes K4 must move: each row id read once, each output written
    once, the per-leaf segments and values read once."""
    return 8 * n + 12 * L
