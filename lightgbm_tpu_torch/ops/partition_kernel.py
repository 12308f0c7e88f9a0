"""The partition engine's arena and its kernels K2 to K6.

Port of lightgbm_tpu/ops/partition_pallas.py.  Rows live grouped by leaf
in an arena whose planes share one column index; a leaf's segment is a
contiguous column range, as in the JAX arena.  The JAX arena exists in bf16
residue planes (three planes per f32 payload, three byte planes per row id)
and moves rows with one-hot matrix products, because a TPU has no fast
scatter.  On Hopper a scatter is cheap, so this arena holds the payloads as
they are, about 40 bytes a row at G=28 instead of 96:

- `bins`  uint8 [G, cap]: the feature (group) bins;
- `payload` [2, cap]: gradient and hessian as f32, or their int8 codes in
  quantized mode (34 bytes a row in all; ops/quantize.py);
- `rid`   int32 [cap]:    the row id.

Kernels, each a wrapper that launches the CUDA kernel of `csrc/<name>.cu`
for CUDA tensors and runs the plain PyTorch version beside it for CPU
tensors:

- K2 `segment_histogram`: the [G, B, 3] (sum g, sum h, count) histogram of
  one segment (`_seg_hist_kernel`); f32 sums in f32 mode, exact int32 code
  sums in quantized mode;
- K3 `partition_segment`: the stable two-way split of a segment by a
  go-left mask over one channel's bins (`_partition_kernel`, decision
  mode), moving whichever payload the arena holds;
- K4 `scatter_segments`: per-row values from the live segments
  (`_compact_rows_kernel` together with its consumer's sort by row id);
- K5 `fused_refresh_histogram`: writes a segment's code planes and returns
  its int32 histogram in one pass (`_fused_root_kernel`);
- K6 `compact_carry`: copies the live segments, in leaf-index order, into
  one dense block (`_compact_carry_kernel`).

The kernels read a segment's start and count, and write the child counts,
through small device int32 vectors (the SMEM scalars of the Pallas
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
    child to `work0` instead (grow_partition).  Only the payload planes of
    the pristine block change, once per tree."""

    def __init__(self, num_data: int, num_groups: int, factor: int, device,
                 quantized: bool = False):
        G, cap = arena_geometry(num_data, num_groups, factor)
        self.num_data = num_data
        self.num_groups = G
        self.cap = cap
        pdt = torch.int8 if quantized else torch.float32
        self.bins = torch.zeros((G, cap), dtype=torch.uint8, device=device)
        # [2, cap] g/h (f32) or their codes (int8)
        self.payload = torch.zeros((2, cap), dtype=pdt, device=device)
        self.rid = torch.zeros(cap, dtype=torch.int32, device=device)
        self.device = self.bins.device
        # K3 writes stream A here before copying it to dstA
        scap = max(num_data, 1)
        self.scap = scap
        self.s_bins = torch.empty((G, scap), dtype=torch.uint8, device=device)
        self.s_payload = torch.empty((2, scap), dtype=pdt, device=device)
        self.s_rid = torch.empty(scap, dtype=torch.int32, device=device)
        self.block_counts = torch.zeros(PARTITION_BLOCKS, dtype=torch.int32,
                                        device=device)

    @property
    def quantized(self) -> bool:
        return self.payload.dtype == torch.int8


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


def _check_max_bin(max_bin: int) -> None:
    if not 1 <= max_bin <= 256:
        raise ValueError("max_bin must be in [1, 256], got %d" % max_bin)


# --------------------------------------------------------------------------- #
# K2: segment histogram
# --------------------------------------------------------------------------- #
def code_histogram_plain(bins: torch.Tensor, codes: torch.Tensor,
                         max_bin: int) -> torch.Tensor:
    """[G, max_bin, 3] int32 (sum g_code, sum h_code, count) of the columns
    of bins [G, m] uint8 and codes [2, m] int8, summed exactly in int64."""
    G, m = bins.shape
    c = codes.long()
    vals = torch.stack([c[0], c[1], torch.ones_like(c[0])], dim=1)   # [m, 3]
    out = torch.zeros((G, max_bin, 3), dtype=torch.int64, device=bins.device)
    for f in range(G):
        out[f].index_add_(0, bins[f].long(), vals)
    return out.to(torch.int32)


def segment_histogram_plain(arena: Arena, seg: torch.Tensor,
                            max_bin: int) -> torch.Tensor:
    """Quantized arena: the exact int32 code sums.  f32 arena: the
    histogram accumulated in f64 and rounded once to f32, since a sum of
    tens of thousands of rows in one f32 accumulator would itself be off
    by more than the kernel's tolerance."""
    start, cnt = (int(v) for v in seg.tolist())
    bins = arena.bins[:, start:start + cnt]
    if arena.quantized:
        return code_histogram_plain(bins, arena.payload[:, start:start + cnt],
                                    max_bin)
    G = arena.num_groups
    dev = arena.bins.device
    flat = (torch.arange(G, device=dev)[:, None] * max_bin
            + bins.long()).reshape(-1)
    gh = arena.payload[:, start:start + cnt].double()
    g = gh[0].expand(G, cnt).reshape(-1)
    h = gh[1].expand(G, cnt).reshape(-1)
    vals = torch.stack([g, h, torch.ones_like(g)], dim=1)
    out = torch.zeros((G * max_bin, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, flat, vals)
    return out.reshape(G, max_bin, 3).to(torch.float32)


def segment_histogram(arena: Arena, seg: torch.Tensor,
                      max_bin: int) -> torch.Tensor:
    """[G, max_bin, 3] histogram of arena columns [seg[0], seg[0]+seg[1]);
    seg is an int32 device pair (a view into sc works).  f32 sums of g/h
    for an f32 arena; exact int32 sums of the codes for a quantized one."""
    _check_max_bin(max_bin)
    dev = arena.device
    _cuda.require(seg, "seg", torch.int32, dev, (2,))
    if not _cuda.plain_or_cuda(dev):
        return segment_histogram_plain(arena, seg, max_bin)
    G = arena.num_groups
    name = ("segment_histogram_i8" if arena.quantized
            else "segment_histogram")
    out = torch.zeros((G, max_bin, 3), device=dev,
                      dtype=torch.int32 if arena.quantized else torch.float32)
    rc = _cuda.fn("lgbt_" + name)(
        arena.bins.data_ptr(), arena.payload.data_ptr(), seg.data_ptr(),
        out.data_ptr(), G, max_bin, arena.cap, HIST_BLOCKS, _cuda.stream())
    _cuda.check(rc, name)
    return out


def segment_histogram_bytes(cnt: int, G: int, max_bin: int,
                            quantized: bool = False) -> int:
    """Bytes K2 must move: each row's G bins and its payload (8 bytes of
    g/h, or 2 of codes) read once, the histogram written once."""
    return cnt * (G + (2 if quantized else 8)) + G * max_bin * 3 * 4


# --------------------------------------------------------------------------- #
# K5: fused code refresh + root histogram
# --------------------------------------------------------------------------- #
def fused_refresh_histogram_plain(arena: Arena, codes: torch.Tensor,
                                  seg: torch.Tensor,
                                  max_bin: int) -> torch.Tensor:
    start, cnt = (int(v) for v in seg.tolist())
    arena.payload[:, start:start + cnt] = codes[:, :cnt]
    return code_histogram_plain(arena.bins[:, start:start + cnt],
                                codes[:, :cnt], max_bin)


def fused_refresh_histogram(arena: Arena, codes: torch.Tensor,
                            seg: torch.Tensor, max_bin: int) -> torch.Tensor:
    """Write codes [2, n] int8 (segment order) to arena.payload[:,
    start:start+cnt] and return the segment's [G, max_bin, 3] int32 histogram,
    in one pass; seg is an int32 device pair (start, cnt) with cnt <= n."""
    _check_max_bin(max_bin)
    if not arena.quantized:
        raise ValueError("fused_refresh_histogram needs a quantized arena")
    dev = arena.device
    _cuda.require(seg, "seg", torch.int32, dev, (2,))
    _cuda.require(codes, "codes", torch.int8, dev)
    if codes.dim() != 2 or codes.shape[0] != 2:
        raise ValueError("codes: shape %s, expected (2, n)"
                         % (tuple(codes.shape),))
    if not _cuda.plain_or_cuda(dev):
        return fused_refresh_histogram_plain(arena, codes, seg, max_bin)
    G = arena.num_groups
    out = torch.zeros((G, max_bin, 3), dtype=torch.int32, device=dev)
    rc = _cuda.fn("lgbt_fused_root_histogram")(
        arena.bins.data_ptr(), arena.payload.data_ptr(), codes.data_ptr(),
        codes.shape[1], seg.data_ptr(), out.data_ptr(), G, max_bin,
        arena.cap, HIST_BLOCKS, _cuda.stream())
    _cuda.check(rc, "fused_root_histogram")
    return out


def fused_refresh_bytes(cnt: int, G: int, max_bin: int) -> int:
    """Bytes K5 must move: each row's G bins and 2 codes read once, its 2
    codes written once, the histogram written once."""
    return cnt * (G + 4) + G * max_bin * 3 * 4


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
    for plane in (arena.bins, arena.payload):
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
    sc[DST_B] (which must not overlap the segment).  Every plane moves with
    its row, the payload whatever its type.  Writes the counts to sc[CNT_A]
    and sc[CNT_B]."""
    dev = arena.device
    _cuda.require(sc, "sc", torch.int32, dev, (SC_LEN,))
    _cuda.require(goleft, "goleft", torch.uint8, dev, (256,))
    if not _cuda.plain_or_cuda(dev):
        partition_segment_plain(arena, sc, goleft)
        return
    name = ("partition_segment_i8" if arena.quantized
            else "partition_segment")
    rc = _cuda.fn("lgbt_" + name)(
        arena.bins.data_ptr(), arena.payload.data_ptr(), arena.rid.data_ptr(),
        arena.cap, arena.s_bins.data_ptr(), arena.s_payload.data_ptr(),
        arena.s_rid.data_ptr(), arena.scap, sc.data_ptr(), goleft.data_ptr(),
        arena.block_counts.data_ptr(), PARTITION_BLOCKS, arena.num_groups,
        _cuda.stream())
    _cuda.check(rc, name)


def partition_bytes(cnt: int, G: int, quantized: bool = False) -> int:
    """Bytes K3 must move: each row's planes (G bins, the payload, a 4-byte
    row id) read once and written once."""
    return 2 * cnt * (G + (6 if quantized else 12))


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


def _require_segments(seg: torch.Tensor, nl: torch.Tensor, dev) -> int:
    L = seg.shape[0]
    _cuda.require(seg, "seg", torch.int32, dev, (L, 2))
    _cuda.require(nl, "nl", torch.int32, dev, (1,))
    if not 1 <= L <= 65535:
        raise ValueError("1 to 65535 leaf segments, got %d" % L)
    return L


def scatter_segments(arena: Arena, seg: torch.Tensor, vals: torch.Tensor,
                     nl: torch.Tensor, out: torch.Tensor) -> None:
    """out[rid[start_l + i]] = vals[l] for every live leaf l < nl[0] and row
    i of its segment; seg [L, 2] int32 (start, count).  vals and out are
    both f32 (leaf values) or both int32 (leaf ids)."""
    dev = arena.device
    L = _require_segments(seg, nl, dev)
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


# --------------------------------------------------------------------------- #
# K6: carry compaction
# --------------------------------------------------------------------------- #
def compact_carry_plain(arena: Arena, seg: torch.Tensor, nl: torch.Tensor,
                        dst0: int) -> torch.Tensor:
    live = int(nl.reshape(-1)[0])
    dev = arena.device
    cols = [torch.arange(s, s + c, device=dev)
            for s, c in seg[:live].tolist()]
    cols = (torch.cat(cols) if cols
            else torch.zeros(0, dtype=torch.int64, device=dev))
    used = int(cols.numel())
    for plane in (arena.bins, arena.payload):
        plane[:, dst0:dst0 + used] = plane[:, cols]
    arena.rid[dst0:dst0 + used] = arena.rid[cols]
    return torch.tensor([used], dtype=torch.int32, device=dev)


def compact_carry(arena: Arena, seg: torch.Tensor, nl: torch.Tensor,
                  dst0: int) -> torch.Tensor:
    """Copy the live segments (leaf l < nl[0] at seg[l] = (start, count)),
    every plane, into one dense block at column dst0 in leaf-index order;
    the block must not overlap a live segment.  Returns the rows written as
    a device int32 [1] (the host is not synced)."""
    dev = arena.device
    L = _require_segments(seg, nl, dev)
    if not 0 <= dst0 < arena.cap:
        raise ValueError("dst0 %d outside the arena" % dst0)
    if not _cuda.plain_or_cuda(dev):
        return compact_carry_plain(arena, seg, nl, dst0)
    offsets = torch.empty(L, dtype=torch.int32, device=dev)
    used = torch.empty(1, dtype=torch.int32, device=dev)
    name = "compact_carry_i8" if arena.quantized else "compact_carry"
    rc = _cuda.fn("lgbt_" + name)(
        arena.bins.data_ptr(), arena.payload.data_ptr(), arena.rid.data_ptr(),
        arena.cap, seg.data_ptr(), nl.data_ptr(), L, offsets.data_ptr(),
        used.data_ptr(), dst0, arena.num_groups, SCATTER_BLOCKS,
        _cuda.stream())
    _cuda.check(rc, name)
    return used


def compact_carry_bytes(n: int, G: int, L: int,
                        quantized: bool = False) -> int:
    """Bytes K6 must move: each live row's planes (G bins, the payload, a
    4-byte row id) read once and written once, the segments read once."""
    return 2 * n * (G + (6 if quantized else 12)) + 8 * L
