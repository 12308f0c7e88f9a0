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
  mode), moving whichever payload the arena holds; and
  `partition_segment_pred`, the same split by a per-column predicate (its
  pred mode, the bagged root), optionally building one stream's histogram
  in the same pass (its hist_stream mode);
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

from typing import Optional

import torch

from . import _cuda

TILE = 2048        # the JAX kernels' tile: kept for the geometry formulas
ALLOC = 256        # bump-allocation granularity (partition_pallas.FLUSH_W)

# sc layout (csrc/partition_segment.cu)
SC_START, SC_CNT, SC_DST_A, SC_DST_B, SC_CNT_B, SC_CNT_A, SC_CHAN, SC_XR = \
    range(8)
SC_LEN = 8

HIST_BLOCKS = 264         # fixed grids: the host never learns a segment size
SCATTER_BLOCKS = 64

# K3's tiles (csrc/partition.cuh): rows a tile, and the bytes of a block's
# staged tiles below which two blocks fit an SM
PART_TILE, PART_TILE_SMALL = 1024, 512
PART_TWO_BLOCKS = 113 * 1024


def _staged_bytes(num_groups: int, T: int, quantized: bool) -> int:
    """Shared-memory bytes of one staged K3 tile: G bin planes, the payload
    and row-id planes with 16 bytes of slack each, a uint16 permutation."""
    p = 1 if quantized else 4
    return num_groups * (T + 16) + 2 * (T * p + 16) + (T * 4 + 16) + 2 * T


def partition_tile(num_groups: int, quantized: bool = False,
                   hist: bool = False) -> int:
    """Rows a K3 tile (csrc/partition.cuh `part_shape`): 1024 while a ring of
    two staged 1024-row tiles leaves two blocks an SM, else 512; 512 in
    pred mode with the histogram."""
    if hist:
        return PART_TILE_SMALL
    two = 2 * _staged_bytes(num_groups, PART_TILE, quantized)
    return PART_TILE if two <= PART_TWO_BLOCKS else PART_TILE_SMALL


def tile_state_words(num_data: int) -> int:
    """int32 words of K3's launch state: the ticket, and a status word and
    a staged flag per tile of the longest segment (num_data rows) at the
    smallest tile."""
    return 1 + 2 * -(-max(num_data, 1) // PART_TILE_SMALL)


def arena_geometry(num_data: int, num_features: int, factor: int = 3) -> tuple:
    """(G, cap): the JAX sizing formula (`factor` row footprints plus a
    16-tile tail), with the channel count reduced to the G bin planes."""
    base = -(-max(num_data, 1) // TILE) * TILE
    cap = max(factor, 3) * base + 16 * TILE
    return max(num_features, 1), cap


def arena_bytes(num_data: int, num_groups: int, factor: int,
                max_leaves: int, max_bin: int, quantized: bool = False) -> int:
    """Device bytes the partition engine holds for a dataset: the arena's
    planes and K3's tile status words (`Arena`), the dataset's [n, G] bins
    and the dense per-leaf histogram cache: the port's counterpart of the
    three terms of lightgbm_tpu/models/gbdt.py:1304-1306."""
    G, cap = arena_geometry(num_data, num_groups, factor)
    row = G + 2 * (1 if quantized else 4) + 4       # bins, payload, row id
    hist_cache = max_leaves * G * max(max_bin, 2) * 3 * 4
    return cap * row + num_data * G + 4 * tile_state_words(num_data) \
        + hist_cache


def pristine_work0(num_data: int) -> int:
    """First work-region column of the pristine layout: the pristine row
    block [0, align(n)) plus one guard tile."""
    return -(-max(num_data, 1) // TILE) * TILE + TILE


class Arena:
    """The arena planes and K3's ticket and tile status words.

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
        # K3's ticket and decoupled look-back status words, reset on the
        # stream by every launch
        self.tile_state = torch.zeros(tile_state_words(num_data),
                                      dtype=torch.int32, device=device)

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


def _columns_histogram_plain(arena: Arena, cols, max_bin: int
                             ) -> torch.Tensor:
    """Quantized arena: the exact int32 code sums of the arena columns
    `cols` (a slice or an index tensor).  f32 arena: the histogram
    accumulated in f64 and rounded once to f32, since a sum of tens of
    thousands of rows in one f32 accumulator would itself be off by more
    than the kernels' tolerance."""
    bins = arena.bins[:, cols]
    payload = arena.payload[:, cols]
    if arena.quantized:
        return code_histogram_plain(bins, payload, max_bin)
    G, cnt = bins.shape
    dev = arena.bins.device
    flat = (torch.arange(G, device=dev)[:, None] * max_bin
            + bins.long()).reshape(-1)
    gh = payload.double()
    g = gh[0].expand(G, cnt).reshape(-1)
    h = gh[1].expand(G, cnt).reshape(-1)
    vals = torch.stack([g, h, torch.ones_like(g)], dim=1)
    out = torch.zeros((G * max_bin, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, flat, vals)
    return out.reshape(G, max_bin, 3).to(torch.float32)


def segment_histogram_plain(arena: Arena, seg: torch.Tensor,
                            max_bin: int) -> torch.Tensor:
    start, cnt = (int(v) for v in seg.tolist())
    return _columns_histogram_plain(arena, slice(start, start + cnt), max_bin)


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
def _move_streams_plain(arena: Arena, sc: torch.Tensor,
                        is_a: torch.Tensor) -> None:
    """Move the segment's rows with is_a (bool [cnt]) to stream A at
    sc[DST_A] and the others to stream B at sc[DST_B], both in segment
    order; write the counts to sc."""
    start, cnt, dst_a, dst_b = (int(v) for v in sc[:SC_DST_B + 1].tolist())
    cols = torch.arange(start, start + cnt, device=arena.bins.device)
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


def partition_segment_plain(arena: Arena, sc: torch.Tensor,
                            goleft: torch.Tensor) -> None:
    start, cnt, _, _, _, _, chan, xr = (int(v) for v in sc.tolist())
    go = goleft[arena.bins[chan, start:start + cnt].long()] != 0
    _move_streams_plain(arena, sc, go ^ bool(xr))


def partition_segment(arena: Arena, sc: torch.Tensor,
                      goleft: torch.Tensor) -> None:
    """Stable split of [sc[START], +sc[CNT]) in place on the arena: rows with
    (goleft[bins[sc[CHAN], col]] != 0) XOR sc[XR] go to stream A at
    sc[DST_A], the others to stream B at sc[DST_B].  DST_A is the start
    itself, a column before it, or a range disjoint from the segment;
    stream B must not overlap the segment (the kernel writes stream A over
    the segment's own columns, csrc/partition_segment.cu).  Every plane
    moves with its row, the payload whatever its type.  Writes the counts
    to sc[CNT_A] and sc[CNT_B]; the segment holds at most num_data rows."""
    dev = arena.device
    _cuda.require(sc, "sc", torch.int32, dev, (SC_LEN,))
    _cuda.require(goleft, "goleft", torch.uint8, dev, (256,))
    if not _cuda.plain_or_cuda(dev):
        partition_segment_plain(arena, sc, goleft)
        return
    name = ("partition_segment_i8" if arena.quantized
            else "partition_segment")
    rc = _cuda.fn("lgbt_" + name)(
        *_arena_args(arena), sc.data_ptr(), goleft.data_ptr(),
        *_state_args(arena), arena.num_groups, _cuda.stream())
    _cuda.check(rc, name)


def _arena_args(arena: Arena) -> tuple:
    return (arena.bins.data_ptr(), arena.payload.data_ptr(),
            arena.rid.data_ptr(), arena.cap)


def _state_args(arena: Arena) -> tuple:
    return (arena.tile_state.data_ptr(), arena.tile_state.numel(),
            arena.num_data)


def partition_bytes(cnt: int, G: int, quantized: bool = False) -> int:
    """Bytes K3 must move: each row's planes (G bins, the payload, a 4-byte
    row id) read once and written once."""
    return 2 * cnt * (G + (6 if quantized else 12))


def _pred_rows(pred: torch.Tensor, start: int, cnt: int) -> torch.Tensor:
    """pred[col] != 0 for the segment's columns; 0 past pred's length."""
    out = torch.zeros(cnt, dtype=torch.bool, device=pred.device)
    inside = max(0, min(cnt, pred.shape[0] - start))
    out[:inside] = pred[start:start + inside] != 0
    return out


def partition_segment_pred_plain(arena: Arena, sc: torch.Tensor,
                                 pred: torch.Tensor,
                                 hist_stream: Optional[int] = None,
                                 max_bin: int = 0) -> Optional[torch.Tensor]:
    start, cnt = (int(v) for v in sc[:SC_CNT + 1].tolist())
    is_a = _pred_rows(pred, start, cnt)
    hist = None
    if hist_stream is not None:
        cols = torch.arange(start, start + cnt, device=arena.bins.device)
        cols = cols[is_a if hist_stream == 0 else ~is_a]
        hist = _columns_histogram_plain(arena, cols, max_bin)
    _move_streams_plain(arena, sc, is_a)
    return hist


def partition_segment_pred(arena: Arena, sc: torch.Tensor, pred: torch.Tensor,
                           hist_stream: Optional[int] = None,
                           max_bin: int = 0) -> Optional[torch.Tensor]:
    """Stable split of [sc[START], +sc[CNT]) by a per-column predicate:
    rows whose column col holds pred[col] != 0 go to stream A at sc[DST_A],
    the others to stream B at sc[DST_B] (the same rules as
    partition_segment); columns at or past pred's length read as 0.  pred is uint8
    [m], indexed by arena column as the JAX kernel indexes its [1, cap]
    predicate.  Writes the counts to sc[CNT_A] and sc[CNT_B].

    With hist_stream (0: stream A, 1: stream B) it also returns that
    stream's [G, max_bin, 3] histogram, built in the same pass: f32 sums
    for an f32 arena, exact int32 code sums for a quantized one."""
    dev = arena.device
    _cuda.require(sc, "sc", torch.int32, dev, (SC_LEN,))
    _cuda.require(pred, "pred", torch.uint8, dev)
    if pred.dim() != 1:
        raise ValueError("pred: shape %s, expected (m,)"
                         % (tuple(pred.shape),))
    if hist_stream not in (None, 0, 1):
        raise ValueError("hist_stream must be None, 0 or 1, got %r"
                         % (hist_stream,))
    if hist_stream is not None:
        _check_max_bin(max_bin)
    if not _cuda.plain_or_cuda(dev):
        return partition_segment_pred_plain(arena, sc, pred, hist_stream,
                                            max_bin)
    hist = None
    if hist_stream is not None:
        hist = torch.zeros(
            (arena.num_groups, max_bin, 3), device=dev,
            dtype=torch.int32 if arena.quantized else torch.float32)
    name = ("partition_segment_pred_i8" if arena.quantized
            else "partition_segment_pred")
    rc = _cuda.fn("lgbt_" + name)(
        *_arena_args(arena), sc.data_ptr(), pred.data_ptr(), pred.shape[0],
        *_state_args(arena), arena.num_groups,
        None if hist is None else hist.data_ptr(), max_bin,
        0 if hist_stream is None else hist_stream, _cuda.stream())
    _cuda.check(rc, name)
    return hist


def partition_pred_bytes(cnt: int, G: int, max_bin: int,
                         quantized: bool = False) -> int:
    """Bytes K3 in pred mode with a histogram must move: each row's planes
    read once and written once, its predicate byte read once, and the
    [G, max_bin, 3] histogram written once."""
    return partition_bytes(cnt, G, quantized) + cnt + G * max_bin * 3 * 4


# --------------------------------------------------------------------------- #
# K8: the stage ablation of K3
# --------------------------------------------------------------------------- #
# the cumulative stages of csrc/partition_ablate.cu, in order
ABLATE_STAGES = ("read", "decide", "lookback", "stage", "full")


def _plane_sums(arena: Arena, cols: torch.Tensor) -> torch.Tensor:
    """Each column's planes summed as unsigned 32-bit words (int64 here):
    its G bins, the bits of its two payload values and its row id."""
    s = arena.bins[:, cols].long().sum(0)
    p = arena.payload[:, cols]
    words = (p.view(torch.int32).long() & 0xFFFFFFFF if p.dtype == torch.float32
             else p.view(torch.uint8).long())
    return s + words.sum(0) + (arena.rid[cols].long() & 0xFFFFFFFF)


def _ablate_tiles(arena: Arena) -> int:
    return -(-max(arena.num_data, 1)
             // partition_tile(arena.num_groups, arena.quantized))


def partition_ablate_plain(arena: Arena, sc: torch.Tensor,
                           goleft: torch.Tensor,
                           stage: str) -> Optional[torch.Tensor]:
    """What each stage leaves.  read, decide, lookback and stage: one
    checksum (mod 2^32, as int32) per tile of the segment (partition_tile
    rows; zeros past its last tile), over the rows of the tile: the plane
    sums; plus each row's decision (decide); plus each row's destination
    column, dst_a plus its rank among the stream-A rows or dst_b plus its
    rank among the stream-B rows (lookback); plus the plane sums once more,
    gathered in output order (stage).  lookback and stage also write the
    counts to sc.  full: K3, and None."""
    if stage == "full":
        partition_segment_plain(arena, sc, goleft)
        return None
    start, cnt, dst_a, dst_b, _, _, chan, xr = (int(v) for v in sc.tolist())
    dev = arena.device
    cols = torch.arange(start, start + cnt, device=dev)
    words = _plane_sums(arena, cols)
    total = words.clone()
    is_a = (goleft[arena.bins[chan, cols].long()] != 0) ^ bool(xr)
    if stage != "read":
        total += is_a.long()
    if stage in ("lookback", "stage"):
        a_rank = torch.cumsum(is_a.long(), 0) - is_a.long()
        b_rank = torch.arange(cnt, device=dev) - a_rank
        total += torch.where(is_a, dst_a + a_rank, dst_b + b_rank)
        na = int(is_a.sum())
        sc[SC_CNT_B], sc[SC_CNT_A] = cnt - na, na
    if stage == "stage":
        total += words
    T = partition_tile(arena.num_groups, arena.quantized)
    sums = torch.zeros(_ablate_tiles(arena), dtype=torch.long, device=dev)
    sums.index_add_(0, torch.arange(cnt, device=dev) // T, total)
    sums &= 0xFFFFFFFF
    return torch.where(sums >= 1 << 31, sums - (1 << 32),
                       sums).to(torch.int32)


def partition_ablate(arena: Arena, sc: torch.Tensor, goleft: torch.Tensor,
                     stage: str) -> Optional[torch.Tensor]:
    """K8: K3 in decision mode stripped to `stage` (ABLATE_STAGES), as
    tools/kernel_ablate.py strips the TPU kernel; csrc/partition_ablate.cu
    on a CUDA arena, partition_ablate_plain on a CPU one.  Only the full
    stage partitions (and returns None); the earlier ones return the
    per-tile checksums that keep their loads live (partition_ablate_plain
    says which)."""
    dev = arena.device
    _cuda.require(sc, "sc", torch.int32, dev, (SC_LEN,))
    _cuda.require(goleft, "goleft", torch.uint8, dev, (256,))
    if stage not in ABLATE_STAGES:
        raise ValueError("stage must be one of %s, got %r"
                         % (", ".join(ABLATE_STAGES), stage))
    if not _cuda.plain_or_cuda(dev):
        return partition_ablate_plain(arena, sc, goleft, stage)
    chk = (None if stage == "full" else
           torch.zeros(_ablate_tiles(arena), dtype=torch.int32, device=dev))
    name = "partition_ablate_i8" if arena.quantized else "partition_ablate"
    rc = _cuda.fn("lgbt_" + name)(
        ABLATE_STAGES.index(stage), *_arena_args(arena), sc.data_ptr(),
        goleft.data_ptr(), *_state_args(arena), arena.num_groups,
        None if chk is None else chk.data_ptr(), _cuda.stream())
    _cuda.check(rc, "partition_ablate")
    return chk


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
        used.data_ptr(), dst0, arena.num_groups, _cuda.stream())
    _cuda.check(rc, name)
    return used


def compact_carry_bytes(n: int, G: int, L: int,
                        quantized: bool = False) -> int:
    """Bytes K6 must move: each live row's planes (G bins, the payload, a
    4-byte row id) read once and written once, the segments read once."""
    return 2 * n * (G + (6 if quantized else 12)) + 8 * L
