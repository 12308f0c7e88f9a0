"""Partition-engine leaf-wise tree growth (serial learner, numerical data).

Port of `grow_tree_partition_impl` (lightgbm_tpu/ops/grow_partition.py:91)
in the forms the GBDT driver's fused paths run it: serial, numerical
features, every row in the bag (`full_bag`), a dense per-leaf histogram
cache, `emit="score"|"leaf_ids"`, f32 or quantized gradients, and the
pristine or the carried root.  Rows live grouped by leaf in the arena
(ops/partition_kernel.py), so each split costs O(parent) to partition and
O(smaller child) to histogram; the sibling's histogram comes by subtraction
from the parent's.

Segments come from a bump allocator in ALLOC=256-column units: the larger
child is rewritten in place over its parent (stream A; the pristine root's
first split goes to `work0`, off the read-only pristine block) and the
smaller child is appended at the cursor (stream B).  When the cursor would
run past the arena the split does not apply, growth stops, and the
truncation flag is raised, as in the JAX engine.

Quantized mode (a quantized arena): the gradients arrive as int8 codes with
their two f32 scales; K5 writes the root's codes and builds its histogram
in one pass, K2 returns exact int32 code sums, and every histogram is
dequantized as it leaves its kernel, so the cache, the sibling subtraction
and the split scans run on f32 as in JAX (grow_partition.py:765-769).

Carried mode (`carried_root`): the root segment is an already assembled
block of all n rows in the order the previous tree left them (the driver's
carried arena); it is rewritten in place by the first split, the bump
allocator starts at `carried_bump0`, and `carry_dst` has K6 compact the
finished tree's segments, in leaf-index order, into the block the next
tree roots at.

The JAX loop is one `lax.while_loop`; here it is a Python loop of exactly
max_leaves-1 steps whose state lives in device tensors.  A step that cannot
split (no positive gain, or no room) degenerates exactly as in JAX: the
partition runs with cnt=0 and every table write is masked back, so the
remaining steps repeat the same no-op.  No step reads a value on the host:
the kernels read the segment and the decision from the device vector `sc`,
and the caller syncs once per tree when it fetches the packed tree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grow import TreeArrays
from .partition_kernel import (ALLOC, SC_CNT_A, SC_CNT_B, SC_DST_B, SC_LEN,
                               TILE, Arena, compact_carry,
                               fused_refresh_histogram, partition_segment,
                               pristine_work0, scatter_segments,
                               segment_histogram)
from .quantize import dequantize_hist
from .split import SplitParams
from .split_kernel import (_OF, _OG, _OLC, _OLG, _OLH, _OLO, _ODL, _ORC, _ORG,
                           _ORH, _ORO, _OT, NEG, NEG_GATE,
                           build_feature_statics, child_vector, no_split_row,
                           params_vector, split_scan)

# leaf table lanes
_LV, _LC, _LP, _LD, _LMIN, _LMAX = range(6)
# node table lanes
(_NF, _NT, _NDL, _NMT, _NLEFT, _NRIGHT, _NGAIN, _NVAL, _NCNT,
 _NCAT) = range(10)


def _align(x, unit: int):
    return (x + unit - 1) // unit * unit


def _put(table: torch.Tensor, idx: torch.Tensor, new: torch.Tensor,
         keep: torch.Tensor) -> None:
    """table[idx] = new unless keep (a 0-d bool on the device)."""
    old = table.index_select(0, idx)
    table.index_copy_(0, idx, torch.where(keep, old, new.unsqueeze(0)))


def grow_tree_partition(arena: Arena, grad: torch.Tensor, hess: torch.Tensor,
                        feature_mask: torch.Tensor, num_bins: torch.Tensor,
                        default_bins: torch.Tensor,
                        missing_types: torch.Tensor, params: SplitParams,
                        monotone: Optional[torch.Tensor] = None,
                        penalty: Optional[torch.Tensor] = None, *,
                        max_leaves: int, max_depth: int = -1, max_bin: int,
                        emit: str = "leaf_ids",
                        quant_scales: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                        carried_root: Optional[int] = None,
                        carried_bump0: int = 0,
                        carry_dst: Optional[int] = None):
    """Grow one leaf-wise tree on the arena's rows.

    grad and hess [n] are f32 for an f32 arena; for a quantized arena they
    are the int8 codes and quant_scales their (g_scale, h_scale).  They are
    in the order of the root segment: row order for the pristine root,
    the block's order for a carried root at column `carried_root`.

    Returns (TreeArrays on the arena's device, out [n], truncated): out is
    each row's unshrunk leaf value (emit="score") or leaf id
    (emit="leaf_ids") in row order; truncated is a 0-d bool tensor, True
    when the arena ran out of room."""
    dev = arena.device
    n, G = arena.num_data, arena.num_groups
    F = num_bins.shape[0]
    if F != G:
        raise NotImplementedError(
            "EFB-bundled datasets are not ported yet (ROADMAP.md queue 1, "
            "item 11)")
    if n >= (1 << 24):
        raise ValueError("partition engine supports n < 2^24 rows")
    if emit not in ("score", "leaf_ids"):
        raise ValueError("emit must be 'score' or 'leaf_ids', got %r" % emit)
    if arena.quantized != (quant_scales is not None):
        raise ValueError("a quantized arena takes quant_scales, an f32 arena "
                         "none")
    L, N, B = max_leaves, max(max_leaves - 1, 1), max_bin
    f32, i64 = torch.float32, torch.long
    work0 = pristine_work0(n)
    cap = arena.cap
    if carried_root is None:
        root_s0 = 0
        cursor0 = work0 + _align(n, TILE)
    else:
        # carried slots lie past the pristine block, so the first split's
        # dst_a below is the root itself: no redirect (gbdt.py:963)
        if carried_root < work0:
            raise ValueError("carried_root %d lies in the pristine block "
                             "(below %d)" % (carried_root, work0))
        root_s0 = int(carried_root)
        cursor0 = int(carried_bump0)

    if arena.quantized:
        g_scale, h_scale = quant_scales

        def seg_hist(seg):
            return dequantize_hist(segment_histogram(arena, seg, B), g_scale,
                                   h_scale)
    else:
        def seg_hist(seg):
            return segment_histogram(arena, seg, B)

    # ---- root ---------------------------------------------------------------
    # per-tree assembly: only the root's payload planes change; quantized,
    # K5 writes the codes while it builds the root histogram
    sc0 = torch.tensor([root_s0, n] + [0] * (SC_LEN - 2), dtype=torch.int32,
                       device=dev)
    if arena.quantized:
        root_hist = dequantize_hist(
            fused_refresh_histogram(arena, torch.stack([grad, hess]),
                                    sc0[0:2], B), g_scale, h_scale)
    else:
        arena.payload[0, root_s0:root_s0 + n] = grad
        arena.payload[1, root_s0:root_s0 + n] = hess
        root_hist = seg_hist(sc0[0:2])
    root_g = root_hist[0, :, 0].sum()
    root_h = root_hist[0, :, 1].sum()
    fvec1 = build_feature_statics(num_bins, default_bins, missing_types,
                                  monotone=monotone, penalty=penalty,
                                  feature_mask=feature_mask, children=1)
    fvec2 = fvec1.repeat(2, 1)
    pvec = params_vector(params, dev)
    root_row = split_scan(root_hist.unsqueeze(0), fvec1,
                          child_vector(root_g.view(1), root_h.view(1),
                                       torch.full((1,), float(n), device=dev)),
                          pvec)[1][0]

    split_cache = no_split_row(dev).repeat(L, 1)
    split_cache[0] = root_row
    leaf_mat = torch.zeros((L, 6), dtype=f32, device=dev)
    leaf_mat[:, _LP] = -1.0
    leaf_mat[:, _LMIN] = -torch.inf
    leaf_mat[:, _LMAX] = torch.inf
    leaf_mat[0, _LC] = float(n)
    leaf_seg = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    leaf_seg[0, 0] = root_s0
    leaf_seg[0, 1] = n
    node_mat = torch.zeros((N, 10), dtype=f32, device=dev)
    hist_cache = torch.zeros((L,) + tuple(root_hist.shape), dtype=f32,
                             device=dev)
    hist_cache[0] = root_hist

    nl = torch.ones(1, dtype=i64, device=dev)
    cursor = torch.full((1,), cursor0, dtype=i64, device=dev)
    truncated = torch.zeros((), dtype=torch.bool, device=dev)
    bv = torch.arange(256, dtype=i64, device=dev)
    fstat = torch.stack([missing_types, default_bins, num_bins - 1],
                        dim=1).to(device=dev, dtype=i64)
    mono = None if monotone is None else monotone.to(device=dev, dtype=i64)
    zl = torch.zeros((), dtype=i64, device=dev)
    zf = torch.zeros((), dtype=f32, device=dev)

    for _ in range(L - 1):
        bi = torch.argmax(split_cache[:, _OG]).view(1)
        row = split_cache.index_select(0, bi)[0]
        gain = row[_OG]
        feat = row[_OF].long().clamp_min(0).view(1)
        thr = row[_OT].long()
        dl = row[_ODL] > 0.5
        lg, lh, lc_f, lo = row[_OLG], row[_OLH], row[_OLC], row[_OLO]
        rg, rh, rc_f, ro = row[_ORG], row[_ORH], row[_ORC], row[_ORO]
        lc_i, rc_i = lc_f.long(), rc_f.long()
        seg = leaf_seg.index_select(0, bi)[0].long()
        s0 = seg[0]
        left_smaller = lc_i <= rc_i
        # bump-allocator overflow: the split does not apply and growth stops
        need = _align(torch.minimum(lc_i, rc_i), ALLOC)
        no_split = gain <= NEG_GATE
        overflow = (~no_split) & (cursor[0] + need + TILE > cap)
        keep = no_split | overflow
        dst_a = torch.where(s0 < work0, work0, s0)
        dst_b = cursor[0]

        # the go-left mask over bin values: threshold plus missing direction
        # (NumericalDecision, tree.h:429-465); stream A is the larger child,
        # so the decision is XOR'd with left_smaller
        fs = fstat.index_select(0, feat)[0]
        is_missing = (((fs[0] == 1) & (bv == fs[1]))
                      | ((fs[0] == 2) & (bv == fs[2])))
        go_left = torch.where(is_missing, dl, bv <= thr).to(torch.uint8)
        sc = torch.stack([s0, torch.where(keep, zl, seg[1]), dst_a, dst_b,
                          zl, zl, feat[0], left_smaller.long()]
                         ).to(torch.int32)
        partition_segment(arena, sc, go_left)
        small_hist = seg_hist(sc[SC_DST_B:SC_DST_B + 2])
        cnt_b, cnt_a = sc[SC_CNT_B].long(), sc[SC_CNT_A].long()

        parent_hist = hist_cache.index_select(0, bi)[0]
        large_hist = parent_hist - small_hist
        left_hist = torch.where(left_smaller, small_hist, large_hist)
        right_hist = torch.where(left_smaller, large_hist, small_hist)
        _put(hist_cache, bi, left_hist, keep)
        _put(hist_cache, nl, right_hist, keep)

        start_l = torch.where(left_smaller, dst_b, dst_a)
        start_r = torch.where(left_smaller, dst_a, dst_b)
        local_l = torch.where(left_smaller, cnt_b, cnt_a)
        local_r = torch.where(left_smaller, cnt_a, cnt_b)
        _put(leaf_seg, bi, torch.stack([start_l, local_l]).to(torch.int32),
             keep)
        _put(leaf_seg, nl, torch.stack([start_r, local_r]).to(torch.int32),
             keep)

        lrow = leaf_mat.index_select(0, bi)[0]
        parent_of = lrow[_LP].long()
        depth = lrow[_LD]
        min_p, max_p = lrow[_LMIN], lrow[_LMAX]
        min_l = min_r = min_p
        max_l = max_r = max_p
        if mono is not None:
            # monotone mid-constraint propagation
            # (serial_tree_learner.cpp:837-846)
            mono_t = mono.index_select(0, feat)[0]
            mid = (lo + ro) / 2
            max_l = torch.where(mono_t > 0, mid, max_p)
            min_r = torch.where(mono_t > 0, mid, min_p)
            min_l = torch.where(mono_t < 0, mid, min_p)
            max_r = torch.where(mono_t < 0, mid, max_p)

        # Tree::Split (tree.h:393-423): the parent's child pointer, one node
        # row and two leaf rows
        node = nl - 1
        node_f = node[0].to(f32)
        safe_p = parent_of.clamp_min(0).view(1)
        prow = node_mat.index_select(0, safe_p)[0]
        was_left = prow[_NLEFT] == -(bi[0] + 1).to(f32)
        has_p = parent_of >= 0
        prow_new = torch.cat([
            prow[:_NLEFT],
            torch.where(has_p & was_left, node_f, prow[_NLEFT]).view(1),
            torch.where(has_p & ~was_left, node_f, prow[_NRIGHT]).view(1),
            prow[_NRIGHT + 1:]])
        _put(node_mat, safe_p, prow_new, keep)
        nrow = torch.stack([
            feat[0].to(f32), thr.to(f32), dl.to(f32), fs[0].to(f32),
            -(bi[0] + 1).to(f32), -(nl[0] + 1).to(f32), gain, lrow[_LV],
            lc_f + rc_f, zf])
        _put(node_mat, node, nrow, keep)
        _put(leaf_mat, bi, torch.stack([lo, lc_f, node_f, depth + 1, min_l,
                                        max_l]), keep)
        _put(leaf_mat, nl, torch.stack([ro, rc_f, node_f, depth + 1, min_r,
                                        max_r]), keep)

        # one scan launch for both children, cross-feature select included
        svec2 = torch.stack([torch.stack([lg, lh, lc_f, min_l, max_l, zf, zf,
                                          zf]),
                             torch.stack([rg, rh, rc_f, min_r, max_r, zf, zf,
                                          zf])])
        rows2 = split_scan(torch.stack([left_hist, right_hist]), fvec2, svec2,
                           pvec)[1]
        if max_depth > 0:
            depth_ok = (depth + 1) < max_depth
            lane = torch.arange(rows2.shape[1], device=dev)
            rows2 = torch.where((lane == _OG) & ~depth_ok, NEG, rows2)
            rows2 = torch.where((lane == _OF) & ~depth_ok, -1.0, rows2)
        _put(split_cache, bi, rows2[0], keep)
        _put(split_cache, nl, rows2[1], keep)

        cursor = torch.where(keep, cursor, dst_b + _align(cnt_b, ALLOC))
        nl = torch.where(keep, nl, nl + 1)
        truncated = truncated | overflow

    nm, lm = node_mat, leaf_mat
    tree = TreeArrays(
        split_feature=nm[:, _NF].to(torch.int32),
        threshold_bin=nm[:, _NT].to(torch.int32),
        default_left=nm[:, _NDL] > 0.5,
        missing_type=nm[:, _NMT].to(torch.int32),
        left_child=nm[:, _NLEFT].to(torch.int32),
        right_child=nm[:, _NRIGHT].to(torch.int32),
        split_gain=nm[:, _NGAIN].contiguous(),
        internal_value=nm[:, _NVAL].contiguous(),
        internal_count=nm[:, _NCNT].to(torch.int32),
        leaf_value=lm[:, _LV].contiguous(),
        leaf_count=lm[:, _LC].to(torch.int32),
        leaf_parent=lm[:, _LP].to(torch.int32),
        leaf_depth=lm[:, _LD].to(torch.int32),
        num_leaves=nl[0].to(torch.int32),
        is_cat=nm[:, _NCAT] > 0.5,
        cat_mask=torch.zeros((N, 0), dtype=torch.bool, device=dev))

    # per-row outputs from the final segments (K4)
    if emit == "score":
        vals = tree.leaf_value
        out = torch.zeros(n, dtype=f32, device=dev)
    else:
        vals = torch.arange(L, dtype=torch.int32, device=dev)
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    nl32 = nl.to(torch.int32)
    scatter_segments(arena, leaf_seg, vals, nl32, out)
    if carry_dst is not None:
        compact_carry(arena, leaf_seg, nl32, int(carry_dst))
    return tree, out, truncated
