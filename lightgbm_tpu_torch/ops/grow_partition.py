"""Partition-engine leaf-wise tree growth (serial learner).

Port of `grow_tree_partition_impl` (lightgbm_tpu/ops/grow_partition.py:91)
in the forms models/gbdt.py runs it: serial, numerical and categorical
features, the arena's columns a feature each or EFB groups, every
row in the bag (`full_bag`) or a bag of rows (`in_bag`), a dense per-leaf
histogram cache or a pooled one, `emit="score"|"leaf_ids"`, f32 or
quantized gradients, the pristine or the carried root, CEGB and forced
splits.  Rows live grouped by leaf in the
arena (ops/partition_kernel.py), so each split costs O(parent) to
partition and O(smaller child) to histogram; the sibling's histogram comes
by subtraction from the parent's.

Bagged mode (`in_bag`, grow_partition.py:269-285): the gradients are
written in row order to the pristine block, and one K3 pass in pred mode
compacts the in-bag rows to `work0`, dumps the out-of-bag rows past them
and builds the in-bag root histogram (hist_stream=0); the bump region
starts past the dump, and the root count is the kernel's device count.

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

CEGB (`cegb_coupled`, `cegb_used`; grow_partition.py:87, :104-105,
:362-365, :493-495, :569-574): each scan patches K1's CEGB column with the
coupled penalty of every feature not yet used, a split marks its feature
used, and the booster's device vector is updated in place with the tree's
features.  Forced splits (`forced_splits`, :876-915) inject a +inf-gain
row for each plan entry's leaf before the best-first steps, as the label
engine does (ops/grow.py); they need the dense histogram cache.

Histogram pooling (`hist_slots` < max_leaves, :79-83, :577-590, :687-790,
HistogramPool, feature_histogram.hpp:646-818): the cache holds K slots,
each a leaf's histogram, written least recently first; a split whose
parent has no slot recomputes the parent's histogram with K2 over its
arena segment, still intact before K3 partitions it (on a hit K2 runs
over no rows).

With EFB (`bundle`) the arena holds group columns: every histogram is a
group histogram, unbundled to the features before its scan (JAX :323-325,
:500-551), and K3's go-left mask over the group's 256 bin values decodes
them to the split feature's bins (:706-733).  Where a feature is
categorical (`is_categorical`) every scan is the XLA route's
(ops/grow.scan_rows, as JAX :343 takes it), a split carries its
left-going bins beside its row, and the mask encodes that bin set; K3
itself does not change.

The JAX loop is one `lax.while_loop`; here it is a Python loop of exactly
max_leaves-1 steps whose state lives in device tensors.  A step that cannot
split (no positive gain, or no room) degenerates exactly as in JAX: the
partition runs with cnt=0 and every table write is masked back, so the
remaining steps repeat the same no-op.  Nothing between the inputs and the
outputs reads a value on the host or copies one to the device: the kernels
read the segment and the decision from the device vector `sc`, built on
the device, and the split parameters come in as K1's vector (`pvec`).  So
the whole grower can be captured into a CUDA graph (ops/graphs.py), which
the driver replays once a round; the Python values it bakes in (the arena
columns, max_leaves) are fixed per graph, and the shrinkage, a device
scalar that K4 reads, takes its value of the replay.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grow import (_LC, BundleMaps, decision_table, forced_row, mask_depth,
                   new_tables, put, record_split, scan_rows,
                   tree_from_tables, unbundle_hist)
from .partition_kernel import (ALLOC, SC_CNT_A, SC_CNT_B, SC_DST_B, SC_LEN,
                               TILE, Arena, compact_carry,
                               fused_refresh_histogram, partition_segment,
                               partition_segment_pred, pristine_work0,
                               scatter_segments, segment_histogram)
from .quantize import dequantize_hist
from .split import SplitParams
from .split_kernel import (_OF, _OG, _OLC, _OLG, _OLH, _ORC, _ORG, _ORH,
                           NEG, NEG_GATE, build_feature_statics, cegb_statics,
                           child_vector, no_split_row, params_vector,
                           split_scan)


def _align(x, unit: int):
    return (x + unit - 1) // unit * unit


def _sc_vector(head, dev) -> torch.Tensor:
    """K3's int32 [SC_LEN] segment vector with its first words set from
    Python ints by fills on the device (no host-to-device copy)."""
    sc = torch.zeros(SC_LEN, dtype=torch.int32, device=dev)
    for i, v in enumerate(head):
        if v:
            sc[i].fill_(v)
    return sc


def grow_tree_partition(arena: Arena, grad: torch.Tensor, hess: torch.Tensor,
                        feature_mask: torch.Tensor, num_bins: torch.Tensor,
                        default_bins: torch.Tensor,
                        missing_types: torch.Tensor, params: SplitParams,
                        monotone: Optional[torch.Tensor] = None,
                        penalty: Optional[torch.Tensor] = None,
                        is_categorical: Optional[torch.Tensor] = None,
                        bundle: Optional[BundleMaps] = None, *,
                        max_leaves: int, max_depth: int = -1, max_bin: int,
                        max_cat_threshold: int = 32,
                        emit: str = "leaf_ids",
                        quant_scales: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                        carried_root: Optional[int] = None,
                        carried_bump0: int = 0,
                        carry_dst: Optional[int] = None,
                        in_bag: Optional[torch.Tensor] = None,
                        score: Optional[torch.Tensor] = None,
                        shrinkage: Optional[torch.Tensor] = None,
                        pvec: Optional[torch.Tensor] = None,
                        cegb_coupled: Optional[torch.Tensor] = None,
                        cegb_used: Optional[torch.Tensor] = None,
                        forced_splits: tuple = (), hist_slots: int = 0,
                        pool_misses: Optional[torch.Tensor] = None):
    """Grow one leaf-wise tree on the arena's rows.

    grad and hess [n] are f32 for an f32 arena; for a quantized arena they
    are the int8 codes and quant_scales their (g_scale, h_scale).  They are
    in the order of the root segment: row order for the pristine root,
    the block's order for a carried root at column `carried_root`.

    in_bag (uint8 [n], 1 for the rows in the bag) grows the tree on the
    bagged rows only: the root pass (K3 in pred mode) compacts them to
    `work0`, dumps the others past them, and builds the root histogram in
    the same pass; the root count stays on the device.

    emit="score" needs every row in a live leaf (no in_bag): K4 adds each
    row's leaf value times the value of `shrinkage` (a one-value f32
    device tensor read when K4 runs) into `score` (f32 [n], row order) in
    place, rounded as `score += delta * shrink` would round it.  emit="segments" returns the leaves' segments instead, for
    the caller's own K4 pass over the arena as the tree left it.

    pvec is the split parameters as K1 takes them
    (split_kernel.params_vector of params); without it the grower builds
    it, a copy from the host that a captured grower must not make.

    cegb_coupled [F] f32 and cegb_used [F] bool (updated in place) charge
    the coupled CEGB penalties; forced_splits is the static plan of
    (leaf, inner feature, threshold bin, default left) entries;
    hist_slots > 0 bounds the histogram cache at max(min(hist_slots, L),
    4) slots (0: one a leaf); pool_misses (int64 [1], pooled only) gains
    one for each split whose parent had no slot and was recomputed.

    Returns (TreeArrays on the arena's device, out, truncated): out is
    `score` (emit="score"), each row's leaf id in row order (emit=
    "leaf_ids", int32 [n], -1 for rows out of the bag) or the leaves'
    (start, count) arena segments (emit="segments", int32 [L, 2], live
    below the tree's num_leaves); truncated is a 0-d bool tensor, True
    when the arena ran out of room."""
    dev = arena.device
    n, G = arena.num_data, arena.num_groups
    F = num_bins.shape[0]
    if bundle is None and F != G:
        raise ValueError("the arena has %d columns for %d features without "
                         "a bundle" % (G, F))
    if n >= (1 << 24):
        raise ValueError("partition engine supports n < 2^24 rows")
    if emit not in ("score", "leaf_ids", "segments"):
        raise ValueError("emit must be 'score', 'leaf_ids' or 'segments', "
                         "got %r" % emit)
    if emit == "segments" and in_bag is not None:
        raise ValueError("emit='segments' needs every row in a live leaf")
    if emit == "score" and (score is None or shrinkage is None
                            or in_bag is not None):
        raise ValueError("emit='score' adds into a score with a shrinkage, "
                         "every row in the bag")
    if arena.quantized != (quant_scales is not None):
        raise ValueError("a quantized arena takes quant_scales, an f32 arena "
                         "none")
    L, B = max_leaves, max_bin
    f32, i64 = torch.float32, torch.long
    K = max(min(hist_slots, L), 4) if hist_slots > 0 else L
    pooled = K < L
    if forced_splits and pooled:
        raise ValueError("forced splits need the dense histogram cache "
                         "(hist_slots=0): the injection indexes it by leaf")
    W = B if is_categorical is not None else 0
    work0 = pristine_work0(n)
    cap = arena.cap
    if in_bag is not None:
        if carried_root is not None:
            raise ValueError("a carried root holds every row: no in_bag")
        # grow_partition.py:269-285: in-bag rows to the work region (the
        # first split then rewrites them in place), the out-of-bag dump
        # past them, the bump region past both
        root_s0 = work0
        oob_dst = work0 + _align(n, TILE)
        cursor0 = oob_dst + _align(n, TILE)
    elif carried_root is None:
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
    # K5 writes the codes while it builds the root histogram; bagged, the
    # payload goes to the pristine block in row order and K3 in pred mode
    # moves the rows and histograms the bag in one pass
    if in_bag is not None:
        arena.payload[0, :n] = grad
        arena.payload[1, :n] = hess
        sc0 = _sc_vector((0, n, root_s0, oob_dst), dev)
        root_hist = partition_segment_pred(arena, sc0, in_bag, hist_stream=0,
                                           max_bin=B)
        if arena.quantized:
            root_hist = dequantize_hist(root_hist, g_scale, h_scale)
        root_cnt = sc0[SC_CNT_A:SC_CNT_A + 1]
    else:
        root_cnt = torch.full((1,), n, dtype=torch.int32, device=dev)
        sc0 = _sc_vector((root_s0, n), dev)
        if arena.quantized:
            root_hist = dequantize_hist(
                fused_refresh_histogram(arena, torch.stack([grad, hess]),
                                        sc0[0:2], B), g_scale, h_scale)
        else:
            arena.payload[0, root_s0:root_s0 + n] = grad
            arena.payload[1, root_s0:root_s0 + n] = hess
            root_hist = seg_hist(sc0[0:2])
    root_cnt_f = root_cnt.to(f32)
    root_g = root_hist[0, :, 0].sum()
    root_h = root_hist[0, :, 1].sum()
    fvec1 = build_feature_statics(num_bins, default_bins, missing_types,
                                  monotone=monotone, penalty=penalty,
                                  feature_mask=feature_mask, children=1)
    fvec2 = fvec1.repeat(2, 1)
    if pvec is None:
        pvec = params_vector(params, dev)

    used = None if cegb_coupled is None else cegb_used.clone()

    def scan(hists, svec, used_now):
        """Split rows [CH, ROW_W] and left-going bins [CH, W] (or None) of
        CH children: group hists [CH, G, B, 3], svec K1's child vector
        [CH, 8] (g, h, count, min, max); used_now the CEGB used vector of
        their scans."""
        hists = unbundle_hist(hists, svec[:, 0], svec[:, 1], svec[:, 2],
                              bundle, default_bins)
        CH = len(hists)
        if is_categorical is None:
            fv = fvec2 if CH == 2 else fvec1
            if used_now is not None:
                fv = cegb_statics(fv, cegb_coupled, used_now, CH)
            return split_scan(hists, fv, svec, pvec)[1], None
        pen = (None if used_now is None else
               torch.where(used_now, torch.zeros((), device=dev),
                           cegb_coupled.to(f32)))
        rows, _, cats = scan_rows(
            hists, svec[:, :2], svec[:, 2].long(), svec[:, 3], svec[:, 4],
            num_bins, default_bins, missing_types, params, monotone,
            penalty, feature_mask, is_categorical, max_cat_threshold, pen)
        return rows, cats

    root_rows, root_cat = scan(root_hist.unsqueeze(0),
                               child_vector(root_g.view(1), root_h.view(1),
                                            root_cnt_f), used)
    split_cache = no_split_row(dev).repeat(L, 1)
    split_cache[0] = root_rows[0]
    cat_cache = torch.zeros((L, W), dtype=torch.bool, device=dev)
    if W:
        cat_cache[0] = root_cat[0]
    leaf_mat, node_mat = new_tables(L, dev)
    node_cat = torch.zeros((node_mat.shape[0], W), dtype=torch.bool,
                           device=dev)
    leaf_mat[0, _LC] = root_cnt_f[0]
    leaf_seg = torch.zeros((L, 2), dtype=torch.int32, device=dev)
    leaf_seg[0, 0].fill_(root_s0)
    leaf_seg[0, 1] = root_cnt[0]
    hist_cache = torch.zeros((K,) + tuple(root_hist.shape), dtype=f32,
                             device=dev)
    hist_cache[0] = root_hist
    if pooled:
        # slot -> leaf (-1 free) and write recency (grow_partition.py:
        # 585-590); the root holds slot 0
        slot_leaf = torch.full((K,), -1, dtype=i64, device=dev)
        slot_leaf[0].fill_(0)
        slot_tick = torch.zeros(K, dtype=i64, device=dev)
        slot_tick[0].fill_(1)
        tick = torch.full((1,), 2, dtype=i64, device=dev)

    nl = torch.ones(1, dtype=i64, device=dev)
    cursor = torch.full((1,), cursor0, dtype=i64, device=dev)
    truncated = torch.zeros((), dtype=torch.bool, device=dev)
    fstat = torch.stack([missing_types, default_bins, num_bins - 1],
                        dim=1).to(device=dev, dtype=i64)
    mono = None if monotone is None else monotone.to(device=dev, dtype=i64)
    zl = torch.zeros((), dtype=i64, device=dev)
    zf = torch.zeros((), dtype=f32, device=dev)
    # after forced splits the best-first steps may reach L leaves early
    capped = bool(forced_splits)

    def step():
        """One split of the best leaf (grow_partition.py:620-843); a step
        that cannot split (no positive gain, no room, no leaf left) runs
        K3 and K2 over no rows and masks every write back."""
        nonlocal nl, cursor, truncated, used, tick
        bi = torch.argmax(split_cache[:, _OG]).view(1)
        row = split_cache.index_select(0, bi)[0]
        gain = row[_OG]
        feat = row[_OF].long().clamp_min(0).view(1)
        lg, lh, lc_f = row[_OLG], row[_OLH], row[_OLC]
        rg, rh, rc_f = row[_ORG], row[_ORH], row[_ORC]
        lc_i, rc_i = lc_f.long(), rc_f.long()
        seg = leaf_seg.index_select(0, bi)[0].long()
        s0 = seg[0]
        left_smaller = lc_i <= rc_i
        # bump-allocator overflow: the split does not apply and growth stops
        need = _align(torch.minimum(lc_i, rc_i), ALLOC)
        no_split = gain <= NEG_GATE
        if capped:
            no_split = no_split | (nl[0] >= L)
        overflow = (~no_split) & (cursor[0] + need + TILE > cap)
        keep = no_split | overflow
        nl_w = nl.clamp_max(L - 1) if capped else nl
        dst_a = torch.where(s0 < work0, work0, s0)
        dst_b = cursor[0]

        if pooled:
            # the parent's slot (HistogramPool::Get), or its histogram
            # recomputed by K2 from its segment before K3 overwrites it
            in_slot = slot_leaf == bi
            found = in_slot.any()
            pslot = torch.argmax(in_slot.to(torch.int32)).view(1)
            rseg = torch.stack([s0, torch.where(found | keep, zl, seg[1])]
                               ).to(torch.int32)
            recomputed = seg_hist(rseg)
            if pool_misses is not None:
                pool_misses.add_((~found & ~keep).long())

        # the go-left mask over the column's bin values: threshold and
        # missing direction, bin set, bundle range (ops/grow.decision_table);
        # stream A is the larger child, so the kernel XORs the decision
        # with left_smaller
        cat_row = cat_cache.index_select(0, bi)[0] if W else None
        is_cat = (None if is_categorical is None
                  else is_categorical.index_select(0, feat)[0])
        chan, go_left = decision_table(feat, row, fstat, bundle,
                                       is_categorical, cat_row)
        sc = torch.stack([s0, torch.where(keep, zl, seg[1]), dst_a, dst_b,
                          zl, zl, chan[0], left_smaller.long()]
                         ).to(torch.int32)
        partition_segment(arena, sc, go_left.to(torch.uint8))
        small_hist = seg_hist(sc[SC_DST_B:SC_DST_B + 2])
        cnt_b, cnt_a = sc[SC_CNT_B].long(), sc[SC_CNT_A].long()

        if pooled:
            parent_hist = torch.where(
                found, hist_cache.index_select(0, pslot)[0], recomputed)
        else:
            parent_hist = hist_cache.index_select(0, bi)[0]
        large_hist = parent_hist - small_hist
        left_hist = torch.where(left_smaller, small_hist, large_hist)
        right_hist = torch.where(left_smaller, large_hist, small_hist)
        if pooled:
            # both children stored: the left in the parent's slot if it
            # had one, the right in the least recently written slot
            # (HistogramPool::Move and LRU)
            slot_l = torch.where(found, pslot,
                                 torch.argmin(slot_tick).view(1))
            tick_l = slot_tick.index_copy(0, slot_l, tick)
            slot_r = torch.argmin(tick_l).view(1)
            put(hist_cache, slot_l, left_hist, keep)
            put(hist_cache, slot_r, right_hist, keep)
            put(slot_leaf, slot_l, bi[0], keep)
            put(slot_leaf, slot_r, nl_w[0], keep)
            slot_tick.copy_(torch.where(
                keep, slot_tick, tick_l.index_copy(0, slot_r, tick + 1)))
            tick = torch.where(keep, tick, tick + 2)
        else:
            put(hist_cache, bi, left_hist, keep)
            put(hist_cache, nl_w, right_hist, keep)

        start_l = torch.where(left_smaller, dst_b, dst_a)
        start_r = torch.where(left_smaller, dst_a, dst_b)
        local_l = torch.where(left_smaller, cnt_b, cnt_a)
        local_r = torch.where(left_smaller, cnt_a, cnt_b)
        put(leaf_seg, bi, torch.stack([start_l, local_l]).to(torch.int32),
            keep)
        put(leaf_seg, nl_w, torch.stack([start_r, local_r]).to(torch.int32),
            keep)

        if W:
            put(node_cat, nl_w - 1, cat_row, keep)
        depth, min_l, max_l, min_r, max_r = record_split(
            node_mat, leaf_mat, bi, nl_w, row, feat,
            fstat[:, 0].index_select(0, feat)[0], keep, mono, is_cat)

        # one scan launch for both children, cross-feature select included
        used2 = None if used is None else used.index_fill(0, feat, True)
        svec2 = torch.stack([torch.stack([lg, lh, lc_f, min_l, max_l, zf, zf,
                                          zf]),
                             torch.stack([rg, rh, rc_f, min_r, max_r, zf, zf,
                                          zf])])
        rows2, cats2 = scan(torch.stack([left_hist, right_hist]), svec2,
                            used2)
        rows2 = mask_depth(rows2, depth, max_depth)
        put(split_cache, bi, rows2[0], keep)
        put(split_cache, nl_w, rows2[1], keep)
        if W:
            put(cat_cache, bi, cats2[0], keep)
            put(cat_cache, nl_w, cats2[1], keep)

        if used is not None:
            used = torch.where(keep, used, used2)
        cursor = torch.where(keep, cursor, dst_b + _align(cnt_b, ALLOC))
        nl = torch.where(keep, nl, nl + 1)
        truncated = truncated | overflow

    if forced_splits:
        # grow_partition.py:876-915: an entry that cannot apply has every
        # gain of its injected cache masked, so its step splits nothing;
        # the cache is restored unless the split applied (it may also stop
        # on the arena's room), and its subtree is then abandoned
        leafmap = torch.full((len(forced_splits) + 1,), -1, dtype=i64,
                             device=dev)
        leafmap[0].fill_(0)
        lane = torch.arange(split_cache.shape[1], device=dev)
        for i, entry in enumerate(forced_splits):
            if i >= L - 1:
                break
            dyn_leaf = leafmap[entry[0]].clone()
            safe = dyn_leaf.clamp_min(0).view(1)
            leaf_cnt = leaf_mat[:, _LC].long()
            frow, _ = forced_row(hist_cache, leaf_cnt, safe, entry, bundle,
                                 num_bins, default_bins, missing_types,
                                 params)
            pre_valid = (dyn_leaf >= 0) & (frow[_OG] > NEG_GATE) & (nl[0] < L)
            saved = (split_cache.clone(), cat_cache.clone())
            split_cache.index_copy_(0, safe, frow.view(1, -1))
            split_cache.copy_(torch.where((lane == _OG) & ~pre_valid, NEG,
                                          split_cache))
            if W:
                cat_cache.index_fill_(0, safe, False)
            prev = nl[0].clone()
            step()
            applied = nl[0] == prev + 1
            for cache, old in zip((split_cache, cat_cache), saved):
                cache.copy_(torch.where(applied, cache, old))
            leafmap[i + 1] = torch.where(applied, prev, -1)
            leafmap[entry[0]] = torch.where(applied, dyn_leaf, -1)

    for _ in range(L - 1):
        step()

    if cegb_used is not None and used is not None:
        cegb_used.copy_(used)
    tree = tree_from_tables(node_mat, leaf_mat, nl, node_cat if W else None)

    # per-row outputs from the final segments (K4): the shrunk leaf values
    # added into the caller's score, or the leaf ids
    nl32 = nl.to(torch.int32)
    if emit == "segments":
        out = leaf_seg
    elif emit == "score":
        out = score
        scatter_segments(arena, leaf_seg, tree.leaf_value, nl32, out,
                         shrink=shrinkage)
    else:
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
        scatter_segments(arena, leaf_seg,
                         torch.arange(L, dtype=torch.int32, device=dev), nl32,
                         out)
    if carry_dst is not None:
        compact_carry(arena, leaf_seg, nl32, int(carry_dst))
    return tree, out, truncated
