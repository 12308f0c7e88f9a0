"""The label engine, the tree tables both growers keep, and the tree walk.

Port of lightgbm_tpu/ops/grow.py: the `TreeArrays` record, the `MISSING_*`
constants, the EFB maps `BundleMaps` with `unbundle_hist` and
`feature_bin_of` (:40-49, :72-106), `pack_tree_arrays` /
`unpack_tree_vectors`, `predict_leaf_inner` (:34-36, :109-133, :690-746,
:856-901) and the serial branch of `grow_tree_impl` (:178-687) as
`grow_tree_label`, the label engine: rows keep a leaf id, a split relabels the rows of its leaf,
the smaller child is histogrammed by a masked pass over every row (K7,
ops/histogram.py) and its sibling by subtraction.  The tree tables and the
per-split bookkeeping (Tree::Split, the monotone bounds, the depth limit)
are shared with the partition engine (ops/grow_partition.py), as JAX
shares them between its two engines.  The walk is plain tensor code, as it
is plain `jnp` in JAX; on the card KP2 (ops/predict_kernel.walk_binned)
walks instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io.dataset import bin_values
from . import histogram as hist_ops
from . import histogram_kernel
from .split import (K_MIN_SCORE, SplitParams, best_split_per_feature,
                    best_split_per_feature_mixed, forced_split_result,
                    select_best_feature)
from .split_kernel import (_OF, _OG, _OLC, _OLG, _OLH, _OLO, _ODL, _ORC, _ORG,
                           _ORH, _ORO, _OT, NEG, NEG_GATE,
                           build_feature_statics, cegb_statics, child_vector,
                           no_split_row, params_vector, split_scan)

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class BundleMaps(NamedTuple):
    """The EFB layout on the device (io/efb.py BundleInfo): the bin matrix
    holds [n, G] group columns, and scans and splits address features
    through these maps (lightgbm_tpu/ops/grow.py:40-49)."""
    unbundle_idx: torch.Tensor  # [F, B] int64 into flat [G*B] (+1 sentinel)
    feat_col: torch.Tensor      # [F] int32 group column of each feature
    feat_lo: torch.Tensor       # [F] int32 group-bin range of the feature's
    feat_hi: torch.Tensor       #          mapped (non-default) bins
    feat_shift: torch.Tensor    # [F] int32 group_bin = feature_bin + shift
    needs_fix: torch.Tensor     # [F] bool default bin reconstructed at scan


def unbundle_hist(hist, sum_g, sum_h, cnt, bundle: Optional[BundleMaps],
                  default_bins):
    """[G, B, 3] group histogram -> [F, B, 3] per-feature view
    (lightgbm_tpu/ops/grow.py:72-92), or [C, G, B, 3] -> [C, F, B, 3] with
    the C leaves' sums and counts [C]: each feature's non-default bins are
    a gather from its group's bins; a bundled feature's default bin is the
    leaf's totals less the gathered sums (Dataset::FixHistogram,
    dataset.cpp:928-949).  The identity without EFB."""
    if bundle is None:
        return hist
    lead = hist.shape[:-3]
    G, B = hist.shape[-3:-1]
    F = bundle.feat_col.shape[0]
    dev, dtype = hist.device, hist.dtype
    flat = hist.reshape(-1, G * B, 3)
    C = flat.shape[0]
    flat = torch.cat([flat, torch.zeros((C, 1, 3), dtype=dtype, device=dev)],
                     dim=1)
    hf = flat[:, bundle.unbundle_idx]                   # [C, F, B, 3]
    tot = torch.stack([torch.as_tensor(v, device=dev).to(dtype).reshape(C)
                       for v in (sum_g, sum_h, cnt)], dim=-1)  # [C, 3]
    fix = tot[:, None, :] - hf.sum(dim=2)               # [C, F, 3]
    upd = torch.where(bundle.needs_fix[:, None], fix,
                      torch.zeros((), dtype=dtype, device=dev))
    cc = torch.arange(C, device=dev)[:, None]
    ar = torch.arange(F, device=dev)[None, :]
    db = default_bins.long()[None, :]
    hf = hf.index_put((cc, ar, db), hf[cc, ar, db] + upd)
    return hf.reshape(lead + (F, B, 3))


def feature_bin_of(cols, feat, default_bins, bundle: Optional[BundleMaps]):
    """Feature-bin values (int64) of feature(s) `feat` from their group
    columns' bin values `cols`: the identity without EFB; otherwise values
    outside the feature's range decode to its default bin
    (lightgbm_tpu/ops/grow.py:95-106).  cols may be device bins (uint8,
    or int16 holding uint16 bins: io/dataset.bin_values)."""
    cols = bin_values(cols)
    if bundle is None:
        return cols
    inside = ((cols >= bundle.feat_lo[feat])
              & (cols < bundle.feat_hi[feat]))
    return torch.where(inside, cols - bundle.feat_shift[feat],
                       default_bins[feat].long())


class TreeArrays(NamedTuple):
    """SoA tree storage (tree.h:318-374).  Node arrays sized [max_leaves-1],
    leaf arrays [max_leaves]; children encode leaves as ~leaf_index.  Fields
    are torch tensors on the grower's device, or numpy arrays on the host
    after `unpack_tree_vectors`."""
    split_feature: object     # int32 [N] inner feature index
    threshold_bin: object     # int32 [N]
    default_left: object      # bool  [N]
    missing_type: object      # int32 [N]
    left_child: object        # int32 [N]
    right_child: object       # int32 [N]
    split_gain: object        # f32   [N]
    internal_value: object    # f32   [N] output the node would have as leaf
    internal_count: object    # int32 [N]
    leaf_value: object        # f32   [L]
    leaf_count: object        # int32 [L]
    leaf_parent: object       # int32 [L]
    leaf_depth: object        # int32 [L]
    num_leaves: object        # int32 scalar
    is_cat: object            # bool  [N] categorical decision node
    cat_mask: object          # bool  [N, W] left-going bins; W=0 when the
    #                           dataset has no categorical feature

    @property
    def max_leaves(self) -> int:
        return self.leaf_value.shape[0]


_TREE_FLOAT_FIELDS = ("split_gain", "internal_value", "leaf_value")


def _tree_field_spec(max_leaves: int, cat_bins: int):
    n = max(max_leaves - 1, 1)
    L = max_leaves
    return [("split_feature", (n,), np.int32),
            ("threshold_bin", (n,), np.int32),
            ("default_left", (n,), bool),
            ("missing_type", (n,), np.int32),
            ("left_child", (n,), np.int32),
            ("right_child", (n,), np.int32),
            ("split_gain", (n,), None),
            ("internal_value", (n,), None),
            ("internal_count", (n,), np.int32),
            ("leaf_value", (L,), None),
            ("leaf_count", (L,), np.int32),
            ("leaf_parent", (L,), np.int32),
            ("leaf_depth", (L,), np.int32),
            ("num_leaves", (), np.int32),
            ("is_cat", (n,), bool),
            ("cat_mask", (n, cat_bins), bool)]


def pack_tree_arrays(t: TreeArrays):
    """Flatten a device TreeArrays into two device vectors (ints as int32,
    floats in their own type: f32, or f64 on the label engine's f64 path),
    so one host fetch replaces one per field."""
    ints, floats = [], []
    for name, x in zip(TreeArrays._fields, t):
        if name in _TREE_FLOAT_FIELDS:
            floats.append(x.reshape(-1))
        else:
            ints.append(x.reshape(-1).to(torch.int32))
    return torch.cat(ints), torch.cat(floats)


def pack_tree_vector(t: TreeArrays, truncated: torch.Tensor) -> torch.Tensor:
    """One f64 device vector of a tree for one host fetch: pack_tree_arrays'
    ints, the arena-truncation flag (a 0-d bool), then its floats (ints and
    f32 are exact in f64)."""
    ivec, fvec = pack_tree_arrays(t)
    return torch.cat([ivec.double(), truncated.to(torch.float64).view(1),
                      fvec.double()])


def unpack_tree_vector(vec: np.ndarray, max_leaves: int, cat_bins: int = 0,
                       float_dtype=np.float32):
    """Host-side inverse of pack_tree_vector: (TreeArrays of numpy arrays,
    truncated); cat_bins is the width of the tree's cat_mask, float_dtype
    the type the tree's floats were grown in."""
    ni = sum(int(np.prod(shape)) if shape else 1
             for name, shape, _ in _tree_field_spec(max_leaves, cat_bins)
             if name not in _TREE_FLOAT_FIELDS)
    arrays = unpack_tree_vectors(vec[:ni], vec[ni + 1:].astype(float_dtype),
                                 max_leaves, cat_bins)
    return arrays, bool(vec[ni])


def predict_leaf_inner(bins: torch.Tensor, tree: TreeArrays,
                       num_bins: torch.Tensor, default_bins: torch.Tensor,
                       bundle: Optional[BundleMaps] = None) -> torch.Tensor:
    """Leaf index (int32 [n]) per row by walking the tree over the inner
    bins [n, F] (Tree::GetLeafAt + DecisionInner, tree.h:233-248, 289-296),
    as lightgbm_tpu/ops/grow.py:856-901 does: KP2's plain version
    (ops/predict_kernel.walk_binned).

    Vectorized node walk: every row holds a current node (>= 0 internal,
    negative = ~leaf), routed by threshold and missing type (zero: the
    feature's default bin; NaN: its last bin) as the grower decides,
    level by level until every row rests at a leaf, as JAX's while_loop
    does.  A categorical node sends a row left when its bin is in the
    node's cat_mask (CategoricalDecision, tree.h:259-273), whatever the
    missing type; with `bundle` the bins are group columns, decoded to the
    node's feature bin.  The test of the loop is a host read a level,
    which costs nothing on the CPU; on the card the kernel walks each row
    to its leaf instead."""
    n = bins.shape[0]
    dev = bins.device
    # a single-leaf tree starts every row at ~0, leaf 0
    start = torch.where(torch.as_tensor(tree.num_leaves, device=dev) > 1,
                        0, ~0).to(torch.int64)
    node = start.expand(n).clone()
    feat_all = tree.split_feature.long()
    thr = tree.threshold_bin.long()
    mt_all = tree.missing_type.long()
    left, right = tree.left_child.long(), tree.right_child.long()
    db_all = default_bins.long()
    mb_all = num_bins.long() - 1
    W = tree.cat_mask.shape[1]
    while bool((node >= 0).any()):
        nd = node.clamp_min(0)
        feat = feat_all[nd]
        gcol = feat if bundle is None else bundle.feat_col.long()[feat]
        col = feature_bin_of(bins.gather(1, gcol[:, None])[:, 0], feat,
                             default_bins, bundle)
        mt = mt_all[nd]
        is_missing = (((mt == MISSING_ZERO) & (col == db_all[feat]))
                      | ((mt == MISSING_NAN) & (col == mb_all[feat])))
        go_left = torch.where(is_missing, tree.default_left[nd],
                              col <= thr[nd])
        if W > 0:
            in_set = tree.cat_mask[nd, col.clamp(0, W - 1)]
            go_left = torch.where(tree.is_cat[nd], in_set, go_left)
        nxt = torch.where(go_left, left[nd], right[nd])
        node = torch.where(node >= 0, nxt, node)
    return (~node).to(torch.int32)


def unpack_tree_vectors(ivec, fvec, max_leaves: int,
                        cat_bins: int) -> TreeArrays:
    """Host-side inverse of pack_tree_arrays (numpy in, numpy out)."""
    out, ioff, foff = {}, 0, 0
    for name, shape, dtype in _tree_field_spec(max_leaves, cat_bins):
        size = int(np.prod(shape)) if shape else 1
        if name in _TREE_FLOAT_FIELDS:
            out[name] = np.asarray(fvec[foff:foff + size]).reshape(shape)
            foff += size
        else:
            out[name] = (np.asarray(ivec[ioff:ioff + size]).reshape(shape)
                         .astype(dtype))
            ioff += size
    return TreeArrays(**out)


# --------------------------------------------------------------------------- #
# The growers' device tables (both engines)
# --------------------------------------------------------------------------- #
# leaf table lanes
_LV, _LC, _LP, _LD, _LMIN, _LMAX = range(6)
# node table lanes
(_NF, _NT, _NDL, _NMT, _NLEFT, _NRIGHT, _NGAIN, _NVAL, _NCNT,
 _NCAT) = range(10)


def put(table: torch.Tensor, idx: torch.Tensor, new: torch.Tensor,
        keep: torch.Tensor) -> None:
    """table[idx] = new unless keep (a 0-d bool on the device)."""
    old = table.index_select(0, idx)
    table.index_copy_(0, idx, torch.where(keep, old, new.unsqueeze(0)))


def new_tables(max_leaves: int, device, dtype=torch.float32):
    """The leaf table [L, 6] (value, count, parent, depth, output bounds)
    and node table [L-1, 10] of an empty tree, f32 (f64 on the label
    engine's f64 path)."""
    f32 = dtype
    leaf_mat = torch.zeros((max_leaves, 6), dtype=f32, device=device)
    # fills on the device: an assignment of a Python number would copy it
    # from the host, which a captured grower must not
    leaf_mat[:, _LP].fill_(-1.0)
    leaf_mat[:, _LMIN].fill_(-torch.inf)
    leaf_mat[:, _LMAX].fill_(torch.inf)
    node_mat = torch.zeros((max(max_leaves - 1, 1), 10), dtype=f32,
                           device=device)
    return leaf_mat, node_mat


def record_split(node_mat, leaf_mat, bi, nl, row, feat, mtype, keep, mono,
                 is_cat=None):
    """Tree::Split (tree.h:393-423) of leaf bi into bi and the new leaf nl
    by the split row `row` (lanes _OG.._ORO): the parent's child pointer,
    one node row and two leaf rows, each write masked back when keep; and
    the children's output bounds by monotone mid-constraint propagation
    (serial_tree_learner.cpp:837-846), which a categorical split (is_cat,
    a 0-d bool) does not carry.  Returns (parent depth, min_l, max_l,
    min_r, max_r).  The tables' type is the row's."""
    f32 = leaf_mat.dtype
    lo, ro = row[_OLO], row[_ORO]
    lc_f, rc_f = row[_OLC], row[_ORC]
    lrow = leaf_mat.index_select(0, bi)[0]
    parent_of = lrow[_LP].long()
    depth = lrow[_LD]
    min_p, max_p = lrow[_LMIN], lrow[_LMAX]
    min_l = min_r = min_p
    max_l = max_r = max_p
    if mono is not None:
        mono_t = mono.index_select(0, feat)[0]
        if is_cat is not None:
            mono_t = torch.where(is_cat, 0, mono_t)
        mid = (lo + ro) / 2
        max_l = torch.where(mono_t > 0, mid, max_p)
        min_r = torch.where(mono_t > 0, mid, min_p)
        min_l = torch.where(mono_t < 0, mid, min_p)
        max_r = torch.where(mono_t < 0, mid, max_p)

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
    put(node_mat, safe_p, prow_new, keep)
    nrow = torch.stack([
        feat[0].to(f32), row[_OT].long().to(f32),
        (row[_ODL] > 0.5).to(f32), mtype.to(f32),
        -(bi[0] + 1).to(f32), -(nl[0] + 1).to(f32), row[_OG], lrow[_LV],
        lc_f + rc_f,
        torch.zeros((), dtype=f32, device=row.device) if is_cat is None
        else is_cat.to(f32)])
    put(node_mat, node, nrow, keep)
    put(leaf_mat, bi, torch.stack([lo, lc_f, node_f, depth + 1, min_l,
                                   max_l]), keep)
    put(leaf_mat, nl, torch.stack([ro, rc_f, node_f, depth + 1, min_r,
                                   max_r]), keep)
    return depth, min_l, max_l, min_r, max_r


def decision_table(feat, row, fstat, bundle: Optional[BundleMaps],
                   is_categorical: Optional[torch.Tensor] = None,
                   cat_row: Optional[torch.Tensor] = None,
                   values: int = 256):
    """(group column [1], go_left bool [values]): the go-left rule of a
    split row of feature `feat` ([1] int64) over the values of its
    column's bins (256 for uint8 bins, more for uint16 ones), as the JAX
    partition engine builds its mask
    (lightgbm_tpu/ops/grow_partition.py:706-733): numerical threshold and
    missing direction (NumericalDecision, tree.h:429-465), the bin set
    cat_row ([W] bool) of a categorical feature (CategoricalDecision,
    tree.h:259-273; bins past W go right), and with EFB the group's bins
    decoded to the feature's.  fstat: int64 [F, 3] of (missing type,
    default bin, last bin)."""
    dev = row.device
    bv = torch.arange(values, dtype=torch.long, device=dev)
    fs = fstat.index_select(0, feat)[0]
    if bundle is None:
        chan, fbin = feat, bv
    else:
        chan = bundle.feat_col.index_select(0, feat).long()
        lo, hi, shift = (t.index_select(0, feat)[0].long() for t in
                         (bundle.feat_lo, bundle.feat_hi, bundle.feat_shift))
        fbin = torch.where((bv >= lo) & (bv < hi), bv - shift, fs[1])
    is_missing = (((fs[0] == MISSING_ZERO) & (fbin == fs[1]))
                  | ((fs[0] == MISSING_NAN) & (fbin == fs[2])))
    go_left = torch.where(is_missing, row[_ODL] > 0.5,
                          fbin <= row[_OT].long())
    if is_categorical is not None:
        W = cat_row.shape[0]
        in_set = cat_row[fbin.clamp(0, W - 1)] & (fbin < W)
        go_left = torch.where(is_categorical.index_select(0, feat)[0],
                              in_set, go_left)
    return chan, go_left


def mask_depth(rows: torch.Tensor, depth: torch.Tensor,
               max_depth: int) -> torch.Tensor:
    """The children's split rows (children at depth+1) with no split past
    max_depth (grow.py:460-463)."""
    if max_depth <= 0:
        return rows
    depth_ok = (depth + 1) < max_depth
    lane = torch.arange(rows.shape[1], device=rows.device)
    rows = torch.where((lane == _OG) & ~depth_ok, NEG, rows)
    return torch.where((lane == _OF) & ~depth_ok, -1.0, rows)


def tree_from_tables(node_mat: torch.Tensor, leaf_mat: torch.Tensor,
                     nl: torch.Tensor,
                     node_cat: Optional[torch.Tensor] = None) -> TreeArrays:
    """The device TreeArrays of the tables after the last split; node_cat
    [N, W] bool the categorical nodes' left-going bins."""
    nm, lm = node_mat, leaf_mat
    return TreeArrays(
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
        cat_mask=(node_cat if node_cat is not None else
                  torch.zeros((nm.shape[0], 0), dtype=torch.bool,
                              device=nm.device)))


# --------------------------------------------------------------------------- #
# The label engine
# --------------------------------------------------------------------------- #
NO_LEAF = -2          # a leaf id no row holds: K7 then reads only the ids
# K1's counts ride f32 prefix sums, exact below this many rows
# (grow.py:343-347); from it on the scan keeps integer count cumsums
KERNEL_SCAN_ROWS = 1 << 24


def _split_row(res, f32=torch.float32):
    """A SplitResult of select_best_feature ([C] fields, or 0-d ones) as
    split-cache rows [C, ROW_W] in type f32 (gain NEG and feature -1
    where a leaf has no split; a forced split's gain +inf stays) and their
    int64 (left, right) counts [C, 2]."""
    has = res.feature >= 0
    row = torch.stack([
        torch.where(has, res.gain, NEG).to(f32), res.feature.to(f32),
        res.threshold.to(f32), res.default_left.to(f32),
        res.left_sum_gradient, res.left_sum_hessian, res.left_count.to(f32),
        res.left_output, res.right_sum_gradient, res.right_sum_hessian,
        res.right_count.to(f32), res.right_output], dim=-1).to(f32)
    return row, torch.stack([res.left_count, res.right_count], dim=-1).long()


def scan_rows(hists, sums, counts, minc, maxc, num_bins, default_bins,
              missing_types, params: SplitParams, monotone=None,
              penalty=None, feature_mask=None, is_categorical=None,
              max_cat_threshold: int = 32, cegb_feature_penalty=None):
    """The XLA route's scan of CH children at once (ops/split.py, as the
    JAX package scans categorical datasets, leaves past 2^24 rows and f64
    histograms): hists [CH, F, B, 3] per-feature histograms, sums [CH, 2]
    (g, h), counts [CH] int64, minc/maxc [CH] output bounds,
    cegb_feature_penalty [F] the coupled penalties still charged.
    Returns split rows [CH, ROW_W] in the histograms' type, int64 counts
    [CH, 2] and, with is_categorical, the left-going bins [CH, B] (else
    None)."""
    CH, F = hists.shape[:2]
    mn = mx = None
    if monotone is not None:
        mn, mx = minc[:, None].expand(CH, F), maxc[:, None].expand(CH, F)
    kw = dict(monotone=monotone, penalty=penalty, min_constraints=mn,
              max_constraints=mx, feature_mask=feature_mask,
              cegb_feature_penalty=cegb_feature_penalty)
    if is_categorical is None:
        pf = best_split_per_feature(
            hists, sums[:, 0], sums[:, 1], counts, num_bins, default_bins,
            missing_types, params, **kw)
    else:
        pf = best_split_per_feature_mixed(
            hists, sums[:, 0], sums[:, 1], counts, num_bins, default_bins,
            missing_types, is_categorical, params,
            max_cat_threshold=max_cat_threshold, **kw)
    res = select_best_feature(pf)
    rows, cnts = _split_row(res, hists.dtype)
    return rows, cnts, res.cat_mask


def forced_row(hist_cache, leaf_cnt, safe, plan_entry, bundle, num_bins,
               default_bins, missing_types, params: SplitParams,
               dtype=torch.float32):
    """The split-cache row ([ROW_W], type dtype) and int64 counts [2] of a
    forced split plan entry (leaf, feature, threshold bin, default left)
    on the leaf `safe` ([1] int64) of the dense histogram cache
    ([L, G, B, 3]) with counts leaf_cnt: the group histogram unbundled with
    the leaf's totals from its first group (lightgbm_tpu/ops/grow.py:52
    `build_forced_candidate`, shared by both engines)."""
    _, f_feat, f_thr, f_dl = plan_entry
    h = hist_cache.index_select(0, safe)[0]
    cnt = leaf_cnt.index_select(0, safe)[0]
    f_g, f_h = h[0, :, 0].sum(), h[0, :, 1].sum()
    fsp = forced_split_result(
        unbundle_hist(h, f_g, f_h, cnt, bundle, default_bins), f_feat, f_thr,
        f_g, f_h, cnt, num_bins, default_bins, missing_types, params, f_dl)
    return _split_row(fsp, dtype)


def grow_tree_label(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, row_leaf_init: torch.Tensor,
                    feature_mask: torch.Tensor, num_bins: torch.Tensor,
                    default_bins: torch.Tensor, missing_types: torch.Tensor,
                    params: SplitParams,
                    monotone: Optional[torch.Tensor] = None,
                    penalty: Optional[torch.Tensor] = None,
                    is_categorical: Optional[torch.Tensor] = None,
                    bundle: Optional[BundleMaps] = None, *,
                    max_leaves: int, max_depth: int = -1, max_bin: int,
                    hist_impl: str = "auto", max_cat_threshold: int = 32,
                    pvec: Optional[torch.Tensor] = None,
                    cegb_coupled: Optional[torch.Tensor] = None,
                    cegb_used: Optional[torch.Tensor] = None,
                    forced_splits: tuple = ()):
    """Grow one leaf-wise tree with the label engine; returns (TreeArrays
    on the bins' device, leaf_ids int32 [n]).

    bins [n, G] row-major (uint8, or int16 holding uint16 bins), a column
    a feature or, with `bundle`, a column an EFB group; grad, hess [n] f32,
    or f64 (`tpu_double_precision`: histograms, scans, split rows and the
    tree's floats then are f64, as JAX threads its dtype through,
    lightgbm_tpu/ops/grow.py:235); row_leaf_init int32 [n]: 0 for the rows
    in the bag, -1 for the others (which keep -1).  is_categorical: bool
    [F] where any feature is categorical, else None.

    The root histogram covers the rows with row_leaf_init == 0; each split
    relabels the rows of its leaf with ~go_left to the new leaf, histograms
    the smaller child with K7 over the G columns and takes the sibling by
    subtraction; group histograms are unbundled to the features before
    each scan.  The split scan follows grow.py:346-392: K1 (both children
    in one CH=2 launch) below KERNEL_SCAN_ROWS = 2^24 rows, where its f32
    prefix counts are exact, on an f32 dataset with no categorical
    feature; otherwise the XLA route's scan (ops/split.py, `scan_rows`)
    with integer count cumsums, the categorical scan where a feature is
    categorical.  That plain scan is the counterpart of JAX's code path for
    f64 (JAX's Pallas scan serves f32 only, grow.py:346), not a fallback.
    A categorical split keeps its left-going bins ([B] bool) beside its
    split row, and the tree's cat_mask is [N, B].

    CEGB (grow.py:160, :190-193, :365-367, :622): cegb_coupled [F] is the
    coupled penalty (cegb_tradeoff times cegb_penalty_feature_coupled), charged
    to a feature's gain while cegb_used [F] bool says it is unused; a
    split marks its feature used for its children's scans, and the
    booster's cegb_used is updated in place with the tree's features, so
    the vector lives across trees on the device.

    forced_splits: the static BFS plan of (leaf, inner feature, threshold
    bin, default left) entries (grow.py:641-685): before the best-first
    loop each entry injects a +inf-gain row for its leaf (`forced_row`)
    and one standard step applies it; an entry that cannot apply (an
    empty child, no leaf left, or its leaf abandoned) maps its new leaf to
    -1, so its subtree is dropped.

    As in grow_partition, the JAX while_loop is a Python loop of exactly
    max_leaves-1 steps whose state lives on the device: the best leaf is a
    device argmax over the split cache, the smaller child is picked on the
    device, and once no leaf has a split the `done` flag masks every later
    step back (K7 then histograms a leaf no row holds).  Leaf and node
    counts are kept as int64, exact past 2^24 rows.  With pvec (K1's
    vector of params, split_kernel.params_vector) nothing between the
    inputs and the outputs reads or copies a host value, so the grower can
    be captured into a CUDA graph (ops/graphs.py)."""
    n, G = bins.shape
    dev = bins.device
    F = num_bins.shape[0]
    if bundle is None and G != F:
        raise ValueError("bins has %d columns for %d features without a "
                         "bundle" % (G, F))
    L, B = max_leaves, max_bin
    dt = grad.dtype
    f32, i64, i32 = torch.float32, torch.long, torch.int32
    if dt not in (f32, torch.float64):
        raise TypeError("grad: dtype %s, expected float32 or float64" % dt)
    scan_kernel = (n < KERNEL_SCAN_ROWS and is_categorical is None
                   and dt == f32)
    W = B if is_categorical is not None else 0
    # the go-left table spans every value a column's bins may hold
    values = 256 if bins.dtype == torch.uint8 else max(B, 256)
    leaf_ids = row_leaf_init.to(device=dev, dtype=i32).contiguous()
    in_bag = leaf_ids == 0
    used = None if cegb_coupled is None else cegb_used.clone()

    # K7's row list, one per tree (the plain version on the CPU needs none)
    rows = (histogram_kernel.row_list(n, dev) if dev.type == "cuda"
            else None)
    root_hist = hist_ops.leaf_histogram(
        bins, grad, hess, leaf_ids,
        torch.zeros(1, dtype=i32, device=dev), B, hist_impl, rows)
    # grow.py:471-474: the root sums from the payload, the count an integer
    root_g = (grad * in_bag).sum()
    root_h = (hess * in_bag).sum()
    root_c = in_bag.sum()

    if pvec is None:
        pvec = params_vector(params, dev)
    fvec1 = build_feature_statics(num_bins, default_bins, missing_types,
                                  monotone=monotone, penalty=penalty,
                                  feature_mask=feature_mask, children=1)
    fvec2 = fvec1.repeat(2, 1)

    def scan(hists, sums, counts, minc, maxc, used_now):
        """Split rows [CH, ROW_W], int64 counts [CH, 2] and left-going bins
        [CH, W] (or None) of CH children: group hists [CH, G, B, 3], sums
        [CH] pairs (g, h), counts [CH] int64; used_now the CEGB used
        vector of their scans."""
        hists = unbundle_hist(hists, sums[:, 0], sums[:, 1], counts, bundle,
                              default_bins)
        if scan_kernel:
            CH = len(hists)
            fv = fvec2 if CH == 2 else fvec1
            if used_now is not None:
                fv = cegb_statics(fv, cegb_coupled, used_now, CH)
            svec = child_vector(sums[:, 0], sums[:, 1], counts.to(f32),
                                minc, maxc)
            rows = split_scan(hists, fv, svec, pvec)[1]
            # lanes by stacking: indexing by a list would copy the
            # index from the host
            return rows, torch.stack([rows[:, _OLC], rows[:, _ORC]],
                                     dim=1).long(), None
        pen = (None if used_now is None else
               torch.where(used_now, torch.zeros((), dtype=dt, device=dev),
                           cegb_coupled.to(dt)))
        return scan_rows(hists, sums, counts, minc, maxc, num_bins,
                         default_bins, missing_types, params, monotone,
                         penalty, feature_mask, is_categorical,
                         max_cat_threshold, pen)

    inf = torch.full((1,), torch.inf, dtype=dt, device=dev)
    root_row, root_cnt, root_cat = scan(
        root_hist.unsqueeze(0), torch.stack([root_g, root_h]).view(1, 2),
        root_c.view(1), -inf, inf, used)
    split_cache = no_split_row(dev, dt).repeat(L, 1)
    split_cache[0] = root_row[0]
    split_cnt = torch.zeros((L, 2), dtype=i64, device=dev)
    split_cnt[0] = root_cnt[0]
    cat_cache = torch.zeros((L, W), dtype=torch.bool, device=dev)
    leaf_mat, node_mat = new_tables(L, dev, dt)
    node_cat = torch.zeros((node_mat.shape[0], W), dtype=torch.bool,
                           device=dev)
    if W:
        cat_cache[0] = root_cat[0]
    leaf_mat[0, _LC] = root_c.to(dt)
    leaf_cnt = torch.zeros(L, dtype=i64, device=dev)
    leaf_cnt[0] = root_c
    node_cnt = torch.zeros(node_mat.shape[0], dtype=i64, device=dev)
    hist_cache = torch.zeros((L,) + tuple(root_hist.shape), dtype=dt,
                             device=dev)
    hist_cache[0] = root_hist

    nl = torch.ones(1, dtype=i64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    no_leaf = torch.full((1,), NO_LEAF, dtype=i32, device=dev)
    fstat = torch.stack([missing_types, default_bins, num_bins - 1],
                        dim=1).to(device=dev, dtype=i64)
    mono = None if monotone is None else monotone.to(device=dev, dtype=i64)
    # after forced splits the best-first steps may reach L leaves early
    capped = bool(forced_splits)

    def step(skip=None):
        """One split of the best leaf (grow.py:510-639), every write masked
        back once `done`; a forced step (skip given: its entry cannot
        apply) leaves `done` as it is."""
        nonlocal leaf_ids, nl, done, used
        bi = torch.argmax(split_cache[:, _OG]).view(1)
        row = split_cache.index_select(0, bi)[0]
        lc, rc = split_cnt.index_select(0, bi)[0]
        feat = row[_OF].long().clamp_min(0).view(1)
        if skip is None:
            done = done | (row[_OG] <= NEG_GATE)
            if capped:
                done = done | (nl[0] >= L)
            halt = done
        else:
            halt = skip
        nl_w = nl.clamp_max(L - 1) if capped else nl
        bi32, nl32 = bi.to(i32), nl_w.to(i32)
        cat_row = cat_cache.index_select(0, bi)[0] if W else None
        is_cat = (None if is_categorical is None
                  else is_categorical.index_select(0, feat)[0])

        # relabel (DataPartition::Split, data_partition.hpp:108): the rows
        # of leaf bi whose bin goes right move to the new leaf, by the
        # go-left rule over the values of the feature's column
        chan, go_left = decision_table(feat, row, fstat, bundle,
                                       is_categorical, cat_row, values)
        col = bin_values(bins.index_select(1, chan).view(-1))
        moves = ((~go_left).index_select(0, col)
                 & (leaf_ids == torch.where(halt, no_leaf, bi32)))
        leaf_ids = torch.where(moves, nl32, leaf_ids)

        # the smaller child by K7, its sibling by subtraction
        left_smaller = lc <= rc
        small = torch.where(halt, no_leaf,
                            torch.where(left_smaller, bi32, nl32))
        small_hist = hist_ops.leaf_histogram(bins, grad, hess, leaf_ids,
                                             small, B, hist_impl, rows)
        large_hist = hist_ops.subtract(hist_cache.index_select(0, bi)[0],
                                       small_hist)
        left_hist = torch.where(left_smaller, small_hist, large_hist)
        right_hist = torch.where(left_smaller, large_hist, small_hist)
        put(hist_cache, bi, left_hist, halt)
        put(hist_cache, nl_w, right_hist, halt)
        put(leaf_cnt, bi, lc, halt)
        put(leaf_cnt, nl_w, rc, halt)
        put(node_cnt, nl_w - 1, lc + rc, halt)
        if W:
            put(node_cat, nl_w - 1, cat_row, halt)

        depth, min_l, max_l, min_r, max_r = record_split(
            node_mat, leaf_mat, bi, nl_w, row, feat, fstat[:, 0].index_select(
                0, feat)[0], halt, mono, is_cat)

        used2 = None if used is None else used.index_fill(0, feat, True)
        sums = torch.stack([row[_OLG:_OLH + 1], row[_ORG:_ORH + 1]])
        rows2, cnts2, cats2 = scan(torch.stack([left_hist, right_hist]),
                                   sums, torch.stack([lc, rc]),
                                   torch.stack([min_l, min_r]),
                                   torch.stack([max_l, max_r]), used2)
        rows2 = mask_depth(rows2, depth, max_depth)
        put(split_cache, bi, rows2[0], halt)
        put(split_cache, nl_w, rows2[1], halt)
        put(split_cnt, bi, cnts2[0], halt)
        put(split_cnt, nl_w, cnts2[1], halt)
        if W:
            put(cat_cache, bi, cats2[0], halt)
            put(cat_cache, nl_w, cats2[1], halt)
        if used is not None:
            used = torch.where(halt, used, used2)
        nl = torch.where(halt, nl, nl + 1)

    if forced_splits:
        # static plan leaf -> dynamic leaf, -1 once abandoned (grow.py:652)
        leafmap = torch.full((len(forced_splits) + 1,), -1, dtype=i64,
                             device=dev)
        leafmap[0].fill_(0)
        for i, entry in enumerate(forced_splits):
            if i >= L - 1:
                break       # each applied entry adds one leaf
            dyn_leaf = leafmap[entry[0]].clone()
            safe = dyn_leaf.clamp_min(0).view(1)
            frow, fcnt = forced_row(hist_cache, leaf_cnt, safe, entry,
                                    bundle, num_bins, default_bins,
                                    missing_types, params, dt)
            valid = (dyn_leaf >= 0) & (frow[_OG] > NEG_GATE) & (nl[0] < L)
            saved = (split_cache.clone(), split_cnt.clone(),
                     cat_cache.clone())
            split_cache.index_copy_(0, safe, frow.view(1, -1))
            split_cnt.index_copy_(0, safe, fcnt.view(1, -1))
            if W:
                cat_cache.index_fill_(0, safe, False)
            dyn_new = nl[0].clone()
            step(skip=~valid)
            for cache, old in zip((split_cache, split_cnt, cat_cache),
                                  saved):
                cache.copy_(torch.where(valid, cache, old))
            leafmap[i + 1] = torch.where(valid, dyn_new, -1)
            # the only later entry on this static leaf is its left child's,
            # which an entry that failed abandons with the right subtree
            leafmap[entry[0]] = torch.where(valid, dyn_leaf, -1)

    for _ in range(L - 1):
        step()

    if cegb_used is not None and used is not None:
        cegb_used.copy_(used)
    tree = tree_from_tables(node_mat, leaf_mat, nl,
                            node_cat if W else None)._replace(
        leaf_count=leaf_cnt.to(i32), internal_count=node_cnt.to(i32))
    return tree, leaf_ids
