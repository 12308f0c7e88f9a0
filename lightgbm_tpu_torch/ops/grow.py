"""Tree arrays shared by the grower and the model, and the binned tree walk.

Port of the `TreeArrays` record, the `MISSING_*` constants,
`pack_tree_arrays` / `unpack_tree_vectors` and `predict_leaf_inner` of
lightgbm_tpu/ops/grow.py (:34-36, :109-133, :690-746, :856-901).  The walk
is plain tensor code, as it is plain `jnp` in JAX: no kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


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
    cat_mask: object          # bool  [N, W] left-going bins; W=0 here

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
    floats as f32), so one host fetch replaces one per field."""
    ints, floats = [], []
    for name, x in zip(TreeArrays._fields, t):
        if name in _TREE_FLOAT_FIELDS:
            floats.append(x.reshape(-1).to(torch.float32))
        else:
            ints.append(x.reshape(-1).to(torch.int32))
    return torch.cat(ints), torch.cat(floats)


def predict_leaf_inner(bins: torch.Tensor, tree: TreeArrays,
                       num_bins: torch.Tensor, default_bins: torch.Tensor,
                       depth: int) -> torch.Tensor:
    """Leaf index (int32 [n]) per row by walking the tree over the inner
    bins [n, F] (Tree::GetLeafAt + DecisionInner, tree.h:233-248, 289-296),
    as lightgbm_tpu/ops/grow.py:856-901 does.

    Vectorized node walk: every row holds a current node (>= 0 internal,
    negative = ~leaf), routed by threshold and missing type (zero: the
    feature's default bin; NaN: its last bin) as the grower decides.  The
    JAX loop tests `any(node >= 0)` each level; here that test would be a
    host sync per level, so the caller passes the tree's depth (its largest
    leaf depth, which the one fetch per tree brings) and the walk runs
    exactly that many levels with no sync.  Categorical nodes and EFB
    bundles are not ported."""
    if tree.cat_mask.shape[1] > 0:
        raise NotImplementedError(
            "categorical splits are not ported yet (ROADMAP.md queue 1, "
            "item 11)")
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
    for _ in range(depth):
        nd = node.clamp_min(0)
        feat = feat_all[nd]
        col = bins.gather(1, feat[:, None])[:, 0].long()
        mt = mt_all[nd]
        is_missing = (((mt == MISSING_ZERO) & (col == db_all[feat]))
                      | ((mt == MISSING_NAN) & (col == mb_all[feat])))
        go_left = torch.where(is_missing, tree.default_left[nd],
                              col <= thr[nd])
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
