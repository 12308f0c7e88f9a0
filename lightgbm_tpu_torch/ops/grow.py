"""Tree arrays shared by the grower and the model.

Port of the `TreeArrays` record, the `MISSING_*` constants and
`pack_tree_arrays` / `unpack_tree_vectors` of lightgbm_tpu/ops/grow.py
(:34-36, :109-133, :690-746).
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
