"""Carry models across from the JAX package.

Both functions take plain data (numpy arrays, model text), so this module
needs nothing of the JAX package:

- `tree_arrays_from_numpy`: a `TreeArrays`-shaped dict of numpy arrays (as
  the JAX package's `fetch_tree_arrays` gives them) -> the port's
  TreeArrays of torch tensors on a device;
- `booster_from_model_string`: a JAX booster's `model_to_string()` text ->
  a port Booster, which predicts the same raw scores.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .basic import Booster
from .device import resolve_device
from .ops.grow import TreeArrays

_INT_FIELDS = ("split_feature", "threshold_bin", "missing_type", "left_child",
               "right_child", "internal_count", "leaf_count", "leaf_parent",
               "leaf_depth", "num_leaves")
_BOOL_FIELDS = ("default_left", "is_cat", "cat_mask")


def tree_arrays_from_numpy(arrays: Dict[str, np.ndarray],
                           device=None) -> TreeArrays:
    """The port's TreeArrays on `device` from numpy arrays keyed by the
    TreeArrays field names."""
    dev = resolve_device(device)
    out = {}
    for name in TreeArrays._fields:
        a = np.asarray(arrays[name])
        if name in _INT_FIELDS:
            a = a.astype(np.int32)
        elif name in _BOOL_FIELDS:
            a = a.astype(bool)
        else:
            a = a.astype(np.float32)
        out[name] = torch.as_tensor(a, device=dev)
    return TreeArrays(**out)


def booster_from_model_string(text: str, device=None) -> Booster:
    """A port Booster from a v2 model text written by either package."""
    return Booster(model_str=text, device=device)
