"""Per-leaf gradient/hessian/count histograms of the label engine.

Port of `leaf_histogram` and `subtract` of lightgbm_tpu/ops/histogram.py
(:145-173).  The JAX package offers one function in several layouts,
chosen by `tpu_histogram_impl`: `scatter` (a scatter-add, its CPU choice),
`onehot` (a one-hot matrix product on the MXU), `compact` (the leaf's rows
gathered first) and `pallas` (K7's radix-pair MXU kernel), with `auto`
picking one per backend.  Each is a TPU layout of the same sums.  Here
every value runs K7 (ops/histogram_kernel.py): its CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor.  The tensor's device decides;
there is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import histogram_kernel

IMPLS = ("auto", "scatter", "onehot", "compact", "pallas")


def leaf_histogram(bins: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, leaf_ids: torch.Tensor, leaf,
                   max_bin: int, impl: str = "auto",
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[F, max_bin, 3] (sum grad, sum hess, count), in the payload's type
    (f32, or f64), of the rows of bins [n, F] (uint8, or int16 holding
    uint16 bins) whose leaf id equals `leaf` (an int32 device scalar);
    rows: K7's row-list workspace (histogram_kernel.row_list)."""
    if impl not in IMPLS:
        raise ValueError("unknown histogram impl: %s" % impl)
    return histogram_kernel.leaf_histogram(bins, grad, hess, leaf_ids, leaf,
                                           max_bin, rows)


def subtract(parent_hist: torch.Tensor,
             child_hist: torch.Tensor) -> torch.Tensor:
    """Sibling histogram by subtraction (FeatureHistogram::Subtract,
    feature_histogram.hpp:67-73)."""
    return parent_hist - child_hist
