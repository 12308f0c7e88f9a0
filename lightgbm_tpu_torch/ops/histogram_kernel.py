"""K7: the label engine's per-leaf histogram over row-major bins.

Port of lightgbm_tpu/ops/histogram_pallas.py: `leaf_histogram` (its
`_hist_kernel`) and `leaf_histogram_quantized` (`_hist_kernel_q`).  Each
wrapper launches the CUDA kernel of `csrc/leaf_histogram.cu` for CUDA
tensors and runs the plain PyTorch version beside it for CPU tensors.

The Pallas kernels factor each bin over a radix pair and contract one-hot
planes on the MXU, because a TPU has no fast scatter; the radix layout and
its epilogue are not ported, only the function: the [F, max_bin, 3]
(sum g, sum h, count) of the rows whose leaf id equals `leaf`.

- f32 mode: bins uint8 [n, F] (the dataset's device bins), grad and hess
  f32 [n], leaf ids int32 [n] (-1: out of the bag); f32 sums;
- its wider forms, for the label engine's general grower: bins int16
  holding uint16 bins (io/dataset.device_bins: a column of more than 256
  bins) with max_bin up to 1024, and grad and hess f64 (summed in f64,
  `tpu_double_precision`), each alone or both; JAX gives uint16 bins to
  XLA's scatter (ops/histogram.py:149-155), the port serves every label
  histogram by K7;
- int8 mode: int8 g and h codes, uint8 leaf ids (255 is never a leaf);
  exact int32 code sums, as K2's int8 mode returns them (the JAX kernel
  returns the same integers in f32).

`leaf` is an int32 device scalar (shape () or (1,)) that the kernel reads,
so a grower's best leaf never visits the host; an int is accepted too.

The kernel first selects the leaf's rows into a row list on the device,
then histograms only those.  `rows` is that list's workspace, int32
[n + 1] (`row_list`): a grower allocates it once per tree and passes it
to every call; without it the wrapper allocates one per call.  The plain
versions need no workspace.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..io.dataset import bin_values
from . import _cuda

# the accumulate pass: at most two blocks an SM with an 85.7 KB
# sub-histogram, each taking LEAF_ROWS_PER_BLOCK listed rows at a time, so
# that a small leaf wakes only the blocks it fills
LEAF_HIST_BLOCKS = 264
LEAF_ROWS_PER_BLOCK = 512


def row_list(n: int, device) -> torch.Tensor:
    """K7's workspace for n rows: int32 [n + 1], the row list and its
    count (the last word), both written on the device."""
    return torch.empty(n + 1, dtype=torch.int32, device=device)


def _check_rows(rows, n, dev):
    if rows is None:
        return row_list(n, dev)
    _cuda.require(rows, "rows", torch.int32, dev, (n + 1,))
    return rows


def _leaf_tensor(leaf: Union[int, torch.Tensor], dev) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        return torch.tensor([int(leaf)], dtype=torch.int32, device=dev)
    if leaf.numel() != 1:
        raise ValueError("leaf: %d elements, expected one" % leaf.numel())
    leaf = leaf.reshape(1)
    _cuda.require(leaf, "leaf", torch.int32, dev)
    return leaf


def _check(bins, g, h, leaf_ids, max_bin, payload_dtype, id_dtype):
    if bins.dim() != 2:
        raise ValueError("bins: shape %s, expected (n, F)"
                         % (tuple(bins.shape),))
    n = bins.shape[0]
    dev = bins.device
    if bins.dtype == torch.int16 and id_dtype == torch.int32:
        top = 1024          # uint16 bins: K1's bound on B
    else:
        _cuda.require(bins, "bins", torch.uint8, dev)
        top = 256
    if not 1 <= max_bin <= top:
        raise ValueError("max_bin must be in [1, %d], got %d"
                         % (top, max_bin))
    for t, name in ((g, "grad"), (h, "hess")):
        _cuda.require(t, name, payload_dtype, dev, (n,))
    _cuda.require(leaf_ids, "leaf_ids", id_dtype, dev, (n,))


def _rows_histogram_plain(bins, g, h, rows, max_bin, acc_dtype):
    """[F, max_bin, 3] sums over the given rows, one index_add_ per
    feature, accumulated in acc_dtype."""
    n, F = bins.shape
    b = bin_values(bins.index_select(0, rows))
    vals = torch.stack([g.index_select(0, rows).to(acc_dtype),
                        h.index_select(0, rows).to(acc_dtype),
                        torch.ones(rows.shape[0], dtype=acc_dtype,
                                   device=bins.device)], dim=1)
    out = torch.zeros((F, max_bin, 3), dtype=acc_dtype, device=bins.device)
    for f in range(F):
        out[f].index_add_(0, b[:, f], vals)
    return out


def _launch(name, bins, g, h, leaf_ids, leaf, max_bin, out_dtype, rows):
    """K7's CUDA kernels `name` into a zeroed [F, max_bin, 3] output; the
    name takes _u16 for uint16 bins and _f64 for an f64 payload."""
    if bins.dtype == torch.int16:
        name += "_u16"
    if out_dtype == torch.float64:
        name += "_f64"
    n, F = bins.shape
    rows = _check_rows(rows, n, bins.device)
    out = torch.zeros((F, max_bin, 3), dtype=out_dtype, device=bins.device)
    rc = _cuda.fn("lgbt_" + name)(
        bins.data_ptr(), g.data_ptr(), h.data_ptr(), leaf_ids.data_ptr(),
        leaf.data_ptr(), n, out.data_ptr(), F, max_bin, rows.data_ptr(),
        rows[n:].data_ptr(), LEAF_HIST_BLOCKS, LEAF_ROWS_PER_BLOCK,
        _cuda.stream())
    _cuda.check(rc, name)
    return out


def leaf_histogram_plain(bins, grad, hess, leaf_ids, leaf,
                         max_bin: int) -> torch.Tensor:
    """The histogram accumulated in f64, in the payload's type: an f32
    one rounded once to f32, so the plain version is not itself off by the
    f32 rounding of a long sum."""
    rows = (leaf_ids == _leaf_tensor(leaf, bins.device)).nonzero()[:, 0]
    return _rows_histogram_plain(bins, grad, hess, rows, max_bin,
                                 torch.float64).to(grad.dtype)


def leaf_histogram(bins: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, leaf_ids: torch.Tensor, leaf,
                   max_bin: int, rows: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[F, max_bin, 3] (sum grad, sum hess, count) of the rows with
    leaf_ids == leaf, in the payload's type (f32, or f64); bins uint8, or
    int16 holding uint16 bins; rows: the kernel's workspace
    (`row_list`)."""
    dtype = grad.dtype if grad.dtype == torch.float64 else torch.float32
    _check(bins, grad, hess, leaf_ids, max_bin, dtype, torch.int32)
    dev = bins.device
    leaf = _leaf_tensor(leaf, dev)
    if not _cuda.plain_or_cuda(dev):
        return leaf_histogram_plain(bins, grad, hess, leaf_ids, leaf, max_bin)
    return _launch("leaf_histogram", bins, grad, hess, leaf_ids, leaf,
                   max_bin, dtype, rows)


def leaf_histogram_quantized_plain(bins, g_code, h_code, leaf_ids, leaf,
                                   max_bin: int) -> torch.Tensor:
    """Exact int64 sums, returned as int32."""
    rows = (leaf_ids.to(torch.int32)
            == _leaf_tensor(leaf, bins.device)).nonzero()[:, 0]
    return _rows_histogram_plain(bins, g_code, h_code, rows, max_bin,
                                 torch.int64).to(torch.int32)


def leaf_histogram_quantized(bins: torch.Tensor, g_code: torch.Tensor,
                             h_code: torch.Tensor, leaf_ids: torch.Tensor,
                             leaf, max_bin: int,
                             rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """[F, max_bin, 3] int32 (sum g_code, sum h_code, count) of the rows
    with leaf_ids == leaf; leaf_ids uint8, leaf < 255."""
    _check(bins, g_code, h_code, leaf_ids, max_bin, torch.int8, torch.uint8)
    dev = bins.device
    leaf = _leaf_tensor(leaf, dev)
    if not _cuda.plain_or_cuda(dev):
        return leaf_histogram_quantized_plain(bins, g_code, h_code, leaf_ids,
                                              leaf, max_bin)
    return _launch("leaf_histogram_i8", bins, g_code, h_code, leaf_ids, leaf,
                   max_bin, torch.int32, rows)


def leaf_histogram_bytes(n: int, m: int, F: int, max_bin: int,
                         quantized: bool = False, bin_bytes: int = 1,
                         payload_bytes: int = 4) -> int:
    """Bytes K7 must move: all n leaf ids (4 bytes, or 1 in int8 mode), the
    F bins (bin_bytes each) and the payload (two words of payload_bytes,
    or 2 bytes of codes) of the leaf's m rows, and the [F, max_bin, 3]
    histogram written once in the payload's width."""
    if quantized:
        return n + m * (F + 2) + 12 * F * max_bin
    return (4 * n + m * (bin_bytes * F + 2 * payload_bytes)
            + 3 * payload_bytes * F * max_bin)
