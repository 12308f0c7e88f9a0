"""Gradient/hessian quantization for histogram training.

Port of lightgbm_tpu/ops/quantize.py (the serial subset): int8 codes in
[-127, 127] with one f32 scale per (tree, g|h),

    g_code = floor(g / g_scale + u),   g_scale = max|g| / 127  (stochastic)
    h_code = round(h / h_scale),       h_scale = max|h| / 127  (to nearest)

with u from `ops/threefry.uniform`, the same bits as the JAX package's
`jax.random.uniform`, so the codes are equal bit for bit.  Histograms
accumulate the codes as int32: exact to 2^31 / 127 rows in one bin, which
covers every arena (n < 2^24).  The JAX package accumulates them in f32,
exact only to `exact_rows()` rows in one bin; the warning the driver gives
past that envelope names the JAX bound, as the reference does.
"""
from __future__ import annotations

import torch

from . import threefry

CODE_MAX = 127
_F32_EXACT = 1 << 24


def exact_rows(bits: int = 8) -> int:
    """Rows one bin may hold before the JAX package's f32 code sums can
    round (quantize.py:45-51)."""
    code_max = (1 << (bits - 1)) - 1
    return _F32_EXACT // code_max


def overflow_safe(segment_rows: int, bits: int = 8) -> bool:
    return int(segment_rows) <= exact_rows(bits)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       key: threefry.Key):
    """(g_code, h_code, g_scale, h_scale): int8 [n] codes and 0-d f32
    scales.  u[i] is drawn for position i of the vectors given, so the
    caller decides whether noise follows row order or arena order.  key:
    a pair of ints or an int64 [2] tensor on the gradients' device
    (threefry.uniform)."""
    g = grad.to(torch.float32)
    h = hess.to(torch.float32)
    g_scale = torch.clamp_min(g.abs().max(), 1e-30) / CODE_MAX
    h_scale = torch.clamp_min(h.abs().max(), 1e-30) / CODE_MAX
    u = threefry.uniform(key, g.shape[0], g.device)
    g_code = torch.clamp(torch.floor(g / g_scale + u), -CODE_MAX, CODE_MAX)
    h_code = torch.clamp(torch.round(h / h_scale), -CODE_MAX, CODE_MAX)
    return (g_code.to(torch.int8), h_code.to(torch.int8), g_scale, h_scale)


def quantize_key(seed: int, iteration: int) -> threefry.Key:
    """The stochastic-rounding key of one boosting iteration."""
    return threefry.fold_in(threefry.PRNGKey(seed & 0x7FFFFFFF), iteration)


def dequantize_hist(hist_code: torch.Tensor, g_scale: torch.Tensor,
                    h_scale: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer (g_code, h_code, count) sums -> f32 (g, h, count)."""
    one = torch.ones((), dtype=torch.float32, device=hist_code.device)
    scale = torch.stack([g_scale.to(torch.float32),
                         h_scale.to(torch.float32), one])
    return hist_code.to(torch.float32) * scale
