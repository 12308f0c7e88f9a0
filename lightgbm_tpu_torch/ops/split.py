"""Best-split search over histograms: the vectorized scan in PyTorch.

Port of lightgbm_tpu/ops/split.py (numerical features only).  All features
x all thresholds x both default directions are evaluated at once as
cumulative sums along the bin axis of a `[F, B, 3]` histogram, then a
masked argmax.  This is the contract that the K1 kernel
(ops/split_kernel.py) meets:

- gain math with L1 thresholding, L2 and max_delta_step clamps;
- missing handling: MissingType None/Zero/NaN, the default (zero) bin or
  the NaN bin riding the chosen default direction, both directions scanned
  when the feature has missing values;
- min_data_in_leaf / min_sum_hessian_in_leaf / min_gain_to_split masks,
  monotone clamp and veto, feature and CEGB penalties;
- tie-breaking: the descending scan beats the ascending one at equal gain,
  the higher threshold wins inside the descending scan, the lower inside the
  ascending one, the lower feature index wins across features.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

K_EPSILON = 1e-15  # meta.h:38
K_MIN_SCORE = float("-inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class SplitParams(NamedTuple):
    """Split hyper-parameters (the numerical subset of the JAX record)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    cegb_split_penalty: float = 0.0


class SplitResult(NamedTuple):
    """Per-leaf best split (0-d tensors)."""
    feature: torch.Tensor        # int64, -1 = no valid split
    threshold: torch.Tensor
    gain: torch.Tensor
    default_left: torch.Tensor
    left_sum_gradient: torch.Tensor
    left_sum_hessian: torch.Tensor
    left_count: torch.Tensor
    left_output: torch.Tensor
    right_sum_gradient: torch.Tensor
    right_sum_hessian: torch.Tensor
    right_count: torch.Tensor
    right_output: torch.Tensor


class PerFeatureSplit(NamedTuple):
    """Best split of every feature of one leaf: all fields [F] (or
    [CH, F] from the kernel's batched form)."""
    gain: torch.Tensor           # K_MIN_SCORE = no valid split
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_gradient: torch.Tensor
    left_sum_hessian: torch.Tensor   # includes the +eps directional bias
    left_count: torch.Tensor
    left_output: torch.Tensor
    right_sum_gradient: torch.Tensor
    right_sum_hessian: torch.Tensor
    right_count: torch.Tensor
    right_output: torch.Tensor


def threshold_l1(s, l1):
    """sign(s) * max(0, |s| - l1) (feature_histogram.hpp:437-440)."""
    return torch.sign(s) * torch.clamp_min(torch.abs(s) - l1, 0.0)


def calculate_splitted_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step):
    """feature_histogram.hpp:442-449."""
    ret = -threshold_l1(sum_grad, l1) / (sum_hess + l2)
    if max_delta_step > 0.0:
        ret = torch.where(torch.abs(ret) > max_delta_step,
                          torch.sign(ret) * max_delta_step, ret)
    return ret


def leaf_split_gain_given_output(sum_grad, sum_hess, l1, l2, output):
    """-(2*T_l1(g)*w + (h+l2)*w^2) (feature_histogram.hpp:494-497)."""
    return -(2.0 * threshold_l1(sum_grad, l1) * output
             + (sum_hess + l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, l1, l2, max_delta_step):
    out = calculate_splitted_leaf_output(sum_grad, sum_hess, l1, l2,
                                         max_delta_step)
    return leaf_split_gain_given_output(sum_grad, sum_hess, l1, l2, out)


def split_gains(lg, lh, rg, rh, l1, l2, max_delta_step, min_constraint,
                max_constraint, monotone):
    """Gain of a (left, right) pair with monotone zeroing
    (feature_histogram.hpp:452-463)."""
    lo = torch.minimum(torch.maximum(
        calculate_splitted_leaf_output(lg, lh, l1, l2, max_delta_step),
        min_constraint), max_constraint)
    ro = torch.minimum(torch.maximum(
        calculate_splitted_leaf_output(rg, rh, l1, l2, max_delta_step),
        min_constraint), max_constraint)
    gain = (leaf_split_gain_given_output(lg, lh, l1, l2, lo)
            + leaf_split_gain_given_output(rg, rh, l1, l2, ro))
    violates = ((monotone > 0) & (lo > ro)) | ((monotone < 0) & (lo < ro))
    return torch.where(violates, torch.zeros_like(gain), gain), lo, ro


def best_split_per_feature(hist: torch.Tensor, sum_gradient, sum_hessian,
                           num_data, num_bins: torch.Tensor,
                           default_bins: torch.Tensor,
                           missing_types: torch.Tensor, params: SplitParams,
                           monotone: Optional[torch.Tensor] = None,
                           penalty: Optional[torch.Tensor] = None,
                           min_constraints: Optional[torch.Tensor] = None,
                           max_constraints: Optional[torch.Tensor] = None,
                           feature_mask: Optional[torch.Tensor] = None,
                           cegb_feature_penalty: Optional[torch.Tensor] = None
                           ) -> PerFeatureSplit:
    """Best numerical split of every feature of one leaf (fields [F]).

    hist: [F, B, 3] (grad, hess, count); num_data: the leaf's row count,
    an int or an integer 0-d tensor (read on the device, no host sync);
    num_bins/default_bins/missing_types: [F] integer statics; feature_mask:
    [F] bool."""
    F, B, _ = hist.shape
    dev, dtype = hist.device, hist.dtype
    l1, l2 = params.lambda_l1, params.lambda_l2
    mds = params.max_delta_step
    sum_gradient = torch.as_tensor(sum_gradient, dtype=dtype, device=dev)
    # FindBestThreshold adds 2*eps to the parent hessian (hpp:79)
    sum_hessian = torch.as_tensor(sum_hessian, dtype=dtype,
                                  device=dev) + 2 * K_EPSILON
    num_data = torch.as_tensor(num_data, device=dev).long()
    nb = num_bins.to(dev).long()[:, None]
    db = default_bins.to(dev).long()[:, None]
    mt = missing_types.to(dev).long()[:, None]

    bins = torch.arange(B, device=dev)[None, :]
    in_range = bins < nb
    excl = (((mt == MISSING_ZERO) & (bins == db))
            | ((mt == MISSING_NAN) & (bins == nb - 1)))
    # with <=2 bins the reference falls into the single plain scan with no
    # default-direction bin (feature_histogram.hpp:89,97-103)
    excl = excl & in_range & (nb > 2)
    live = in_range & ~excl
    zero = torch.zeros((), dtype=dtype, device=dev)
    g = torch.where(live, hist[..., 0], zero)
    h = torch.where(live, hist[..., 1], zero)
    c = torch.where(live, torch.round(hist[..., 2]), zero).long()

    cg = torch.cumsum(g, dim=1)
    ch = torch.cumsum(h, dim=1)
    cc = torch.cumsum(c, dim=1)
    tg, th, tc = cg[:, -1:], ch[:, -1:], cc[:, -1:]
    minc = (torch.full((F, 1), -torch.inf, dtype=dtype, device=dev)
            if min_constraints is None else min_constraints[:, None].to(dtype))
    maxc = (torch.full((F, 1), torch.inf, dtype=dtype, device=dev)
            if max_constraints is None else max_constraints[:, None].to(dtype))
    mono = (torch.zeros((F, 1), dtype=torch.long, device=dev)
            if monotone is None else monotone.to(dev).long()[:, None])
    min_cnt = max(int(params.min_data_in_leaf), 1)

    def eval_dir(left_g, left_h, left_c):
        right_g = sum_gradient - left_g
        right_h = sum_hessian - left_h
        right_c = num_data - left_c
        gain, lo, ro = split_gains(left_g, left_h, right_g, right_h, l1, l2,
                                   mds, minc, maxc, mono)
        valid = ((left_c >= min_cnt) & (right_c >= min_cnt)
                 & (left_h >= params.min_sum_hessian_in_leaf)
                 & (right_h >= params.min_sum_hessian_in_leaf))
        return gain, lo, ro, valid, (left_g, left_h, left_c, right_g, right_h,
                                     right_c)

    asc = eval_dir(cg, ch + K_EPSILON, cc)
    desc = eval_dir(sum_gradient - (tg - cg),
                    sum_hessian - (th - ch + K_EPSILON), num_data - (tc - cc))

    thr_ok = bins <= nb - 2
    asc_ok = thr_ok & (mt != MISSING_NONE) & (nb > 2)
    desc_ok = thr_ok
    min_gain_shift = (leaf_split_gain(sum_gradient, sum_hessian, l1, l2, mds)
                      + params.min_gain_to_split)
    ninf = torch.full((), K_MIN_SCORE, dtype=dtype, device=dev)

    def masked_gain(d, ok):
        gain, _lo, _ro, valid, _ = d
        return torch.where(ok & valid & (gain > min_gain_shift), gain, ninf)

    # scan-order tie-breaking: desc scans high->low theta, then asc
    # scans low->high, strict-greater updates (argmax takes the first hit)
    cand = torch.cat([torch.flip(masked_gain(desc, desc_ok), [1]),
                      masked_gain(asc, asc_ok)], dim=1)          # [F, 2B]
    best_idx = _first_argmax(cand)
    best_gain = torch.gather(cand, 1, best_idx[:, None])[:, 0]
    is_desc = best_idx < B
    best_thr = torch.where(is_desc, B - 1 - best_idx, best_idx - B)

    def sel(a, d):
        at = torch.gather(a, 1, best_thr[:, None])[:, 0]
        dt = torch.gather(d, 1, best_thr[:, None])[:, 0]
        return torch.where(is_desc, dt, at)

    lg, lh, lc, rg, rh, rc = [sel(a, d) for a, d in zip(asc[4], desc[4])]
    lo = sel(asc[1], desc[1])
    ro = sel(asc[2], desc[2])

    rel_gain = best_gain - min_gain_shift
    if penalty is not None:
        rel_gain = rel_gain * penalty.to(dtype)
    # CEGB penalties are subtracted after the threshold search
    # (serial_tree_learner.cpp:533-539)
    rel_gain = rel_gain - params.cegb_split_penalty * num_data
    if cegb_feature_penalty is not None:
        rel_gain = rel_gain - cegb_feature_penalty.to(dtype)
    feat_gain = torch.where((best_gain > K_MIN_SCORE) & (rel_gain > 0),
                            rel_gain, ninf)
    if feature_mask is not None:
        feat_gain = torch.where(feature_mask.to(dev), feat_gain, ninf)
    # 2-bin NaN features report default_right even from the single
    # descending scan (feature_histogram.hpp:99-102)
    two_bin_nan = (mt[:, 0] == MISSING_NAN) & (nb[:, 0] <= 2)
    return PerFeatureSplit(
        gain=feat_gain, threshold=best_thr, default_left=is_desc & ~two_bin_nan,
        left_sum_gradient=lg, left_sum_hessian=lh, left_count=lc,
        left_output=lo, right_sum_gradient=rg, right_sum_hessian=rh,
        right_count=rc, right_output=ro)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax that returns the FIRST maximal index (jnp.argmax's
    rule; torch.argmax promises it too, stated here so the tie rule does not
    rest on one backend's kernel)."""
    best = x.max(dim=1, keepdim=True).values
    idx = torch.arange(x.shape[1], device=x.device).expand_as(x)
    big = torch.full_like(idx, x.shape[1])
    return torch.where(x == best, idx, big).min(dim=1).values


def select_best_feature(pf: PerFeatureSplit) -> SplitResult:
    """Cross-feature argmax of a PerFeatureSplit; ties go to the smaller
    feature index (serial_tree_learner.cpp:575-587)."""
    best_f = _first_argmax(pf.gain[None])[0]
    has_split = pf.gain[best_f] > K_MIN_SCORE
    return SplitResult(
        feature=torch.where(has_split, best_f, torch.full_like(best_f, -1)),
        threshold=pf.threshold[best_f], gain=pf.gain[best_f],
        default_left=pf.default_left[best_f],
        left_sum_gradient=pf.left_sum_gradient[best_f],
        left_sum_hessian=pf.left_sum_hessian[best_f] - K_EPSILON,
        left_count=pf.left_count[best_f],
        left_output=pf.left_output[best_f],
        right_sum_gradient=pf.right_sum_gradient[best_f],
        right_sum_hessian=pf.right_sum_hessian[best_f] - K_EPSILON,
        right_count=pf.right_count[best_f],
        right_output=pf.right_output[best_f])
