"""Best-split search over histograms: the vectorized scan in PyTorch.

Port of lightgbm_tpu/ops/split.py.  All features x all thresholds x both
default directions are evaluated at once as cumulative sums along the bin
axis of a `[F, B, 3]` histogram, then a masked argmax.  This is the
contract that the K1 kernel (ops/split_kernel.py) meets:

- gain math with L1 thresholding, L2 and max_delta_step clamps;
- missing handling: MissingType None/Zero/NaN, the default (zero) bin or
  the NaN bin riding the chosen default direction, both directions scanned
  when the feature has missing values;
- min_data_in_leaf / min_sum_hessian_in_leaf / min_gain_to_split masks,
  monotone clamp and veto, feature and CEGB penalties;
- tie-breaking: the descending scan beats the ascending one at equal gain,
  the higher threshold wins inside the descending scan, the lower inside the
  ascending one, the lower feature index wins across features.

Categorical features take the scan of `best_split_categorical_per_feature`
(FindBestThresholdCategorical): one category against the rest up to
max_cat_to_onehot bins, else the categories sorted by g / (h + cat_smooth)
walked from both ends for at most max_cat_threshold steps.  It is plain
tensor code with a loop of fixed length and no host read, so it captures
into the round graphs; the JAX package runs it in XLA.
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
    # categorical optimal-split knobs (config.h:394-437)
    max_cat_to_onehot: int = 4
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    min_data_per_group: int = 100


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
    # [B] bool left-going bins of a categorical split, all False for a
    # numerical one; None where no feature is categorical
    cat_mask: Optional[torch.Tensor] = None


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
    cat_mask: Optional[torch.Tensor] = None   # [F, B] bool


def threshold_l1(s, l1):
    """sign(s) * max(0, |s| - l1) (feature_histogram.hpp:437-440); s
    itself for a Python l1 of 0, which the formula returns (a round graph
    then holds five nodes fewer each use)."""
    if not isinstance(l1, torch.Tensor) and l1 == 0:
        return s
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
    (feature_histogram.hpp:452-463).  Constraints None: no output bounds
    (the clamp to +-inf is the identity); monotone None: no feature
    constrained."""
    lo = calculate_splitted_leaf_output(lg, lh, l1, l2, max_delta_step)
    ro = calculate_splitted_leaf_output(rg, rh, l1, l2, max_delta_step)
    if min_constraint is not None:
        lo = torch.minimum(torch.maximum(lo, min_constraint), max_constraint)
        ro = torch.minimum(torch.maximum(ro, min_constraint), max_constraint)
    gain = (leaf_split_gain_given_output(lg, lh, l1, l2, lo)
            + leaf_split_gain_given_output(rg, rh, l1, l2, ro))
    if monotone is None:
        return gain, lo, ro
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
    """Best numerical split of every feature of one leaf (fields [F]), or
    of C leaves at once (fields [C, F]).

    hist: [F, B, 3] (grad, hess, count) or [C, F, B, 3]; sum_gradient,
    sum_hessian and num_data: the leaf's sums and row count, scalars or
    0-d tensors, or [C] tensors (num_data integer, read on the device, no
    host sync); num_bins/default_bins/missing_types: [F] integer statics;
    min/max_constraints: [F] or [C, F]; feature_mask: [F] bool.  The C
    leaves take the same element-wise arithmetic as one leaf does, so one
    call of C leaves equals C calls."""
    lead = hist.shape[:-3]
    F, B, _ = hist.shape[-3:]
    hist = hist.reshape(-1, F, B, 3)
    C = hist.shape[0]
    dev, dtype = hist.device, hist.dtype
    l1, l2 = params.lambda_l1, params.lambda_l2
    mds = params.max_delta_step
    sum_gradient = torch.as_tensor(sum_gradient, dtype=dtype,
                                   device=dev).reshape(C, 1, 1)
    # FindBestThreshold adds 2*eps to the parent hessian (hpp:79)
    sum_hessian = torch.as_tensor(sum_hessian, dtype=dtype, device=dev
                                  ).reshape(C, 1, 1) + 2 * K_EPSILON
    num_data = torch.as_tensor(num_data, device=dev).long().reshape(C, 1, 1)
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

    cg = torch.cumsum(g, dim=-1)
    ch = torch.cumsum(h, dim=-1)
    cc = torch.cumsum(c, dim=-1)
    tg, th, tc = cg[..., -1:], ch[..., -1:], cc[..., -1:]
    minc = (None if min_constraints is None else
            min_constraints.to(dtype).reshape(-1, F, 1))
    maxc = (None if max_constraints is None else
            max_constraints.to(dtype).reshape(-1, F, 1))
    mono = None if monotone is None else monotone.to(dev).long()[:, None]
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
    cand = torch.cat([torch.flip(masked_gain(desc, desc_ok), [-1]),
                      masked_gain(asc, asc_ok)], dim=-1)      # [C, F, 2B]
    best_idx = _first_argmax(cand)
    best_gain = torch.gather(cand, -1, best_idx[..., None])[..., 0]
    is_desc = best_idx < B
    best_thr = torch.where(is_desc, B - 1 - best_idx, best_idx - B)

    def sel(a, d):
        at = torch.gather(a.expand(C, F, B), -1, best_thr[..., None])[..., 0]
        dt = torch.gather(d.expand(C, F, B), -1, best_thr[..., None])[..., 0]
        return torch.where(is_desc, dt, at)

    lg, lh, lc, rg, rh, rc = [sel(a, d) for a, d in zip(asc[4], desc[4])]
    lo = sel(asc[1], desc[1])
    ro = sel(asc[2], desc[2])

    rel_gain = best_gain - min_gain_shift[..., 0]
    if penalty is not None:
        rel_gain = rel_gain * penalty.to(dtype)
    # CEGB penalties are subtracted after the threshold search
    # (serial_tree_learner.cpp:533-539)
    rel_gain = rel_gain - params.cegb_split_penalty * num_data[..., 0]
    if cegb_feature_penalty is not None:
        rel_gain = rel_gain - cegb_feature_penalty.to(dtype)
    feat_gain = torch.where((best_gain > K_MIN_SCORE) & (rel_gain > 0),
                            rel_gain, ninf)
    if feature_mask is not None:
        feat_gain = torch.where(feature_mask.to(dev), feat_gain, ninf)
    # 2-bin NaN features report default_right even from the single
    # descending scan (feature_histogram.hpp:99-102)
    two_bin_nan = (mt[:, 0] == MISSING_NAN) & (nb[:, 0] <= 2)
    out = PerFeatureSplit(
        gain=feat_gain, threshold=best_thr, default_left=is_desc & ~two_bin_nan,
        left_sum_gradient=lg, left_sum_hessian=lh, left_count=lc,
        left_output=lo, right_sum_gradient=rg, right_sum_hessian=rh,
        right_count=rc, right_output=ro)
    return PerFeatureSplit(*[v.reshape(lead + (F,)) for v in out[:11]])


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Argmax along the last dim that returns the FIRST maximal index
    (jnp.argmax's rule; torch.argmax promises it too, stated here so the tie
    rule does not rest on one backend's kernel)."""
    best = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    big = torch.full_like(idx, x.shape[-1])
    return torch.where(x == best, idx, big).min(dim=-1).values


def select_best_feature(pf: PerFeatureSplit) -> SplitResult:
    """Cross-feature argmax of a PerFeatureSplit ([F] fields, or [C, F] for
    C leaves: then [C] fields); ties go to the smaller feature index
    (serial_tree_learner.cpp:575-587).  Fields are gathered on the device,
    so a round graph can capture it."""
    best_f = _first_argmax(pf.gain)
    eps = K_EPSILON

    def at(v):
        return torch.gather(v, -1, best_f[..., None])[..., 0]

    has_split = at(pf.gain) > K_MIN_SCORE
    cat_mask = None
    if pf.cat_mask is not None:
        W = pf.cat_mask.shape[-1]
        idx = best_f[..., None, None].expand(*best_f.shape, 1, W)
        cat_mask = torch.gather(pf.cat_mask, -2, idx)[..., 0, :]
    return SplitResult(
        feature=torch.where(has_split, best_f, torch.full_like(best_f, -1)),
        threshold=at(pf.threshold), gain=at(pf.gain),
        default_left=at(pf.default_left),
        left_sum_gradient=at(pf.left_sum_gradient),
        left_sum_hessian=at(pf.left_sum_hessian) - eps,
        left_count=at(pf.left_count),
        left_output=at(pf.left_output),
        right_sum_gradient=at(pf.right_sum_gradient),
        right_sum_hessian=at(pf.right_sum_hessian) - eps,
        right_count=at(pf.right_count),
        right_output=at(pf.right_output), cat_mask=cat_mask)


def best_split_per_feature_mixed(hist: torch.Tensor, sum_gradient,
                                 sum_hessian, num_data,
                                 num_bins: torch.Tensor,
                                 default_bins: torch.Tensor,
                                 missing_types: torch.Tensor,
                                 is_categorical: torch.Tensor,
                                 params: SplitParams,
                                 monotone: Optional[torch.Tensor] = None,
                                 penalty: Optional[torch.Tensor] = None,
                                 min_constraints=None, max_constraints=None,
                                 feature_mask: Optional[torch.Tensor] = None,
                                 cegb_feature_penalty=None, *,
                                 max_cat_threshold: int = 32
                                 ) -> PerFeatureSplit:
    """Per-feature best split, the numerical or the categorical scan by
    each feature's bin type (is_categorical [F] bool;
    lightgbm_tpu/ops/split.py:340-382); one leaf or C at once, as the two
    scans take them."""
    pf_num = best_split_per_feature(
        hist, sum_gradient, sum_hessian, num_data, num_bins, default_bins,
        missing_types, params, monotone=monotone, penalty=penalty,
        min_constraints=min_constraints, max_constraints=max_constraints,
        feature_mask=feature_mask, cegb_feature_penalty=cegb_feature_penalty)
    pf_cat = best_split_categorical_per_feature(
        hist, sum_gradient, sum_hessian, num_data, num_bins, missing_types,
        params, penalty=penalty, min_constraints=min_constraints,
        max_constraints=max_constraints, feature_mask=feature_mask,
        cegb_feature_penalty=cegb_feature_penalty,
        max_cat_threshold=max_cat_threshold)
    ic = is_categorical.to(hist.device)
    pf_num = pf_num._replace(cat_mask=torch.zeros_like(pf_cat.cat_mask))
    return PerFeatureSplit(*[
        torch.where(ic[:, None] if name == "cat_mask" else ic, c,
                    a.to(c.dtype))
        for name, a, c in zip(PerFeatureSplit._fields, pf_num, pf_cat)])


def best_split_categorical_per_feature(hist: torch.Tensor, sum_gradient,
                                       sum_hessian, num_data,
                                       num_bins: torch.Tensor,
                                       missing_types: torch.Tensor,
                                       params: SplitParams,
                                       penalty: Optional[torch.Tensor] = None,
                                       min_constraints=None,
                                       max_constraints=None,
                                       feature_mask=None,
                                       cegb_feature_penalty=None, *,
                                       max_cat_threshold: int = 32
                                       ) -> PerFeatureSplit:
    """Categorical optimal split of every feature of one leaf
    (FindBestThresholdCategorical, feature_histogram.hpp:110-271;
    lightgbm_tpu/ops/split.py:384-600), fields [F], the threshold -1 and
    `cat_mask` [F, B] the left-going bins; or of C leaves at once (hist
    [C, F, B, 3], sums [C]: fields [C, F], as best_split_per_feature):

    - one-hot mode where num_bin <= max_cat_to_onehot: each category
      against the rest;
    - sorted mode: the bins with count >= cat_smooth in the stable
      ascending order of g / (h + cat_smooth) (ties by bin), prefixes
      walked from both ends for max_cat_threshold steps, at most
      min(max_cat_threshold, (used+1)/2) of them live, with the
      min_data_per_group group reset; the first break poisons the later
      steps; the ascending walk wins ties.

    The walk's running sums are sequential f32 adds in walk order, as the
    JAX scan adds them: a loop of max_cat_threshold steps of one add each,
    the group reset a second loop, both directions and every leaf and
    feature in each step, the gains one pass over all steps."""
    lead = hist.shape[:-3]
    F, B, _ = hist.shape[-3:]
    hist = hist.reshape(-1, F, B, 3)
    C = hist.shape[0]
    dev, dtype = hist.device, hist.dtype
    l1, mds = params.lambda_l1, params.max_delta_step
    # l2 + cat_l2 rounded in f32, as JAX adds them (hpp:172); fills, not
    # copies from the host
    l2 = (torch.full((), params.lambda_l2, dtype=dtype, device=dev)
          + torch.full((), params.cat_l2, dtype=dtype, device=dev))
    # the leaves' sums: [C, 1] beside [C, F] fields, [C, 1, 1] beside bins
    sg = torch.as_tensor(sum_gradient, dtype=dtype,
                         device=dev).reshape(C, 1, 1)
    sh = torch.as_tensor(sum_hessian, dtype=dtype,
                         device=dev).reshape(C, 1, 1) + 2 * K_EPSILON
    nd = torch.as_tensor(num_data, device=dev).long().reshape(C, 1, 1)
    ninf = torch.full((), K_MIN_SCORE, dtype=dtype, device=dev)
    zero_f = torch.zeros((), dtype=dtype, device=dev)
    minc1 = maxc1 = minc = maxc = None
    if min_constraints is not None:
        minc1 = min_constraints.to(dtype).reshape(-1, F)
        maxc1 = max_constraints.to(dtype).reshape(-1, F)
        minc, maxc = minc1[..., None], maxc1[..., None]
    nb = num_bins.to(dev).long()
    mt = missing_types.to(dev).long()

    bins = torch.arange(B, device=dev)
    # used_bin = num_bin - 1 + (missing_type == None) (hpp:121-122)
    used_bin = nb - 1 + (mt == MISSING_NONE).long()
    in_used = bins[None, :] < used_bin[:, None]                   # [F, B]
    g = torch.where(in_used, hist[..., 0], zero_f)                # [C,F,B]
    h = torch.where(in_used, hist[..., 1], zero_f)
    c = torch.round(torch.where(in_used, hist[..., 2], zero_f)).long()

    # min_gain_shift against the plain-l2 no-split gain (hpp:119-120)
    min_gain_shift = (leaf_split_gain(sg, sh, l1, params.lambda_l2, mds)
                      + params.min_gain_to_split)                 # [C,1,1]
    min_cnt = max(int(params.min_data_in_leaf), 1)
    min_hess = params.min_sum_hessian_in_leaf
    mdpg = params.min_data_per_group

    # ---- one-hot mode (hpp:129-160) ---------------------------------------
    other_h = sh - h - K_EPSILON
    oh_gain, _, _ = split_gains(sg - g, other_h, g, h + K_EPSILON, l1, l2,
                                mds, minc, maxc, None)
    oh_valid = (in_used & (c >= min_cnt) & (h >= min_hess)
                & (nd - c >= min_cnt) & (other_h >= min_hess))
    oh_gain = torch.where(oh_valid & (oh_gain > min_gain_shift), oh_gain,
                          ninf)
    oh_best = _first_argmax(oh_gain)                              # [C, F]

    def at_b(v):
        return torch.gather(v, -1, oh_best[..., None])[..., 0]

    onehot = dict(gain=at_b(oh_gain), lg=at_b(g), lh=at_b(h) + K_EPSILON,
                  lc=at_b(c), mask=bins == oh_best[..., None])

    # ---- sorted mode (hpp:161-238) ----------------------------------------
    eligible = in_used & (c.to(dtype) >= params.cat_smooth)       # hpp:163
    n_elig = eligible.sum(dim=-1)                                 # [C, F]
    ratio = torch.where(eligible, g / (h + params.cat_smooth),
                        torch.full((), torch.inf, dtype=dtype, device=dev))
    order = torch.argsort(ratio, dim=-1, stable=True)             # [C,F,B]
    S = min(max_cat_threshold, B)
    # max_num_cat = min(max_cat_threshold, (used_bin+1)/2) (hpp:185)
    max_num_cat = torch.clamp_max((n_elig + 1) // 2, max_cat_threshold)
    # walk position i of each direction, [2, C, F, S]: ascending reads
    # sorted position i, descending n_elig-1-i (JAX's reversed and shifted
    # arrays, wrapping past the eligible bins where no step lives)
    step = torch.arange(S, device=dev)
    pos = torch.stack([
        step.expand(C, F, S),
        B - 1 - (step + (B - n_elig)[..., None]) % B])
    walk = [torch.gather(torch.gather(v, -1, order).expand(2, C, F, B), -1,
                         pos) for v in (g, h, c)]
    gh = torch.stack(walk[:2])                                 # [2,2,C,F,S]
    sc = walk[2]
    # running (g, h) sums, sequential f32 adds in walk order, lh from eps
    acc = torch.stack([torch.zeros((2, C, F), dtype=dtype, device=dev),
                       torch.full((2, C, F), K_EPSILON, dtype=dtype,
                                  device=dev)])
    sums = []
    for i in range(S):
        acc = acc + gh[..., i]
        sums.append(acc)
    lgs, lhs = torch.stack(sums, dim=-1)                      # [2,C,F,S]
    lcs = torch.cumsum(sc, dim=-1)                            # exact
    in_range = (step < n_elig[..., None]) & (step < max_num_cat[..., None])
    rh = sh - lhs
    # break conditions poison every later step (hpp:207-212)
    brk = (nd - lcs < min_cnt) | (nd - lcs < mdpg) | (rh < min_hess)
    ready = in_range & ~brk & ~((lcs < min_cnt) | (lhs < min_hess))
    # the group resets whenever the walk reaches an evaluation
    # (hpp:216-218): a step evaluates where ready and its group has
    # min_data_per_group rows
    need = torch.where(ready, mdpg, torch.iinfo(torch.long).max)
    grp = torch.zeros((2, C, F), dtype=torch.long, device=dev)
    evals = []
    for i in range(S):
        grp = grp + sc[..., i]
        ev = grp >= need[..., i]
        grp = torch.where(ev, 0, grp)
        evals.append(ev)
    evalable = torch.stack(evals, dim=-1)
    gains, _, _ = split_gains(lgs, lhs, sg - lgs, rh, l1, l2, mds, minc,
                              maxc, None)
    gains = torch.where(evalable & (gains > min_gain_shift), gains, ninf)
    dead = (brk & in_range).long()
    gains = torch.where(torch.cumsum(dead, dim=-1) - dead > 0, ninf, gains)
    best_i = _first_argmax(gains)                                 # [2,C,F]

    def at_i(v):
        return torch.gather(v, -1, best_i[..., None])[..., 0]

    sgain, slg, slh, slc = (at_i(v) for v in (gains, lgs, lhs, lcs))
    # membership: the first best_i+1 positions of the walk
    rank = torch.empty_like(order).scatter_(
        -1, order, bins.expand(C, F, B))                          # bin->pos
    member_asc = rank <= best_i[0][..., None]
    from_end = n_elig[..., None] - 1 - rank
    member_desc = (from_end >= 0) & (from_end <= best_i[1][..., None])
    # strict-greater update: the ascending walk wins ties (hpp:186-238)
    use_desc = sgain[1] > sgain[0]
    sorted_res = dict(
        gain=torch.where(use_desc, sgain[1], sgain[0]),
        lg=torch.where(use_desc, slg[1], slg[0]),
        lh=torch.where(use_desc, slh[1], slh[0]),
        lc=torch.where(use_desc, slc[1], slc[0]),
        mask=torch.where(use_desc[..., None], member_desc, member_asc)
        & eligible)

    # ---- mode select and outputs ------------------------------------------
    use_onehot = nb <= params.max_cat_to_onehot
    res = {key: torch.where(use_onehot[:, None] if key == "mask"
                            else use_onehot, v, sorted_res[key])
           for key, v in onehot.items()}
    gain, lg, lh, lc = res["gain"], res["lg"], res["lh"], res["lc"]
    sg2, sh2, nd2 = sg[..., 0], sh[..., 0], nd[..., 0]            # [C, 1]
    rg, rh, rc = sg2 - lg, sh2 - lh, nd2 - lc
    lo = calculate_splitted_leaf_output(lg, lh, l1, l2, mds)
    ro = calculate_splitted_leaf_output(rg, rh, l1, l2, mds)
    if minc1 is not None:
        lo, ro = (torch.clamp(v, minc1, maxc1) for v in (lo, ro))
    rel_gain = gain - min_gain_shift[..., 0]
    if penalty is not None:
        rel_gain = rel_gain * penalty.to(dtype)
    rel_gain = rel_gain - params.cegb_split_penalty * nd2
    if cegb_feature_penalty is not None:
        rel_gain = rel_gain - cegb_feature_penalty.to(dtype)
    feat_gain = torch.where((gain > K_MIN_SCORE) & (rel_gain > 0), rel_gain,
                            ninf)
    if feature_mask is not None:
        feat_gain = torch.where(feature_mask.to(dev), feat_gain, ninf)
    out = PerFeatureSplit(
        gain=feat_gain, threshold=torch.full((C, F), -1, dtype=torch.long,
                                             device=dev),
        default_left=torch.zeros((C, F), dtype=torch.bool, device=dev),
        left_sum_gradient=lg, left_sum_hessian=lh, left_count=lc,
        left_output=lo, right_sum_gradient=rg, right_sum_hessian=rh,
        right_count=rc, right_output=ro,
        cat_mask=res["mask"] & (feat_gain > K_MIN_SCORE)[..., None])
    return PerFeatureSplit(*[v.reshape(lead + v.shape[1:]) for v in out])


def forced_split_result(hist: torch.Tensor, feat: int, thr_bin: int,
                        sum_gradient, sum_hessian, num_data,
                        num_bins: torch.Tensor, default_bins: torch.Tensor,
                        missing_types: torch.Tensor, params: SplitParams,
                        default_left: bool) -> SplitResult:
    """The numerical split (feat, thr_bin) of one leaf, as a SplitResult of
    0-d tensors (FeatureHistogram::GatherInfoForThreshold,
    feature_histogram.hpp:273-411; lightgbm_tpu/ops/split.py:601
    `forced_split_result`): hist [F, B, 3] per-feature, the leaf's sums
    and its count.  The gain is +inf where both children hold rows (a
    forced split applies whatever its gain) and K_MIN_SCORE otherwise,
    the feature -1 then.  Plain tensor code, with no host read."""
    dev, dtype = hist.device, hist.dtype
    B = hist.shape[1]
    l1, l2 = params.lambda_l1, params.lambda_l2
    mds = params.max_delta_step
    sum_gradient = torch.as_tensor(sum_gradient, device=dev).to(dtype)
    sum_hessian = (torch.as_tensor(sum_hessian, device=dev).to(dtype)
                   + 2 * K_EPSILON)
    num_data = torch.as_tensor(num_data, device=dev).long()
    h_f = hist[feat]                                           # [B, 3]
    bins = torch.arange(B, device=dev)
    nb = num_bins[feat].long()
    in_range = bins < nb
    mt = missing_types[feat].long()
    excl = ((((mt == MISSING_ZERO) & (bins == default_bins[feat].long()))
             | ((mt == MISSING_NAN) & (bins == nb - 1)))
            & in_range & (nb > 2))
    take_left = in_range & ~excl & (bins <= thr_bin)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def total(mask, lane):
        return torch.where(mask, h_f[:, lane], zero).sum()

    lg, lh, lc = (total(take_left, i) for i in range(3))
    if default_left:
        lg, lh, lc = (v + total(excl, i) for i, v in enumerate((lg, lh, lc)))
    lc_i = torch.round(lc).long()
    rg = sum_gradient - lg
    rh = sum_hessian - lh
    rc = num_data - lc_i
    lo = calculate_splitted_leaf_output(lg, lh, l1, l2, mds)
    ro = calculate_splitted_leaf_output(rg, rh, l1, l2, mds)
    valid = (lc_i > 0) & (rc > 0)
    return SplitResult(
        feature=torch.where(valid, feat, -1),
        threshold=torch.full((), thr_bin, dtype=torch.long, device=dev),
        gain=torch.where(valid, torch.inf, K_MIN_SCORE).to(dtype),
        default_left=torch.full((), bool(default_left), device=dev),
        left_sum_gradient=lg, left_sum_hessian=lh - K_EPSILON,
        left_count=lc_i, left_output=lo,
        right_sum_gradient=rg, right_sum_hessian=rh - K_EPSILON,
        right_count=rc, right_output=ro)
