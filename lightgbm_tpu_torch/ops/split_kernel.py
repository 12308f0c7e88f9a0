"""K1: the numerical best-split scan for CH stacked children, one launch.

Port of lightgbm_tpu/ops/split_pallas.py (`_split_scan_kernel`, launched by
`_run_scan`).  `split_scan` launches the CUDA kernel of
`csrc/split_scan.cu` on CUDA tensors and runs `split_scan_plain`, the same
function in plain PyTorch, on CPU tensors.  Both compute the Pallas
kernel's semantics, including its order of prefix sums (Hillis-Steele
doubling over the bin axis), so the kernel and the plain version agree bit
for bit up to the order of the gain arithmetic:

- sum_h + 2*K_EPSILON, +K_EPSILON on the directional hessians, and
  -K_EPSILON on the hessians of the selected row;
- the NEG=-1e38 "no split" sentinel, compared against NEG_GATE;
- desc beats asc at equal gain; inside desc the higher threshold wins,
  inside asc the lower; across features the lowest feature id wins;
- the no-valid-split guard (gain NEG, feature -1) and the 2-bin NaN
  default-right rule.

Counts ride f32 prefix sums, exact below 2^24 rows; the grower checks
n < 2^24.

Layouts: hist [CH, F, B, 3] f32; fvec [CH*F, 8] (columns _NB.._CEGBF);
svec [CH, 8] (_SG.._MAXC); pvec [8] (_L1.._CEGBS).  Outputs: per-feature
rows [CH*F, ROW_W] and each child's selected row [CH, ROW_W], lanes
_OG.._ORO.
"""
from __future__ import annotations

import torch

from . import _cuda
from .split import K_EPSILON, K_MIN_SCORE, PerFeatureSplit, SplitParams

NEG = -1e38
NEG_GATE = -1e37

_NB, _DB, _MT, _MONO, _PEN, _FMASK, _CEGBF = range(7)
_SG, _SH, _ND, _MINC, _MAXC = range(5)
_L1, _L2, _MDS, _MINCNT, _MINH, _MINGAIN, _CEGBS = range(7)
(_OG, _OF, _OT, _ODL, _OLG, _OLH, _OLC, _OLO,
 _ORG, _ORH, _ORC, _ORO) = range(12)
ROW_W = 12
MAX_BINS = 1024     # one thread a bin in the CUDA kernel, 32 warps a block


def build_feature_statics(num_bins, default_bins, missing_types,
                          monotone=None, penalty=None, feature_mask=None,
                          cegb_feature_penalty=None,
                          children: int = 1) -> torch.Tensor:
    """[CH*F, 8] f32 per-feature statics (split_pallas.build_feature_statics)."""
    dev = num_bins.device
    F = num_bins.shape[0]

    def col(v, fill):
        if v is None:
            return torch.full((F,), fill, dtype=torch.float32, device=dev)
        return v.to(device=dev, dtype=torch.float32)

    one = torch.stack([col(num_bins, 0), col(default_bins, 0),
                       col(missing_types, 0), col(monotone, 0),
                       col(penalty, 1), col(feature_mask, 1),
                       col(cegb_feature_penalty, 0),
                       torch.zeros(F, dtype=torch.float32, device=dev)], dim=1)
    return one.repeat(children, 1).contiguous()


def cegb_statics(fvec: torch.Tensor, coupled: torch.Tensor,
                 used: torch.Tensor, children: int) -> torch.Tensor:
    """fvec [CH*F, 8] with its CEGB column set to the coupled penalty of
    each feature not yet used (coupled [F], used [F] bool), as the JAX
    growers patch it before each scan (grow_partition.py:362-367): built
    on the device, so a round graph captures it."""
    pen = torch.where(used, torch.zeros((), device=fvec.device),
                      coupled.to(fvec.dtype)).to(fvec.dtype)
    return torch.cat([fvec[:, :_CEGBF], pen.repeat(children)[:, None],
                      fvec[:, _CEGBF + 1:]], dim=1)


def params_vector(params: SplitParams, device) -> torch.Tensor:
    """pvec [8] f32 (split_pallas._pack_inputs)."""
    return torch.tensor(
        [params.lambda_l1, params.lambda_l2, params.max_delta_step,
         params.min_data_in_leaf, params.min_sum_hessian_in_leaf,
         params.min_gain_to_split, params.cegb_split_penalty, 0.0],
        dtype=torch.float32, device=device)


def child_vector(sum_g, sum_h, num_data, min_c=None, max_c=None
                 ) -> torch.Tensor:
    """svec [CH, 8] f32 from [CH] per-child sums (split_pallas._pack_inputs)."""
    sum_g = torch.as_tensor(sum_g, dtype=torch.float32).reshape(-1)
    dev, CH = sum_g.device, sum_g.shape[0]

    def col(v, fill):
        if v is None:
            return torch.full((CH,), fill, dtype=torch.float32, device=dev)
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(CH)

    z = torch.zeros(CH, dtype=torch.float32, device=dev)
    return torch.stack([sum_g, col(sum_h, 0.0), col(num_data, 0.0),
                        col(min_c, -torch.inf), col(max_c, torch.inf),
                        z, z, z], dim=1)


def _prefix_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis by Hillis-Steele doubling,
    the association order of the Pallas and CUDA kernels."""
    n = x.shape[-1]
    sh = 1
    while sh < n:
        x = x + torch.nn.functional.pad(x[..., :n - sh], (sh, 0))
        sh *= 2
    return x


def split_scan_plain(hist, fvec, svec, pvec):
    """The scan in plain PyTorch: (rows [CH*F, ROW_W], best [CH, ROW_W])."""
    CH, F, B, _ = hist.shape
    R = CH * F
    dev = hist.device
    f32 = torch.float32
    h3 = hist.reshape(R, B, 3)
    l1, l2, mds = pvec[_L1], pvec[_L2], pvec[_MDS]
    min_cnt = torch.clamp_min(pvec[_MINCNT], 1.0)
    min_hess, min_gain, cegb_split = pvec[_MINH], pvec[_MINGAIN], pvec[_CEGBS]
    nb, db, mt = fvec[:, _NB:_NB + 1], fvec[:, _DB:_DB + 1], fvec[:, _MT:_MT + 1]
    mono, pen = fvec[:, _MONO:_MONO + 1], fvec[:, _PEN:_PEN + 1]
    fmask, cegb_f = fvec[:, _FMASK:_FMASK + 1], fvec[:, _CEGBF:_CEGBF + 1]
    sv = svec.repeat_interleave(F, dim=0)                   # [R, 8]
    sum_g = sv[:, _SG:_SG + 1]
    sum_h = sv[:, _SH:_SH + 1] + 2 * K_EPSILON
    num_data = sv[:, _ND:_ND + 1]
    minc, maxc = sv[:, _MINC:_MINC + 1], sv[:, _MAXC:_MAXC + 1]

    bins_f = torch.arange(B, device=dev, dtype=f32)[None, :].expand(R, B)
    in_range = bins_f < nb
    excl = ((((mt == 1.0) & (bins_f == db)) | ((mt == 2.0) & (bins_f == nb - 1.0)))
            & in_range & (nb > 2.0))
    live = in_range & ~excl
    zero = torch.zeros((), dtype=f32, device=dev)
    pref = _prefix_lanes(torch.stack([torch.where(live, h3[..., k], zero)
                                      for k in range(3)]))
    cg, ch, cc = pref[0], pref[1], pref[2]
    tg, th, tc = cg[:, B - 1:B], ch[:, B - 1:B], cc[:, B - 1:B]

    def thr_l1(s):
        return torch.sign(s) * torch.clamp_min(torch.abs(s) - l1, 0.0)

    def leaf_out(g, h):
        ret = -thr_l1(g) / (h + l2)
        use_clip = (mds > 0.0) & (torch.abs(ret) > mds)
        return torch.where(use_clip, torch.sign(ret) * mds, ret)

    def gain_given(g, h, out):
        return -(2.0 * thr_l1(g) * out + (h + l2) * out * out)

    parent_out = leaf_out(sum_g, sum_h)
    min_gain_shift = gain_given(sum_g, sum_h, parent_out) + min_gain

    def eval_dir(lg, lh, lc):
        rg, rh, rc = sum_g - lg, sum_h - lh, num_data - lc
        lo = torch.minimum(torch.maximum(leaf_out(lg, lh), minc), maxc)
        ro = torch.minimum(torch.maximum(leaf_out(rg, rh), minc), maxc)
        gain = gain_given(lg, lh, lo) + gain_given(rg, rh, ro)
        violates = ((mono > 0.0) & (lo > ro)) | ((mono < 0.0) & (lo < ro))
        gain = torch.where(violates, zero, gain)
        valid = ((lc >= min_cnt) & (rc >= min_cnt)
                 & (lh >= min_hess) & (rh >= min_hess))
        return gain, lo, ro, valid, (lg, lh, lc, rg, rh, rc)

    asc = eval_dir(cg, ch + K_EPSILON, cc)
    desc = eval_dir(sum_g - (tg - cg), sum_h - (th - ch + K_EPSILON),
                    num_data - (tc - cc))
    thr_ok = bins_f <= nb - 2.0
    asc_ok = thr_ok & (mt != 0.0) & (nb > 2.0)
    neg = torch.full((), NEG, dtype=f32, device=dev)

    def masked(d, ok):
        return torch.where(ok & d[3] & (d[0] > min_gain_shift), d[0], neg)

    asc_m, desc_m = masked(asc, asc_ok), masked(desc, thr_ok)
    big = torch.full((), 1e9, dtype=f32, device=dev)
    asc_best = asc_m.max(dim=1, keepdim=True).values
    asc_thr = torch.where(asc_m == asc_best, bins_f, big).min(
        dim=1, keepdim=True).values                       # low theta wins ties
    desc_best = desc_m.max(dim=1, keepdim=True).values
    desc_thr = torch.where(desc_m == desc_best, bins_f, -big).max(
        dim=1, keepdim=True).values                       # high theta wins ties
    use_desc = desc_best >= asc_best                      # desc wins ties
    best_gain = torch.maximum(desc_best, asc_best)
    best_thr = torch.where(use_desc, desc_thr, asc_thr)
    at = best_thr.long()

    def pick(a, d):
        v = torch.where(use_desc, d, a)
        return torch.gather(v, 1, at)

    lo_p, ro_p = pick(asc[1], desc[1]), pick(asc[2], desc[2])
    stats = [pick(a, d) for a, d in zip(asc[4], desc[4])]
    rel = (best_gain - min_gain_shift) * pen - cegb_split * num_data - cegb_f
    has = best_gain > NEG_GATE
    feat_gain = torch.where(has & (rel > 0.0) & (fmask > 0.5), rel, neg)
    two_bin_nan = (mt == 2.0) & (nb <= 2.0)
    dl = (use_desc & ~two_bin_nan).to(f32)
    feat_id = (torch.arange(R, device=dev) % F).to(f32)[:, None]
    rows = torch.cat([feat_gain, feat_id, best_thr, dl, stats[0], stats[1],
                      stats[2], lo_p, stats[3], stats[4], stats[5], ro_p], dim=1)
    return rows, select_rows_plain(rows, CH, F)


def select_rows_plain(rows: torch.Tensor, CH: int, F: int) -> torch.Tensor:
    """In-kernel select_best_feature: each child's max-gain row, lowest
    feature id on ties, the no-split sentinel row when none is valid, and
    the directional +eps removed from both hessian lanes."""
    r = rows.reshape(CH, F, ROW_W)
    g = r[:, :, _OG]
    best = g.max(dim=1, keepdim=True).values
    idx = torch.arange(F, device=rows.device).expand(CH, F)
    first = torch.where(g == best, idx, torch.full_like(idx, F)).min(dim=1).values
    picked = r[torch.arange(CH, device=rows.device), first]      # [CH, ROW_W]
    has = (best[:, 0] > NEG_GATE)[:, None]
    picked = torch.where(has, picked, torch.zeros_like(picked))
    lane = torch.arange(ROW_W, device=rows.device)[None, :]
    picked = torch.where((lane == _OG) & ~has, NEG, picked)
    picked = torch.where((lane == _OF) & ~has, -1.0, picked)
    return torch.where((lane == _OLH) | (lane == _ORH),
                       picked - K_EPSILON, picked)


# the select's tickets, one int32 a child, per (device, stream): zeroed
# once, and left zero by every launch (csrc/split_scan.cu), so launches on
# one stream may follow each other and launches on two streams never share
# a ticket
_TICKETS = {}


def _tickets(dev: torch.device, stream: int, CH: int) -> torch.Tensor:
    key = (dev, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < CH:
        t = torch.zeros(max(CH, 8), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def split_scan(hist: torch.Tensor, fvec: torch.Tensor, svec: torch.Tensor,
               pvec: torch.Tensor):
    """K1 on hist's device: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Returns (rows [CH*F, ROW_W], best
    [CH, ROW_W]).  The kernel runs on the device's current stream, with
    that stream's tickets."""
    CH, F, B, three = hist.shape
    dev = hist.device
    if three != 3 or not 1 <= B <= MAX_BINS:
        raise ValueError("hist must be [CH, F, B<=%d, 3], got %s"
                         % (MAX_BINS, tuple(hist.shape)))
    f32 = torch.float32
    _cuda.require(hist, "hist", f32, dev)
    _cuda.require(fvec, "fvec", f32, dev, (CH * F, 8))
    _cuda.require(svec, "svec", f32, dev, (CH, 8))
    _cuda.require(pvec, "pvec", f32, dev, (8,))
    if not _cuda.plain_or_cuda(dev):
        return split_scan_plain(hist, fvec, svec, pvec)
    # one allocation for both outputs
    out = torch.empty((CH * F + CH, ROW_W), dtype=f32, device=dev)
    ptr = out.data_ptr()
    stream = _cuda.stream(dev)
    rc = _cuda.fn("lgbt_split_scan")(
        hist.data_ptr(), fvec.data_ptr(), svec.data_ptr(), pvec.data_ptr(),
        ptr, ptr + CH * F * ROW_W * 4, _tickets(dev, stream, CH).data_ptr(),
        CH, F, B, stream)
    _cuda.check(rc, "split_scan")
    return out[:CH * F], out[CH * F:]


def best_splits(hist, sum_g, sum_h, num_data, fvec, params: SplitParams,
                min_constraints=None, max_constraints=None) -> PerFeatureSplit:
    """[CH, F]-batched PerFeatureSplit (split_pallas.best_splits_pallas)."""
    CH, F, B, _ = hist.shape
    dev = hist.device
    svec = child_vector(torch.as_tensor(sum_g, device=dev), sum_h, num_data,
                        min_constraints, max_constraints).to(dev)
    rows, _ = split_scan(hist.contiguous(), fvec, svec,
                         params_vector(params, dev))
    out = rows.reshape(CH, F, ROW_W)
    gain = out[..., _OG]
    return PerFeatureSplit(
        gain=torch.where(gain <= NEG_GATE, K_MIN_SCORE, gain),
        threshold=out[..., _OT].long(),
        default_left=out[..., _ODL] > 0.5,
        left_sum_gradient=out[..., _OLG], left_sum_hessian=out[..., _OLH],
        left_count=torch.round(out[..., _OLC]).long(),
        left_output=out[..., _OLO],
        right_sum_gradient=out[..., _ORG], right_sum_hessian=out[..., _ORH],
        right_count=torch.round(out[..., _ORC]).long(),
        right_output=out[..., _ORO])


def best_split_rows(hist, sum_g, sum_h, num_data, fvec, params: SplitParams,
                    min_constraints=None, max_constraints=None
                    ) -> torch.Tensor:
    """[CH, ROW_W] selected rows (split_pallas.best_split_rows_pallas)."""
    dev = hist.device
    svec = child_vector(torch.as_tensor(sum_g, device=dev), sum_h, num_data,
                        min_constraints, max_constraints).to(dev)
    return split_scan(hist.contiguous(), fvec, svec,
                      params_vector(params, dev))[1]


def scan_bytes_and_ops(CH: int, F: int, B: int) -> tuple:
    """(bytes, f32 operations) the scan must spend: every input read once,
    every output written once; ~70 f32 operations per (row, bin): three
    prefix sums of log2(B) adds and two directions of gain math."""
    nbytes = 4 * (CH * F * B * 3 + CH * F * 8 + CH * 8 + 8
                  + CH * F * ROW_W + CH * ROW_W)
    return nbytes, CH * F * B * 70


def no_split_row(device, dtype=torch.float32) -> torch.Tensor:
    """The split-cache row of a leaf with no valid split (f32, or f64 on
    the label engine's f64 path)."""
    row = torch.zeros(ROW_W, dtype=dtype, device=device)
    row[_OG].fill_(NEG)         # fills on the device, no host copy
    row[_OF].fill_(-1.0)
    return row

