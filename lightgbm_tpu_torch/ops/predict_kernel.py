"""KP1 and KP2: the walk kernels of device prediction and of the eager
paths' score updates.

Both are port-only: the JAX package walks with plain jnp or a signature
matmul, with no Pallas kernel (csrc/predict_ensemble.cu and
csrc/walk_binned.cu say what each replaces).  As for every kernel of the
port, the tensor's device decides: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.

- `predict_ensemble` (KP1): an ensemble's walk tables (ops/predict.py)
  over raw f32 or f64 rows, summing leaf values in f64, with early stop,
  or writing each row's leaf per tree, by row tiles or, for a small
  batch, by (tree, row) pairs and an ordered sum; plain versions
  ops/predict.predict_ensemble_plain and, for the small batch,
  tree_values_plain with ordered_sum_plain.
- `walk_binned` (KP2): one device tree (ops/grow.TreeArrays) over the
  bins [n, G] (uint8, or int16 holding uint16 bins; a column a feature,
  or EFB group columns decoded through ops/grow.BundleMaps), its
  categorical nodes by their bin sets, writing each row's leaf or adding
  a leaf value to the row's f32 or f64 score (all rows, or the rows whose
  leaf id is -1, the others adding the value of their leaf id); plain
  version ops/grow.predict_leaf_inner and the same adds.  Counted as
  `walk_binned` (leaf mode), `walk_binned_add` and
  `walk_binned_masked_add`, with `_u16` for uint16 bins and `_f64` for an
  f64 score.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .grow import BundleMaps, TreeArrays, predict_leaf_inner
from .predict import (MODE_LEAF, MODE_SUM, MODE_SUM_EARLY_STOP,
                      EnsembleTables, ordered_sum_plain,
                      predict_ensemble_plain, tree_values_plain)

_TABLE_NAMES = ("items", "tree_off", "group_off", "cat_off", "cat_bound",
                "cat_words")
# the small-batch walk takes a batch of at most this many (tree, row)
# pairs (its [T, n] f64 scratch at most 256 MB) and at most _SMALL_ROWS
# rows; larger batches walk by row tiles.  On an H100 over 500 trees the
# small walk beat the row tiles at every batch that
# tools/compare_builds.py --only KP1 timed, up to 100k rows (64k: 1.24
# against 1.74 ms; 100k: 1.80 against 1.91; PERF.md, KP1)
_SMALL_PAIRS = 1 << 25
_SMALL_ROWS = 65536


def small_batch(m: int, T: int) -> bool:
    """Whether KP1 walks m rows of T trees by (tree, row) pairs: batches
    too small to fill the card with row tiles."""
    return m <= _SMALL_ROWS and m * T <= _SMALL_PAIRS


def predict_ensemble(tb: EnsembleTables, X: torch.Tensor, T: int, k: int,
                     out: torch.Tensor, row0: int = 0, mode: int = MODE_SUM,
                     freq: int = 0, margin: float = 0.0,
                     small: Optional[bool] = None) -> None:
    """KP1 over the m rows of X [m, F] (f32 or f64, each value compared in
    f64), which are rows row0.. of out: sum modes write out[:, row0:row0+m]
    ([k, n] f64), leaf mode out[row0:row0+m] ([n, T] int32).  T trees
    t < T are walked; early stop (mode MODE_SUM_EARLY_STOP) needs
    freq >= 1.  small: the small-batch walk (True) or the row tiles
    (False); by default small_batch(m, T) decides.  Counted as
    `predict_ensemble` (row tiles) and `predict_ensemble_small`."""
    dev = X.device
    m, F = X.shape
    if mode not in (MODE_SUM, MODE_SUM_EARLY_STOP, MODE_LEAF):
        raise ValueError("unknown mode %r" % mode)
    if mode == MODE_SUM_EARLY_STOP and freq < 1:
        raise ValueError("early stop needs freq >= 1")
    ntrees = tb.tree_off.shape[0] - 1
    if not 0 <= T <= ntrees:
        raise ValueError("T=%d outside the ensemble's %d trees" % (T, ntrees))
    if F <= tb.max_feature:
        raise ValueError("X has %d features, and a node reads feature %d"
                         % (F, tb.max_feature))
    for name in _TABLE_NAMES:
        _cuda.require(getattr(tb, name), name, torch.int32, dev)
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError("X: dtype %s, expected torch.float32 or "
                        "torch.float64" % X.dtype)
    _cuda.require(X, "X", X.dtype, dev)
    leaf = mode == MODE_LEAF
    if leaf:
        _cuda.require(out, "out", torch.int32, dev)
        if out.dim() != 2 or out.shape[1] != T or out.shape[0] < row0 + m:
            raise ValueError("out: shape %s for rows %d.. of T=%d"
                             % (tuple(out.shape), row0, T))
    else:
        _cuda.require(out, "out", torch.float64, dev)
        if out.dim() != 2 or out.shape[0] != k or out.shape[1] < row0 + m:
            raise ValueError("out: shape %s for rows %d.. of k=%d"
                             % (tuple(out.shape), row0, k))
    if m == 0:
        return
    if small is None:
        small = small_batch(m, T)
    if not _cuda.plain_or_cuda(dev):
        if leaf:
            out[row0:row0 + m] = predict_ensemble_plain(tb, X, T, k, mode)
        elif small:
            out[:, row0:row0 + m] = ordered_sum_plain(
                tree_values_plain(tb, X, T), k, mode, freq, margin)
        else:
            out[:, row0:row0 + m] = predict_ensemble_plain(
                tb, X, T, k, mode, freq, margin)
        return
    n_total = out.shape[0] if leaf else out.shape[1]
    if leaf:
        o_ptr, l_ptr = 0, out.data_ptr() + 4 * row0 * T
    else:
        o_ptr, l_ptr = out.data_ptr() + 8 * row0, 0
    args = [*(getattr(tb, name).data_ptr() for name in _TABLE_NAMES),
            X.data_ptr(), int(X.dtype == torch.float32), m, F,
            tb.max_feature + 1, T, k, mode, max(freq, 1), float(margin),
            tb.stage_items, o_ptr, n_total, l_ptr]
    if small:
        vals = None if leaf else torch.empty((T, m), dtype=torch.float64,
                                             device=dev)
        rc = _cuda.fn("lgbt_predict_ensemble_small")(
            *args, 0 if vals is None else vals.data_ptr(), _cuda.stream(dev))
        _cuda.check(rc, "predict_ensemble_small")
    else:
        rc = _cuda.fn("lgbt_predict_ensemble")(*args, _cuda.stream(dev))
        _cuda.check(rc, "predict_ensemble")


_WALK_LEAF, _WALK_MASKED_ADD, _WALK_ADD = 0, 1, 2


def walk_binned_plain(bins: torch.Tensor, tree: TreeArrays,
                      num_bins: torch.Tensor, default_bins: torch.Tensor,
                      lv: Optional[torch.Tensor] = None,
                      score: Optional[torch.Tensor] = None,
                      leaf_ids: Optional[torch.Tensor] = None,
                      bundle: Optional[BundleMaps] = None):
    """KP2 in plain PyTorch: the leaf of every row (no score), or
    `score += lv[leaf]` in place, with leaf_ids >= 0 taking the place of
    the walk's leaf where given."""
    leaf = predict_leaf_inner(bins, tree, num_bins, default_bins, bundle)
    if score is None:
        return leaf
    if leaf_ids is not None:
        leaf = torch.where(leaf_ids >= 0, leaf_ids, leaf)
    score.add_(lv[leaf.long()])
    return None


def cat_set_bytes(W: int) -> int:
    """Bytes of a node's bin set over W bins: 32 (256 bins) up to 256
    bins, ceil(W / 8) past them."""
    return max(32, -(-W // 8))


def cat_bit_sets(cat_mask: torch.Tensor) -> torch.Tensor:
    """uint8 [N, S] (S = cat_set_bytes(W)): each node's left-going bins
    [N, W] as a bit set, bit b in byte b // 8 at b % 8, bins past W
    clear; built on the device with no host copy, so it captures into a
    round graph."""
    N, W = cat_mask.shape
    S = cat_set_bytes(W)
    full = torch.nn.functional.pad(cat_mask.to(torch.uint8), (0, 8 * S - W))
    weight = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.uint8, device=cat_mask.device),
        torch.arange(8, dtype=torch.uint8, device=cat_mask.device))
    return (full.view(N, S, 8) * weight).sum(dim=2, dtype=torch.uint8)


def walk_binned(bins: torch.Tensor, tree: TreeArrays,
                num_bins: torch.Tensor, default_bins: torch.Tensor,
                lv: Optional[torch.Tensor] = None,
                score: Optional[torch.Tensor] = None,
                leaf_ids: Optional[torch.Tensor] = None,
                bundle: Optional[BundleMaps] = None):
    """KP2: one tree over bins [n, G] (uint8, or int16 holding uint16
    bins), num_bins and default_bins [F] per feature; with `bundle` the G
    columns are EFB groups (G = F without).  With no score: returns each
    row's leaf (int32 [n]).  With lv ([L]) and score ([n]), both f32 or
    both f64: adds lv[leaf] to every row's score in place (one add in the
    score's type), and with leaf_ids (int32 [n]) only the rows whose id is
    -1 walk, the others adding lv[leaf_ids].  A tree whose cat_mask is
    wider than 0 walks its categorical nodes by their bin sets
    (`cat_bit_sets`)."""
    dev = bins.device
    n, G = bins.shape
    F = num_bins.shape[0]
    if bins.dtype != torch.int16:
        _cuda.require(bins, "bins", torch.uint8, dev)
    _cuda.require(bins, "bins", bins.dtype, dev)
    N = tree.split_feature.shape[0]
    for name, dtype in (("split_feature", torch.int32),
                        ("threshold_bin", torch.int32),
                        ("default_left", torch.bool),
                        ("missing_type", torch.int32),
                        ("left_child", torch.int32),
                        ("right_child", torch.int32)):
        _cuda.require(getattr(tree, name), name, dtype, dev, (N,))
    nl = tree.num_leaves.reshape(())
    _cuda.require(nl, "num_leaves", torch.int32, dev, ())
    _cuda.require(num_bins, "num_bins", torch.int32, dev, (F,))
    _cuda.require(default_bins, "default_bins", torch.int32, dev, (F,))
    if bundle is None and F != G:
        raise ValueError("bins has %d columns for %d features without a "
                         "bundle" % (G, F))
    if bundle is not None:
        for name in ("feat_col", "feat_lo", "feat_hi", "feat_shift"):
            _cuda.require(getattr(bundle, name), name, torch.int32, dev,
                          (F,))
    has_cat = tree.cat_mask.shape[1] > 0
    if has_cat:
        _cuda.require(tree.is_cat, "is_cat", torch.bool, dev, (N,))
        _cuda.require(tree.cat_mask, "cat_mask", torch.bool, dev)
    if score is None:
        if lv is not None or leaf_ids is not None:
            raise ValueError("lv and leaf_ids need a score")
        mode = _WALK_LEAF
        out = torch.empty(n, dtype=torch.int32, device=dev)
    else:
        if score.dtype not in (torch.float32, torch.float64):
            raise TypeError("score: dtype %s, expected float32 or float64"
                            % score.dtype)
        _cuda.require(score, "score", score.dtype, dev, (n,))
        if lv is None:
            raise ValueError("a score update needs lv")
        _cuda.require(lv, "lv", score.dtype, dev)
        if leaf_ids is not None:
            _cuda.require(leaf_ids, "leaf_ids", torch.int32, dev, (n,))
        mode = _WALK_ADD if leaf_ids is None else _WALK_MASKED_ADD
        out = None
    if not _cuda.plain_or_cuda(dev):
        got = walk_binned_plain(bins, tree, num_bins, default_bins, lv,
                                score, leaf_ids, bundle)
        return got if out is not None else None
    if n == 0:
        return out

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    bits = cat_bit_sets(tree.cat_mask) if has_cat else None
    wide = score is not None and score.dtype == torch.float64
    rc = _cuda.fn("lgbt_walk_binned")(
        tree.split_feature.data_ptr(), tree.threshold_bin.data_ptr(),
        tree.default_left.data_ptr(), tree.missing_type.data_ptr(),
        tree.left_child.data_ptr(), tree.right_child.data_ptr(),
        nl.data_ptr(), N, ptr(tree.is_cat if has_cat else None), ptr(bits),
        0 if bits is None else bits.shape[1],
        *(ptr(None if bundle is None else getattr(bundle, name))
          for name in ("feat_col", "feat_lo", "feat_hi", "feat_shift")),
        bins.data_ptr(), bins.element_size(), n, G, num_bins.data_ptr(),
        default_bins.data_ptr(), mode, ptr(lv), ptr(leaf_ids), ptr(out),
        ptr(score), 8 if wide else 4, _cuda.stream(dev))
    _cuda.check(rc, ("walk_binned", "walk_binned_masked_add",
                     "walk_binned_add")[mode]
                + ("_u16" if bins.dtype == torch.int16 else "")
                + ("_f64" if wide else ""))
    return out

