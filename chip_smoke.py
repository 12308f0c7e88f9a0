#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--rounds R]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from csrc/ (one nvcc per source, in
   parallel) and prints the build time;
3. kernel phase: each kernel of the training paths runs on the card at
   the main paths' shapes against its plain PyTorch version on the same
   inputs, with the tolerance stated per kernel, and is timed with CUDA
   events beside the plain version and, where one PyTorch call computes the
   same function, that call; K1, K2, K5 and K6 also kernel-only
   (torch.profiler, without the wrapper's host work).  f32 arenas: K1
   split_scan, K2 segment_histogram, K3 partition_segment (decision mode
   at the root and in place on a 40k-row child, and pred mode with the
   bag's fused histogram at the bagged root and in place on a 40k-row
   child), K4 scatter_segments, K6 compact_carry (255 even leaves in a
   shuffled order, and a skewed tree: one leaf of half the rows, the rest
   down to 20 rows); quantized arenas (int8 codes made on
   the CPU): K2 in int8 mode, K5 fused_refresh_histogram, K3 in both modes
   moving the codes, K6 moving the codes, each held exactly equal to its
   plain version; K7 leaf_histogram over the dataset's row-major bins, f32
   and int8, at the root (every row in leaf 0) and on a leaf of about 40k
   rows scattered over the rows, with one row-list workspace as the grower
   holds it; K8 partition_ablate, K3's stage ablation, at the dataset's row
   count on an f32 and an int8 arena, its full stage held exactly equal to
   K3's plain version;
4. parity phase: a 20k-row, 3-round, 31-leaf run on the card against the
   same run on the CPU (plain versions), with f32 and with quantized
   gradients, unweighted (the carried arena), weighted (the pristine one),
   bagged (0.8 of the rows each round) and with a validation set (the
   eager path), and on the label engine, unbagged and bagged: equal bags,
   split features and leaves of every row in the tree's bag;
5. training phase: a Higgs-shaped binary GBDT (28 dense features,
   num_leaves=255, max_bin=255, min_data_in_leaf=20, learning_rate=0.1,
   10.5M rows by default) trains through lightgbm_tpu_torch.train on the
   card ten times: f32 and then with tpu_quantized_grad=True each, on the
   carried arena; with row weights, which keep the tree rooted at the
   pristine block; bagged (bagging_fraction=0.8, bagging_freq=1), whose
   root is K3 in pred mode; and with the 100k-row holdout as a validation
   set (metric auc, early stopping after 2 rounds without gain), whose last
   evaluated AUC must equal the host prediction's; and f32 on the label
   engine (tpu_tree_engine=label, tpu_histogram_impl=pallas), unbagged and
   bagged, whose every tree must reach 255 leaves; each run predicts the
   holdout; the launch counters, zeroed just before each train call and
   read just after, show that every kernel of that path ran and that no
   kernel of another path did; trees must reach more than one leaf, the
   holdout AUC must reach 0.75, each quantized run's must be within 0.02
   of its f32 run's and each label run's within 0.02 of the valid-set f32
   run's, and each run's within 0.002 of the last accepted run of this
   script (AUC_BEFORE); after each carried, bagged and label run, one more
   round runs under torch.profiler for the device time by kernel;
6. prints one JSON line of training results and one of per-kernel results,
   then the device line {"ok": true, "device": {...}} as the last line.

Exits non-zero, without the device line, when there is no CUDA device, when
the package is missing, or when any phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

ROWS = 10_500_000
FEATURES = 28
CHILD_ROWS = 40_000
LEAVES = 255
PARAMS = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
          "max_bin": 255, "min_data_in_leaf": 20, "verbose": -1}
QPARAMS = dict(PARAMS, tpu_quantized_grad=True)
AUC_FLOOR = 0.75
AUC_GAP = 0.02
# each run's holdout AUC in an earlier accepted run of this script (NVIDIA
# H100 80GB HBM3, 700 W; PERF.md section 5 keeps the runs): a kernel
# rewrite that keeps the partitions and histograms moves none by more
# than AUC_DRIFT
AUC_BEFORE = {"f32": 0.8534, "quantized": 0.8533, "weighted_f32": 0.8559,
              "weighted_quantized": 0.8563, "bagged_f32": 0.8558,
              "bagged_quantized": 0.8556, "valid_f32": 0.8559,
              "valid_quantized": 0.8558, "label_f32": 0.8559,
              "label_bagged_f32": 0.8557}
AUC_DRIFT = 0.002
# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores (the integer adds of the histogram kernels are counted at the
# same rate); bounds below are stated against these, beside the card's power
# limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the __global__ functions of lightgbm_tpu_torch/csrc/*.cu by the kernel
# table's label, as the profiler names them; with the first versions' names
# (K1's second select kernel; K2 and K5 sharing histogram_kernel; K6's two
# launches), so that an older checkout's rounds read alike
KERNEL_NAMES = (
    ("K1", ("split_scan_kernel", "select_best_kernel")),
    ("K2", ("seg_hist_kernel", "SegmentRows<float, false>",
            "SegmentRows<signed char, false>")),
    ("K5", ("fused_root_kernel", "SegmentRows<signed char>",
            "SegmentRows<signed char, true>")),
    ("K3", ("partition_kernel",)),
    ("K4", ("scatter_segments_kernel",)),
    ("K6", ("compact_carry_kernel", "carry_offsets_kernel",
            "carry_copy_kernel")),
    ("K7", ("leaf_select_kernel", "leaf_accumulate_kernel")))


def kernel_label(name: str):
    """The kernel table's label of a device kernel name, or None."""
    for label, parts in KERNEL_NAMES:
        if any(p in name for p in parts):
            return label
    return None
# the training paths.  Carried: no weights, no bag, no validation set (the
# JAX rule); weights keep the tree rooted at the pristine block; a bag or a
# validation set runs the eager path (pristine root, per-row leaf ids), the
# bag's root by K3 in pred mode with its fused histogram; the label engine
# grows every tree over the bag mask with K7 and K1 alone
PATHS = {
    "f32": dict(), "quantized": dict(quantized=True),
    "weighted_f32": dict(weighted=True),
    "weighted_quantized": dict(quantized=True, weighted=True),
    "bagged_f32": dict(bagged=True),
    "bagged_quantized": dict(quantized=True, bagged=True),
    "valid_f32": dict(valid=True),
    "valid_quantized": dict(quantized=True, valid=True),
    "label_f32": dict(label=True),
    "label_bagged_f32": dict(label=True, bagged=True),
}
PARITY_PATHS = ("f32", "quantized", "weighted_f32", "weighted_quantized",
                "bagged_f32", "bagged_quantized", "valid_f32", "label_f32",
                "label_bagged_f32")
# the kernels of the partition engine (K2-K6), none of which the label
# engine may launch
PARTITION_KERNELS = ("segment_histogram", "segment_histogram_i8",
                     "partition_segment", "partition_segment_i8",
                     "partition_segment_pred", "partition_segment_pred_i8",
                     "scatter_segments", "fused_root_histogram",
                     "compact_carry", "compact_carry_i8")
# kernels of the line with no training path, and why
NO_PATH = {
    "leaf_histogram_i8": "the JAX package has no training path for "
                         "leaf_histogram_quantized: its label engine clears "
                         "tpu_quantized_grad (lightgbm_tpu/models/gbdt.py:"
                         "1340-1345)",
    "partition_ablate": "K8 is a measurement tool (tools/kernel_ablate.py), "
                        "on no training path",
}
# the repo's own bagging setting (tests/test_quantized.py:289)
BAGGING = {"bagging_fraction": 0.8, "bagging_freq": 1}
EARLY_STOPPING_ROUNDS = 2


def flag(path: str, name: str) -> bool:
    return bool(PATHS[path].get(name, False))


def carried(path: str) -> bool:
    return not any(flag(path, k)
                   for k in ("weighted", "bagged", "valid", "label"))


def path_params(path: str, **extra) -> dict:
    params = dict(QPARAMS if flag(path, "quantized") else PARAMS, **extra)
    if flag(path, "bagged"):
        params.update(BAGGING)
    if flag(path, "valid"):
        params["metric"] = "auc"
    if flag(path, "label"):
        params.update(tpu_tree_engine="label", tpu_histogram_impl="pallas")
    return params


def path_kernels(path: str) -> tuple:
    """(kernels the path must launch, kernels it must not): the launch
    counter names."""
    if flag(path, "label"):
        return ("leaf_histogram", "split_scan"), PARTITION_KERNELS
    q = flag(path, "quantized")
    sfx = "_i8" if q else ""
    must = ["split_scan", "segment_histogram" + sfx, "partition_segment" + sfx,
            "scatter_segments"]
    never = []
    if flag(path, "bagged"):
        must.append("partition_segment_pred" + sfx)
        never += ["fused_root_histogram", "compact_carry" + sfx]
    else:
        if q:
            must.append("fused_root_histogram")
        (must if carried(path) else never).append("compact_carry" + sfx)
        never.append("partition_segment_pred" + sfx)
    return tuple(must), tuple(never)


SRC = "lightgbm_tpu_torch/csrc/%s.cu"
REPLACES = {
    "split_scan": "lightgbm_tpu/ops/split_pallas.py:242",
    "segment_histogram": "lightgbm_tpu/ops/partition_pallas.py:1019",
    "partition_segment": "lightgbm_tpu/ops/partition_pallas.py:528",
    "scatter_segments": "lightgbm_tpu/ops/partition_pallas.py:820",
    "fused_root_histogram": "lightgbm_tpu/ops/partition_pallas.py:1168",
    "compact_carry": "lightgbm_tpu/ops/partition_pallas.py:691",
    "leaf_histogram": "lightgbm_tpu/ops/histogram_pallas.py:156",
    "leaf_histogram_i8": "lightgbm_tpu/ops/histogram_pallas.py:211",
    "partition_ablate": "tools/kernel_ablate.py:199",
}


def row_weights(n: int, seed: int = 3) -> np.ndarray:
    """Positive row weights in [0.5, 1.5)."""
    return np.random.RandomState(seed).rand(n).astype(np.float32) + 0.5


def higgs_like(n: int, seed: int = 7):
    """bench.py's Higgs-shaped generator: X [n, 28] f32, labels from a
    random linear score plus one interaction; a held-out draw of the same
    distribution."""
    rng = np.random.RandomState(seed)
    n_hold = min(100_000, n // 4)
    X = rng.randn(n, FEATURES).astype(np.float32)
    w = rng.randn(FEATURES)

    def label_of(Xg):
        logits = Xg @ w * 0.5 + 0.8 * np.sin(Xg[:, 0] * 2) * Xg[:, 1]
        return (logits + rng.randn(len(Xg)) > 0).astype(np.float32)

    y = label_of(X)
    Xh = rng.randn(n_hold, FEATURES).astype(np.float32)
    yh = label_of(Xh)
    return X, y, Xh, yh


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over a run of reps back-to-back calls between two
    CUDA events, after warm-up calls."""
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_only_ms(fn, reps: int) -> float:
    """Device ms a call of fn spends in the port's kernels (torch.profiler
    over reps calls after a warm-up): the time without the wrapper's host
    work and without the memsets of its allocations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and kernel_label(ev.name) is not None)
    return us / 1e3 / reps


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Failure(Exception):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def kernel_phase(ds, dev, results, quantized: bool):
    """The kernels of one training path against their plain versions at the
    main path's shapes: K1, K2, K3, K4 and K6 on f32 arenas; K2, K5, K3 and
    K6 on quantized arenas."""
    import torch
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops import split_kernel as sk
    from lightgbm_tpu_torch.ops.split import SplitParams

    n, G = ds.num_data, ds.num_features
    B = int(ds.feature_num_bins().max())
    sfx = "_i8" if quantized else ""
    mode = "int8" if quantized else "f32"
    gen = torch.Generator(device=dev).manual_seed(7)
    bins_t = ds.device_bins(dev).t()
    arenas = []
    for _ in range(2):          # kernel arena, plain arena
        a = pk.Arena(n, G, 6, dev, quantized=quantized)
        pk.init_pristine(a, bins_t)
        arenas.append(a)
    if quantized:
        # the same codes for every version, made on the CPU
        rng = np.random.RandomState(11)
        codes = torch.from_numpy(np.stack([
            rng.randint(-127, 128, n), rng.randint(0, 128, n)]
        ).astype(np.int8)).to(dev)
        for a in arenas:
            a.payload[:, :n] = codes
    else:
        g = torch.randn(n, generator=gen, device=dev)
        h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        for a in arenas:
            a.payload[0, :n] = g
            a.payload[1, :n] = h
    ak, ap = arenas
    work0 = pk.pristine_work0(n)
    n_al = -(-n // pk.TILE) * pk.TILE
    cursor = work0 + n_al

    def entry(name, kernel, r, err, tol, **extra):
        b_ms, b_by = bound(r["bytes"], r.get("ops", 0))
        results[name] = dict(
            name=name, route="cuda", source=SRC % kernel,
            replaces=REPLACES[kernel], mode=mode, launches=0,
            max_abs_err=err, tolerance=tol, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r.get("library_ms"),
            rows=r.get("rows"), **extra)
        if "kernel_ms" in r:
            results[name]["kernel_ms"] = r["kernel_ms"]

    def child(r):
        return dict({k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                       "rows", "kernel_ms") if k in r},
                    bound_ms=bound(r["bytes"], r.get("ops", 0))[0])

    def index_add_ms(a, s, c):
        """One index_add_ of every (feature, row) into the [G*B, 3]
        histogram: the library yardstick of K2 and K5."""
        flat = (torch.arange(G, device=dev)[:, None] * B
                + a.bins[:, s:s + c].long()).reshape(-1)
        p = a.payload[:, s:s + c]
        vdt = torch.int32 if quantized else torch.float32
        vals = torch.stack([p[0].expand(G, c).reshape(-1).to(vdt),
                            p[1].expand(G, c).reshape(-1).to(vdt),
                            torch.ones(G * c, device=dev, dtype=vdt)], dim=1)
        hist0 = torch.zeros((G * B, 3), device=dev, dtype=vdt)
        ms = cuda_ms(lambda: hist0.index_add_(0, flat, vals), 5)
        del flat, vals
        return ms

    # ---- K5 (quantized root) --------------------------------------------
    if quantized:
        seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
        fresh = torch.flip(codes, dims=[1]).contiguous()
        got = pk.fused_refresh_histogram(ak, fresh, seg, B)
        want = pk.fused_refresh_histogram_plain(ap, fresh, seg, B)
        expect(torch.equal(got, want), "K5: histograms differ")
        expect(torch.equal(ak.payload, ap.payload), "K5: code planes differ")
        expect(torch.equal(ak.payload[:, :n], fresh), "K5: codes not written")
        expect(torch.equal(ak.bins, ap.bins) and torch.equal(ak.rid, ap.rid),
               "K5: bins or row ids changed")
        k5 = dict(
            ms=cuda_ms(lambda: pk.fused_refresh_histogram(ak, fresh, seg, B),
                       20),
            kernel_ms=kernel_only_ms(
                lambda: pk.fused_refresh_histogram(ak, fresh, seg, B), 20),
            plain_ms=cuda_ms(lambda: pk.fused_refresh_histogram_plain(
                ap, fresh, seg, B), 3),
            library_ms=index_add_ms(ak, 0, n),
            bytes=pk.fused_refresh_bytes(n, G, B), ops=3 * G * n, rows=n)
        print("K5 fused_refresh_histogram: root %d rows %.4f ms, kernel-only "
              "%.4f (plain %.4f, index_add_ %.4f); exact"
              % (n, k5["ms"], k5["kernel_ms"], k5["plain_ms"],
                 k5["library_ms"]))
        entry("fused_root_histogram", "fused_root_histogram", k5, 0.0,
              "exact")

    # ---- K2 -----------------------------------------------------------
    child_start = 123_456 % max(n - CHILD_ROWS, 1)
    segs = {"root": (0, n), "child": (child_start, min(CHILD_ROWS, n))}
    k2 = {}
    for name, (s, c) in segs.items():
        seg = torch.tensor([s, c], dtype=torch.int32, device=dev)
        got = pk.segment_histogram(ak, seg, B)
        want = pk.segment_histogram_plain(ak, seg, B)
        if quantized:
            expect(torch.equal(got, want), "K2 int8 %s: histograms differ"
                   % name)
            err, rel = 0.0, 0.0
        else:
            # scale for the f32 reassociation tolerance: sums of |g|, h, 1
            absg = ak.payload[:, s:s + c].clone()
            ak.payload[0, s:s + c] = absg[0].abs()
            scale = pk.segment_histogram_plain(ak, seg, B)
            ak.payload[:, s:s + c] = absg
            err_t = (got - want).abs()
            err = float(err_t.max())
            rel = float((err_t / scale.clamp_min(1e-30)).max())
            expect(torch.equal(got[..., 2], want[..., 2]),
                   "K2 %s: counts differ" % name)
            expect(rel <= 1e-5, "K2 %s: error %.3g of the |value| sums "
                   "exceeds rtol 1e-5" % (name, rel))
        k2[name] = dict(
            max_abs_err=err, rel_err=rel,
            ms=cuda_ms(lambda: pk.segment_histogram(ak, seg, B), 20),
            kernel_ms=kernel_only_ms(lambda: pk.segment_histogram(ak, seg, B),
                                     20),
            plain_ms=cuda_ms(lambda: pk.segment_histogram_plain(ak, seg, B),
                             5),
            library_ms=index_add_ms(ak, s, c),
            bytes=pk.segment_histogram_bytes(c, G, B, quantized),
            ops=3 * G * c, rows=c, hist=got)
    print("K2 segment_histogram (%s): root %d rows %.4f ms, kernel-only "
          "%.4f (plain %.4f, index_add_ %.4f); child %d rows %.4f ms, "
          "kernel-only %.4f; rel err %.3g"
          % (mode, n, k2["root"]["ms"], k2["root"]["kernel_ms"],
             k2["root"]["plain_ms"], k2["root"]["library_ms"],
             segs["child"][1], k2["child"]["ms"], k2["child"]["kernel_ms"],
             max(k2["root"]["rel_err"], k2["child"]["rel_err"])))
    entry("segment_histogram" + sfx, "segment_histogram", k2["root"],
          max(k2["root"]["max_abs_err"], k2["child"]["max_abs_err"]),
          "exact" if quantized else
          "counts equal; g/h within 1e-5 of the bin's |value| sum",
          child=child(k2["child"]))

    # ---- K1 (scans the f32 histograms) ----------------------------------
    if not quantized:
        hist2 = torch.stack([k2["root"]["hist"], k2["child"]["hist"]])
        params = SplitParams(min_data_in_leaf=20)
        nb = torch.as_tensor(ds.feature_num_bins(), device=dev)
        db = torch.as_tensor(np.array([m.default_bin for m in ds.bin_mappers],
                                      np.int32), device=dev)
        mt = torch.as_tensor(np.array([m.missing_type
                                       for m in ds.bin_mappers], np.int32),
                             device=dev)
        fvec = sk.build_feature_statics(nb, db, mt, children=2)
        svec = sk.child_vector(hist2[:, 0, :, 0].sum(1),
                               hist2[:, 0, :, 1].sum(1),
                               hist2[:, 0, :, 2].sum(1))
        pvec = sk.params_vector(params, dev)
        rows_k, best_k = sk.split_scan(hist2, fvec, svec, pvec)
        rows_p, best_p = sk.split_scan_plain(hist2, fvec, svec, pvec)
        lanes = [sk._OF, sk._OT, sk._ODL]
        expect(torch.equal(rows_k[:, lanes], rows_p[:, lanes]),
               "K1: feature, threshold or default_left differ")
        expect(torch.equal(best_k[:, lanes], best_p[:, lanes]),
               "K1: selected feature or threshold differ")
        valid = rows_p[:, sk._OG] > sk.NEG_GATE
        k1_err = (float((rows_k - rows_p)[valid].abs().max())
                  if valid.any() else 0.0)
        gain_rel = (float(((rows_k[:, sk._OG] - rows_p[:, sk._OG]).abs()
                           / rows_p[:, sk._OG].abs())[valid].max())
                    if valid.any() else 0.0)
        expect(gain_rel <= 1e-5, "K1: gain rel err %.3g exceeds 1e-5"
               % gain_rel)
        k1_bytes, k1_ops = sk.scan_bytes_and_ops(2, G, B)
        k1 = dict(ms=cuda_ms(lambda: sk.split_scan(hist2, fvec, svec, pvec),
                             50),
                  kernel_ms=kernel_only_ms(
                      lambda: sk.split_scan(hist2, fvec, svec, pvec), 50),
                  plain_ms=cuda_ms(lambda: sk.split_scan_plain(
                      hist2, fvec, svec, pvec), 5),
                  bytes=k1_bytes, ops=k1_ops, library_ms=None)
        print("K1 split_scan: CH=2 F=%d B=%d %.4f ms, kernel-only %.4f "
              "(plain %.4f); gain rel err %.3g, %d valid features"
              % (G, B, k1["ms"], k1["kernel_ms"], k1["plain_ms"], gain_rel,
                 int(valid.sum())))
        entry("split_scan", "split_scan", k1, k1_err,
              "feature, threshold, default_left equal; gain rtol 1e-5",
              shape="CH=2 F=%d B=%d" % (G, B))
    del k2

    # ---- K3 in pred mode with the fused histogram (the bagged root) -------
    # an 0.8 bag from a fixed seed; in-bag rows to work0, the others past
    # them, the bag's histogram in the same pass (hist_stream=0)
    bag = torch.from_numpy(
        (np.random.RandomState(13).rand(n) < 0.8).astype(np.uint8)).to(dev)
    oob = work0 + n_al
    sc_k = torch.tensor([0, n, work0, oob, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)
    sc_p = sc_k.clone()
    got = pk.partition_segment_pred(ak, sc_k, bag, hist_stream=0, max_bin=B)
    want = pk.partition_segment_pred_plain(ap, sc_p, bag, 0, B)
    expect(torch.equal(sc_k, sc_p), "K3 pred: counts differ")
    n_in = int(sc_k[pk.SC_CNT_A])
    expect(n_in == int(bag.sum()), "K3 pred: %d rows in the bag, %d counted"
           % (int(bag.sum()), n_in))
    for s, c in ((work0, n_in), (oob, n - n_in)):
        for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid[None], ap.rid[None])):
            expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                   "K3 pred: planes differ")
    if quantized:
        expect(torch.equal(got, want), "K3 pred: int8 histograms differ")
        err = 0.0
    else:
        expect(torch.equal(got[..., 2], want[..., 2]),
               "K3 pred: histogram counts differ")
        rows = ap.payload[:, work0:work0 + n_in].clone()
        ap.payload[0, work0:work0 + n_in] = rows[0].abs()
        scale = pk.segment_histogram_plain(
            ap, torch.tensor([work0, n_in], dtype=torch.int32, device=dev), B)
        ap.payload[:, work0:work0 + n_in] = rows
        err_t = (got - want).abs()
        err = float(err_t.max())
        rel = float((err_t / scale.clamp_min(1e-30)).max())
        expect(rel <= 1e-5, "K3 pred: histogram error %.3g of the |value| "
               "sums exceeds rtol 1e-5" % rel)
    # library yardsticks, one call each: the stable sort of the predicate
    # (as K3's row has) and index_add_ of the bag's histogram
    bag_key = 1 - bag
    sort_ms = cuda_ms(lambda: torch.sort(bag_key, stable=True), 5)
    k3p = dict(
        ms=cuda_ms(lambda: pk.partition_segment_pred(ak, sc_k, bag, 0, B),
                   10),
        plain_ms=cuda_ms(lambda: pk.partition_segment_pred_plain(
            ap, sc_p, bag, 0, B), 3),
        library_ms=sort_ms, index_add_ms=index_add_ms(ak, work0, n_in),
        bytes=pk.partition_pred_bytes(n, G, B, quantized),
        ops=3 * G * n_in, rows=n)
    print("K3 partition_segment_pred (%s payload, hist_stream=0): root %d "
          "rows, %d in the bag, %.4f ms (plain %.4f, stable sort %.4f, "
          "index_add_ %.4f); planes and counts exact, histogram %s"
          % (mode, n, n_in, k3p["ms"], k3p["plain_ms"], sort_ms,
             k3p["index_add_ms"], "exact" if quantized
             else "max abs err %.3g" % err))
    # the same pass in place on a ~40k-row child of the bag (its first
    # columns at work0): stream A over the segment itself, by a predicate
    # over those columns
    c_rows = min(CHILD_ROWS, n_in)
    dst_c = oob + n_al
    bag_c = torch.zeros(work0 + c_rows, dtype=torch.uint8, device=dev)
    bag_c[work0:] = torch.from_numpy((np.random.RandomState(14).rand(c_rows)
                                      < 0.8).astype(np.uint8)).to(dev)
    sc_k = torch.tensor([work0, c_rows, work0, dst_c, 0, 0, 0, 0],
                        dtype=torch.int32, device=dev)
    sc_p = sc_k.clone()
    got = pk.partition_segment_pred(ak, sc_k, bag_c, hist_stream=0, max_bin=B)
    want = pk.partition_segment_pred_plain(ap, sc_p, bag_c, 0, B)
    expect(torch.equal(sc_k, sc_p), "K3 pred child: counts differ")
    c_in = int(sc_k[pk.SC_CNT_A])
    for s, c in ((work0, c_in), (dst_c, c_rows - c_in)):
        for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid[None], ap.rid[None])):
            expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                   "K3 pred child: planes differ")
    if quantized:
        expect(torch.equal(got, want), "K3 pred child: int8 histograms "
               "differ")
    else:
        expect(torch.equal(got[..., 2], want[..., 2]),
               "K3 pred child: histogram counts differ")
        rows = ap.payload[:, work0:work0 + c_in].clone()
        ap.payload[0, work0:work0 + c_in] = rows[0].abs()
        scale = pk.segment_histogram_plain(
            ap, torch.tensor([work0, c_in], dtype=torch.int32, device=dev), B)
        ap.payload[:, work0:work0 + c_in] = rows
        err_c = float((got - want).abs().max())
        rel = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
        expect(rel <= 1e-5, "K3 pred child: histogram error %.3g of the "
               "|value| sums exceeds rtol 1e-5" % rel)
        err = max(err, err_c)
    # the child's pass keeps its segment in place, so it repeats on the
    # same rows
    bag_key_c = 1 - bag_c[work0:]
    k3pc = dict(
        ms=cuda_ms(lambda: pk.partition_segment_pred(ak, sc_k, bag_c, 0, B),
                   20),
        plain_ms=cuda_ms(lambda: pk.partition_segment_pred_plain(
            ap, sc_p, bag_c, 0, B), 5),
        library_ms=cuda_ms(lambda: torch.sort(bag_key_c, stable=True), 5),
        bytes=pk.partition_pred_bytes(c_rows, G, B, quantized),
        ops=3 * G * c_in, rows=c_rows)
    print("K3 partition_segment_pred (%s payload, hist_stream=0), in place "
          "on a child of %d rows: %.4f ms (plain %.4f, stable sort %.4f)"
          % (mode, c_rows, k3pc["ms"], k3pc["plain_ms"], k3pc["library_ms"]))
    entry("partition_segment_pred" + sfx, "partition_segment", k3p, err,
          "planes and counts exact; histogram " + (
              "exact" if quantized else
              "counts equal, g/h within 1e-5 of the bin's |value| sum"),
          library="torch.sort(stable) of the predicate; index_add_ of the "
                  "histogram timed apart (library_index_add_ms)",
          library_index_add_ms=k3p["index_add_ms"], in_bag=n_in,
          child=child(k3pc))
    del bag, bag_c, bag_key, bag_key_c, got, want

    # ---- K3 -----------------------------------------------------------
    chan = 0
    goleft = (torch.arange(256, device=dev) <= 127).to(torch.uint8)

    def make_sc(s, c, da, db_, xr):
        return torch.tensor([s, c, da, db_, 0, 0, chan, xr],
                            dtype=torch.int32, device=dev)

    def compare_regions(regions, what):
        for s, c in regions:
            for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload)):
                expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                       "K3 %s: planes differ" % what)
            expect(torch.equal(ak.rid[s:s + c], ap.rid[s:s + c]),
                   "K3 %s: row ids differ" % what)

    k3 = {}
    sc_k = make_sc(0, n, work0, cursor, 1)
    sc_p = sc_k.clone()
    pk.partition_segment(ak, sc_k, goleft)
    pk.partition_segment_plain(ap, sc_p, goleft)
    expect(torch.equal(sc_k, sc_p), "K3 root: counts differ")
    n_b, n_a = int(sc_k[pk.SC_CNT_B]), int(sc_k[pk.SC_CNT_A])
    root_regions = [(work0, n_a), (cursor, n_b)]
    compare_regions(root_regions, "root")
    lib_key = (goleft[ak.bins[chan, :n].long()] != 0).to(torch.uint8)
    k3["root"] = dict(
        ms=cuda_ms(lambda: pk.partition_segment(ak, sc_k, goleft), 10),
        plain_ms=cuda_ms(lambda: pk.partition_segment_plain(
            ap, sc_p, goleft), 3),
        library_ms=cuda_ms(lambda: torch.sort(lib_key, stable=True), 5),
        bytes=pk.partition_bytes(n, G, quantized), rows=n)
    # the main path's in-place case: a ~40k-row child of the root's A stream
    c_rows = min(CHILD_ROWS, n_a)
    dst_b2 = cursor + -(-n_b // pk.ALLOC) * pk.ALLOC
    sc_k = make_sc(work0, c_rows, work0, dst_b2, 0)
    sc_p = sc_k.clone()
    pk.partition_segment(ak, sc_k, goleft)
    pk.partition_segment_plain(ap, sc_p, goleft)
    expect(torch.equal(sc_k, sc_p), "K3 child: counts differ")
    compare_regions([(work0, int(sc_k[pk.SC_CNT_A])),
                     (dst_b2, int(sc_k[pk.SC_CNT_B]))], "child")
    lib_key_c = (goleft[ak.bins[chan, work0:work0 + c_rows].long()] != 0
                 ).to(torch.uint8)
    k3["child"] = dict(
        ms=cuda_ms(lambda: pk.partition_segment(ak, sc_k, goleft), 20),
        plain_ms=cuda_ms(lambda: pk.partition_segment_plain(
            ap, sc_p, goleft), 5),
        library_ms=cuda_ms(lambda: torch.sort(lib_key_c, stable=True), 5),
        bytes=pk.partition_bytes(c_rows, G, quantized), rows=c_rows)
    print("K3 partition_segment (%s payload): root %d rows %.4f ms (plain "
          "%.4f, stable sort %.4f); child %d rows %.4f ms; exact"
          % (mode, n, k3["root"]["ms"], k3["root"]["plain_ms"],
             k3["root"]["library_ms"], c_rows, k3["child"]["ms"]))
    entry("partition_segment" + sfx, "partition_segment", k3["root"], 0.0,
          "exact", child=child(k3["child"]))

    # 255 leaf segments over the root split's output regions (every row
    # once, row ids permuted by the partition); redo the root split so both
    # regions hold the permutation again
    pieces = []
    for s, c in root_regions:
        k = LEAVES // 2 + (1 if s == work0 else 0)
        cuts = np.linspace(0, c, k + 1).astype(np.int64)
        pieces += [(s + int(cuts[i]), int(cuts[i + 1] - cuts[i]))
                   for i in range(k)]
    for a in arenas:
        pk.partition_segment(a, make_sc(0, n, work0, cursor, 1), goleft)
    seg = torch.tensor(pieces, dtype=torch.int32, device=dev)
    nl = torch.tensor([LEAVES], dtype=torch.int32, device=dev)

    # ---- K4 (payload-independent: measured with the f32 arenas) ----------
    if not quantized:
        vals = torch.randn(LEAVES, generator=gen, device=dev)
        out_k = torch.zeros(n, device=dev)
        out_p = torch.zeros(n, device=dev)
        pk.scatter_segments(ak, seg, vals, nl, out_k)
        pk.scatter_segments_plain(ak, seg, vals, nl, out_p)
        expect(torch.equal(out_k, out_p), "K4: row-ordered outputs differ")
        rid_all = torch.cat([ak.rid[s:s + c].long() for s, c in pieces])
        val_all = torch.cat([vals[i].expand(c)
                             for i, (_s, c) in enumerate(pieces)])
        k4 = dict(
            ms=cuda_ms(lambda: pk.scatter_segments(ak, seg, vals, nl, out_k),
                       20),
            plain_ms=cuda_ms(lambda: pk.scatter_segments_plain(
                ak, seg, vals, nl, out_p), 3),
            library_ms=cuda_ms(lambda: out_p.index_put_((rid_all,), val_all),
                               5),
            bytes=pk.scatter_bytes(n, LEAVES), rows=n)
        print("K4 scatter_segments: %d rows %d leaves %.4f ms (plain %.4f, "
              "index_put_ %.4f); exact" % (n, LEAVES, k4["ms"],
                                           k4["plain_ms"], k4["library_ms"]))
        entry("scatter_segments", "scatter_segments", k4, 0.0, "exact")
        del rid_all, val_all, out_k, out_p

    # ---- K6 -----------------------------------------------------------
    # two layouts of the root split's output regions, compacted past both
    # regions: the 255 even leaves in a shuffled order, so leaf-index order
    # is not column order; and a skewed tree's leaves (one of half the
    # rows, the rest geometric down to 20 rows, cut where they cross from
    # one region to the other), as a real tree's sizes spread
    order = np.random.RandomState(5).permutation(LEAVES)
    rest = np.maximum(20, (n / 4 * 0.96 ** np.arange(LEAVES - 1)).astype(int))
    rest = np.maximum(20, rest * (n - n // 2) // max(int(rest.sum()), 1))
    sizes = np.concatenate([[n // 2], rest])
    sizes[0] += n - int(sizes.sum())
    cuts = np.concatenate([[0], np.cumsum(sizes)])
    skewed, v0 = [], 0
    for s, c in root_regions:
        for a, b in zip(cuts[:-1], cuts[1:]):
            lo, hi = max(int(a), v0), min(int(b), v0 + c)
            if lo < hi:
                skewed.append((s + lo - v0, hi - lo))
        v0 += c
    layouts = {
        "even": [pieces[i] for i in order],
        "skewed": [skewed[i] for i in np.random.RandomState(6).permutation(
            len(skewed))]}
    dst0 = cursor + n_al + pk.TILE
    k6 = {}
    for what, lay in layouts.items():
        seg6 = torch.tensor(lay, dtype=torch.int32, device=dev)
        nl6 = torch.tensor([len(lay)], dtype=torch.int32, device=dev)
        used_k = pk.compact_carry(ak, seg6, nl6, dst0)
        used_p = pk.compact_carry_plain(ap, seg6, nl6, dst0)
        expect(int(used_k[0]) == int(used_p[0]) == n,
               "K6 %s: rows written differ" % what)
        for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                         (ak.rid[None], ap.rid[None])):
            expect(torch.equal(pk_[:, dst0:dst0 + n], pp_[:, dst0:dst0 + n]),
                   "K6 %s: compacted planes differ" % what)
        cols = torch.cat([torch.arange(s, s + c, device=dev)
                          for s, c in lay])
        k6[what] = dict(
            ms=cuda_ms(lambda: pk.compact_carry(ak, seg6, nl6, dst0), 20),
            kernel_ms=kernel_only_ms(
                lambda: pk.compact_carry(ak, seg6, nl6, dst0), 20),
            plain_ms=cuda_ms(lambda: pk.compact_carry_plain(
                ap, seg6, nl6, dst0), 3),
            library_ms=cuda_ms(lambda: torch.index_select(ak.bins, 1, cols),
                               5),
            bytes=pk.compact_carry_bytes(n, G, len(lay), quantized), rows=n,
            leaves=len(lay), largest=max(c for _s, c in lay),
            smallest=min(c for _s, c in lay))
    print("K6 compact_carry (%s payload): %d rows, %d even leaves %.4f ms, "
          "kernel-only %.4f (plain %.4f, index_select of the bins %.4f); "
          "%d skewed leaves (%d to %d rows) %.4f ms, kernel-only %.4f; exact"
          % (mode, n, LEAVES, k6["even"]["ms"], k6["even"]["kernel_ms"],
             k6["even"]["plain_ms"], k6["even"]["library_ms"],
             k6["skewed"]["leaves"], k6["skewed"]["smallest"],
             k6["skewed"]["largest"], k6["skewed"]["ms"],
             k6["skewed"]["kernel_ms"]))
    entry("compact_carry" + sfx, "compact_carry", k6["even"], 0.0, "exact",
          library="torch.index_select of the bin planes over the "
                  "precomputed column list", skewed=dict(
              child(k6["skewed"]), leaves=k6["skewed"]["leaves"],
              smallest=k6["skewed"]["smallest"],
              largest=k6["skewed"]["largest"]))
    del arenas, ak, ap, cols
    torch.cuda.empty_cache()


def leaf_kernel_phase(ds, dev, results):
    """K7 over the dataset's row-major device bins, f32 and int8, against
    its plain versions: the root (every row in leaf 0) and a leaf of about
    CHILD_ROWS rows spread over all rows, as a 255-leaf tree's leaves lie
    in the label engine's leaf ids."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_kernel as hk

    n, F = ds.num_data, ds.num_features
    B = int(ds.feature_num_bins().max())
    bins = ds.device_bins(dev)
    rng = np.random.RandomState(17)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    h = torch.from_numpy((rng.rand(n) * 0.25 + 0.01).astype(np.float32)
                         ).to(dev)
    gq = torch.from_numpy(rng.randint(-127, 128, n).astype(np.int8)).to(dev)
    hq = torch.from_numpy(rng.randint(0, 128, n).astype(np.int8)).to(dev)
    leaves = rng.randint(0, LEAVES, n)
    child = int(np.argmin(np.abs(np.bincount(leaves) - CHILD_ROWS)))
    ids = {"root": np.zeros(n, np.int64), "child": leaves}
    work = hk.row_list(n, dev)      # the row list, as a grower holds it
    for quantized in (False, True):
        name = "leaf_histogram_i8" if quantized else "leaf_histogram"
        fn = hk.leaf_histogram_quantized if quantized else hk.leaf_histogram
        plain = (hk.leaf_histogram_quantized_plain if quantized
                 else hk.leaf_histogram_plain)
        pg, ph = (gq, hq) if quantized else (g, h)
        r = {}
        for what, lid in ids.items():
            leaf_ids = torch.from_numpy(lid.astype(
                np.uint8 if quantized else np.int32)).to(dev)
            leaf = torch.tensor([0 if what == "root" else child],
                                dtype=torch.int32, device=dev)
            got = fn(bins, pg, ph, leaf_ids, leaf, B, work)
            want = plain(bins, pg, ph, leaf_ids, leaf, B)
            m = int((lid == int(leaf[0])).sum())
            expect(int(want[0, :, 2].sum()) == m, "K7 %s: counts %d of %d"
                   % (what, int(want[0, :, 2].sum()), m))
            if quantized:
                expect(torch.equal(got, want), "K7 int8 %s: histograms "
                       "differ" % what)
                err = 0.0
            else:
                expect(torch.equal(got[..., 2], want[..., 2]),
                       "K7 %s: counts differ" % what)
                scale = plain(bins, pg.abs(), ph, leaf_ids, leaf, B)
                err_t = (got - want).abs()
                err = float(err_t.max())
                rel = float((err_t / scale.clamp_min(1e-30)).max())
                expect(rel <= 1e-5, "K7 %s: error %.3g of the |value| sums "
                       "exceeds rtol 1e-5" % (what, rel))
            # the library yardstick: one index_add_ of the leaf's (feature,
            # row) pairs into the [F*B, 3] histogram
            rows = (leaf_ids.to(torch.int32) == leaf).nonzero()[:, 0]
            flat = (torch.arange(F, device=dev)[None, :] * B
                    + bins.index_select(0, rows).long()).reshape(-1)
            vdt = torch.int32 if quantized else torch.float32
            vals = torch.stack([pg[rows].to(vdt), ph[rows].to(vdt),
                                torch.ones(m, dtype=vdt, device=dev)], dim=1
                               ).repeat_interleave(F, dim=0)
            hist0 = torch.zeros((F * B, 3), dtype=vdt, device=dev)
            r[what] = dict(
                max_abs_err=err, rows=m,
                ms=cuda_ms(lambda: fn(bins, pg, ph, leaf_ids, leaf, B, work),
                           20),
                plain_ms=cuda_ms(lambda: plain(bins, pg, ph, leaf_ids, leaf,
                                               B), 3),
                library_ms=cuda_ms(lambda: hist0.index_add_(0, flat, vals),
                                   5),
                bytes=hk.leaf_histogram_bytes(n, m, F, B, quantized),
                ops=3 * F * m)
            del flat, vals, rows
        print("K7 %s: root %d rows %.4f ms (plain %.4f, index_add_ %.4f); "
              "child leaf of %d rows %.4f ms (plain %.4f, index_add_ %.4f); "
              "%s" % (name, n, r["root"]["ms"], r["root"]["plain_ms"],
                      r["root"]["library_ms"], r["child"]["rows"],
                      r["child"]["ms"], r["child"]["plain_ms"],
                      r["child"]["library_ms"], "exact" if quantized else
                      "max abs err %.3g" % max(r["root"]["max_abs_err"],
                                               r["child"]["max_abs_err"])))
        b_ms, b_by = bound(r["root"]["bytes"], r["root"]["ops"])
        results[name] = dict(
            name=name, route="cuda", source=SRC % "leaf_histogram",
            replaces=REPLACES[name], mode="int8" if quantized else "f32",
            launches=0,
            max_abs_err=max(r["root"]["max_abs_err"],
                            r["child"]["max_abs_err"]),
            tolerance="exact" if quantized else
            "counts equal; g/h within 1e-5 of the bin's |value| sum",
            ms=r["root"]["ms"], plain_ms=r["root"]["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r["root"]["library_ms"],
            library="index_add_ of the leaf's (feature, row) pairs",
            rows=n, child=dict(
                {k: r["child"][k] for k in ("ms", "plain_ms", "library_ms",
                                            "rows")},
                bound_ms=bound(r["child"]["bytes"], r["child"]["ops"])[0]))
    del g, h, gq, hq, work
    torch.cuda.empty_cache()


def ablate_phase(n: int, dev, results):
    """K8: K3's stages timed at n rows on an f32 and an int8 arena
    (lightgbm_tpu_torch.tools.kernel_ablate), the full stage held exactly
    equal to K3's plain version inside run()."""
    import torch
    from lightgbm_tpu_torch.tools import kernel_ablate

    r = kernel_ablate.run(n, device=dev)
    for arena, a in r.items():
        prev = 0.0
        steps = []
        for stage, ms in a["ms"].items():
            steps.append("%s %.4f (+%.4f)" % (stage, ms, ms - prev))
            prev = ms
        print("K8 partition_ablate (%s arena, %d rows, F=%d): ms a pass by "
              "cumulative stage: %s; K3 plain %.4f, stable sort %.4f; full "
              "stage exact" % (arena, n, kernel_ablate.FEATURES,
                               ", ".join(steps), a["plain_ms"],
                               a["library_ms"]))
    f = r["f32"]
    b_ms, b_by = bound(f["bytes"], 0)
    results["partition_ablate"] = dict(
        name="partition_ablate", route="cuda", source=SRC % "partition_ablate",
        replaces=REPLACES["partition_ablate"], mode="f32", launches=0,
        max_abs_err=0.0, tolerance="full stage exact (K3's plain version)",
        ms=f["ms"]["full"], plain_ms=f["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=f["library_ms"],
        library="torch.sort(stable) of the side key, as K3's",
        rows=n, stages_ms={k: v["ms"] for k, v in r.items()},
        int8=dict(ms=r["int8"]["ms"]["full"], plain_ms=r["int8"]["plain_ms"],
                  library_ms=r["int8"]["library_ms"],
                  bound_ms=bound(r["int8"]["bytes"], 0)[0]))
    torch.cuda.empty_cache()


def parity_phase(dev, path: str):
    """A small run on the card against the same run on the CPU, stepped
    with update() so each tree's bag can be read."""
    import lightgbm_tpu_torch as lt
    quantized = flag(path, "quantized")
    X, y, Xh, yh = higgs_like(20_000, seed=11)
    w = row_weights(len(y)) if flag(path, "weighted") else None
    params = path_params(path, num_leaves=31)
    out = {}
    for d in (dev, "cpu"):
        ds = lt.Dataset(X, y, weight=w, device=d)
        bst = lt.Booster(params, ds, device=d)
        if flag(path, "valid"):
            bst.add_valid(lt.Dataset(Xh, yh, reference=ds, device=d),
                          "holdout")
        bags, evals = [], []
        for _ in range(3):
            bst.update()
            mask = bst._gbdt._bag_mask
            bags.append(None if mask is None else mask.copy())
            evals.append(bst.eval_valid())
        g = bst._gbdt
        expect(g._quantized is quantized
               and bool(g._carried_active) is carried(path),
               "parity %s: the %s run took another path" % (path, d))
        out[str(d)] = (bst, bags, evals)
    (bk, bags_k, evals_k), (bc, bags_c, evals_c) = out[str(dev)], out["cpu"]
    gb, cb = bk._gbdt.models, bc._gbdt.models
    expect(len(gb) == len(cb) == 3, "parity %s: tree counts differ" % path)
    moved, oob_moved = [], []
    for t, (a, b) in enumerate(zip(gb, cb)):
        bag = bags_k[t]
        expect((bag is None) == (bags_c[t] is None)
               and (bag is None or np.array_equal(bag, bags_c[t])),
               "parity %s: the bags of tree %d differ" % (path, t))
        k = a.num_leaves - 1
        expect(a.num_leaves == b.num_leaves
               and np.array_equal(a.split_feature[:k], b.split_feature[:k]),
               "parity %s: card and CPU trees split on different features"
               % path)
        # a threshold may move across bins that hold no row of the node's
        # bag: both thresholds then split its rows alike and their gains
        # tie up to the reassociation of the f32 sums (K2's atomics, the
        # root sum); rows out of the bag in those bins then take the other
        # way, in that tree only
        moved.append(int((a.threshold_in_bin[:k]
                          != b.threshold_in_bin[:k]).sum()))
        differ = a.predict_leaf_index(X) != b.predict_leaf_index(X)
        in_bag = np.ones(len(y), bool) if bag is None else bag == 0
        expect(not differ[in_bag].any(),
               "parity %s: rows of tree %d's bag land in different leaves"
               % (path, t))
        oob_moved.append(int(differ.sum()))
        expect(not differ.any() or moved[-1] > 0,
               "parity %s: out-of-bag rows of tree %d land in different "
               "leaves with no threshold moved" % (path, t))
        if not any(oob_moved[:-1]):
            # before any out-of-bag row took another way, the scores and
            # so the gradients of the next tree agree as without a bag
            expect(np.allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                               rtol=1e-4, atol=1e-6),
                   "parity %s: leaf values differ" % path)
    pg = bk.predict(X, raw_score=True)
    pc = bc.predict(X, raw_score=True)
    err = float(np.abs(pg - pc).max())
    expect(np.all(np.isfinite(pg)) and (err <= 1e-4 or any(oob_moved)),
           "parity %s: raw training predictions differ by %.3g" % (path, err))
    msg = ("parity (%s): 20000 rows, 3 rounds, 31 leaves: card and CPU trees "
           "split on the same features with every %s in the same leaf "
           "(thresholds moved across empty bins, per tree: %s); raw training "
           "prediction max diff %.3g"
           % (path, "row" if w is not None or not flag(path, "bagged")
              else "row of the bag", moved, err))
    if flag(path, "bagged"):
        msg += ("; equal bags of %d rows each round; out-of-bag rows in "
                "another leaf per tree: %s" % (int((bags_k[0] == 0).sum()),
                                               oob_moved))
    if flag(path, "valid"):
        vk = [e[0][2] for e in evals_k]
        vc = [e[0][2] for e in evals_c]
        expect(np.all(np.isfinite(vk)), "parity %s: holdout AUC not finite"
               % path)
        msg += "; holdout AUC per round card %s, CPU %s" % (vk, vc)
    print(msg)
    return dict(thresholds_moved=moved, oob_rows_moved=oob_moved,
                max_raw_diff=err)


def training_phase(X, Xh, yh, ds_obj, valid_obj, rounds, dev, reduced, path):
    """A main path: lightgbm_tpu_torch.train on the card, then predict on
    the holdout.  The launch counters are zeroed just before train and read
    just after."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc
    from lightgbm_tpu_torch.ops import _cuda

    quantized = flag(path, "quantized")
    ds_obj.set_weight(row_weights(len(X)) if flag(path, "weighted")
                      else None)
    kw = {}
    evals = {}
    if flag(path, "valid"):
        kw = dict(valid_sets=[valid_obj], valid_names=["holdout"],
                  early_stopping_rounds=EARLY_STOPPING_ROUNDS,
                  evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lt.train(path_params(path), ds_obj, num_boost_round=rounds,
                       device=dev, **kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    g = booster._gbdt
    expect(g._quantized is quantized
           and bool(g._carried_active) is carried(path),
           "%s training: quantized %s, carried %s" % (path, g._quantized,
                                                      g._carried_active))
    if flag(path, "bagged"):
        expect(g._bag_count == int(BAGGING["bagging_fraction"] * len(X)),
               "%s training: %s rows in the bag" % (path, g._bag_count))
    must, never = path_kernels(path)
    for name in must:
        expect(launches.get(name, 0) > 0, "kernel %s was not launched on the "
               "%s training path" % (name, path))
    for name in never:
        expect(launches.get(name, 0) == 0, "kernel %s was launched on the "
               "%s training path" % (name, path))
    t = time.perf_counter()
    pred = booster.predict(Xh)
    predict_s = time.perf_counter() - t
    expect(pred.shape == (len(Xh),) and np.all(np.isfinite(pred)),
           "%s holdout predictions are not finite [n]" % path)
    leaves = [m.num_leaves for m in g.models]
    trained = len(leaves)
    expect((trained == rounds or flag(path, "valid")) and min(leaves) > 1,
           "%s trees did not grow: leaves %s" % (path, leaves))
    if flag(path, "label"):
        # the label engine has no arena to run out of
        expect(not g._use_partition_engine and g.arena is None
               and min(leaves) == LEAVES,
               "%s: the label engine grew leaves %s" % (path, leaves))
    holdout_auc = auc(yh, pred)
    expect(holdout_auc >= AUC_FLOOR, "%s holdout AUC %.4f < %.2f"
           % (path, holdout_auc, AUC_FLOOR))
    extra = ""
    if flag(path, "valid"):
        # the validation score, kept on the card by the binned walk, against
        # the host walk of the same trees
        last = evals["holdout"]["auc"][-1]
        expect(len(evals["holdout"]["auc"]) == trained
               and abs(last - holdout_auc) <= 1e-6,
               "%s: last evals_result AUC %.8f, host predict AUC %.8f"
               % (path, last, holdout_auc))
        extra = ("; evals_result holdout AUC %s, best_iteration %d"
                 % (evals["holdout"]["auc"], booster.best_iteration))
    round_ms = train_s * 1e3 / trained
    rate = len(X) * trained / train_s
    arena = "carried arena" if carried(path) else (
        "label engine, eager" if flag(path, "label") else
        "pristine arena, eager" if flag(path, "bagged") or flag(path, "valid")
        else "pristine arena")
    print("training (%s, %s): %d rows%s x %d features, "
          "%d rounds, leaves %s; train %.3f s (%.1f ms a round, %.4g "
          "rows*rounds/s, set-up included); peak device memory %.3f GB; "
          "holdout AUC %.4f on %d rows (predict %.3f s)%s"
          % (path, arena, len(X), " (cut by --rows)" if reduced else "",
             X.shape[1], trained, leaves, train_s, round_ms, rate,
             peak / 1e9, holdout_auc, len(Xh), predict_s, extra))
    return booster, launches, dict(
        train_s=train_s, round_ms=round_ms, rows_rounds_per_s=rate,
        peak_bytes=peak, holdout_auc=holdout_auc, leaves=leaves,
        predict_s=predict_s, rows=len(X), launches=launches,
        evals_result=evals or None, best_iteration=booster.best_iteration)


def profile_round(booster, what: str) -> dict:
    """One more boosting round under torch.profiler: its wall time, the
    device time of every kernel by name, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, cnt + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the twelve longest, and every kernel of the port's own sources
    top = [kv for i, kv in enumerate(ranked)
           if i < 12 or kernel_label(kv[0]) is not None]
    by_kernel = {}
    for name, (ms, cnt) in by_name.items():
        label = kernel_label(name)
        if label is not None:
            k = by_kernel.setdefault(label, dict(ms=0.0, launches=0))
            k["ms"] += ms
            k["launches"] += cnt
    if not by_name:
        print("profile (%s): the profiler saw no device events; device time "
              "not measured" % what)
        return dict(wall_ms=wall_ms, device_ms=None, idle_share=None)
    print("profile of one %s round (profiler on): wall %.1f ms, device busy "
          "%.1f ms, idle share %.3f, %d device launches"
          % (what, wall_ms, busy_ms, 1 - busy_ms / wall_ms,
             sum(c for _, c in by_name.values())))
    for name, (ms, cnt) in top:
        print("  %9.3f ms %6d x  %s" % (ms, cnt, name[:90]))
    print("  port kernels, device ms (launches): %s" % ", ".join(
        "%s %.3f (%d)" % (k, v["ms"], v["launches"])
        for k, v in sorted(by_kernel.items())))
    return dict(wall_ms=wall_ms, device_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms,
                device_launches=sum(c for _, c in by_name.values()),
                by_kernel=by_kernel,
                top=[dict(name=n[:90], ms=ms, count=c) for n, (ms, c) in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="training rows (the widths are never cut)")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print("torch %s, CUDA %s, python %s" % (torch.__version__,
                                           torch.version.cuda,
                                           sys.version.split()[0]))
    dev = torch.device("cuda", torch.cuda.current_device())

    t = time.perf_counter()
    log = _cuda.build(verbose=True)
    print("build: %.1f s for %s" % (time.perf_counter() - t,
                                   ", ".join(log["compiled"])))
    for stem, text in sorted(log["output"].items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas %s: %s" % (stem, line.strip()))

    t = time.perf_counter()
    X, y, Xh, yh = higgs_like(args.rows)
    ds_obj = lt.Dataset(X, y, params=PARAMS, device=dev).construct()
    print("data: %d x %d generated and binned in %.1f s"
          % (X.shape[0], X.shape[1], time.perf_counter() - t))

    valid_obj = lt.Dataset(Xh, yh, reference=ds_obj, device=dev).construct()
    results = {}
    for quantized in (False, True):
        kernel_phase(ds_obj._binned, dev, results, quantized)
    leaf_kernel_phase(ds_obj._binned, dev, results)
    ablate_phase(len(X), dev, results)
    parity = {path: parity_phase(dev, path) for path in PARITY_PATHS}
    train = {}
    launches = {}
    for path in PATHS:
        booster, launches[path], train[path] = training_phase(
            X, Xh, yh, ds_obj, valid_obj, args.rounds, dev,
            args.rows != ROWS, path)
        if carried(path) or flag(path, "bagged") or flag(path, "label"):
            train[path]["profile"] = profile_round(booster, path)
        del booster
        torch.cuda.empty_cache()
    for f32 in ("f32", "weighted_f32", "bagged_f32", "valid_f32"):
        q = f32.replace("f32", "quantized")
        gap = abs(train[q]["holdout_auc"] - train[f32]["holdout_auc"])
        expect(gap <= AUC_GAP, "%s holdout AUC is %.4f from the %s run's "
               "(limit %.2f)" % (q, gap, f32, AUC_GAP))
    for path in PATHS:
        drift = abs(train[path]["holdout_auc"] - AUC_BEFORE[path])
        expect(drift <= AUC_DRIFT, "%s holdout AUC %.4f is %.4f from the "
               "last accepted run's %.4f (limit %.3f)"
               % (path, train[path]["holdout_auc"], drift, AUC_BEFORE[path],
                  AUC_DRIFT))
    # the label engine grows the same 255-leaf f32 trees as the partition
    # engine at the pristine root (the valid-set run's)
    for path in ("label_f32", "label_bagged_f32"):
        gap = abs(train[path]["holdout_auc"] - train["valid_f32"]["holdout_auc"])
        expect(gap <= AUC_GAP, "%s holdout AUC is %.4f from the valid_f32 "
               "run's (limit %.2f)" % (path, gap, AUC_GAP))
    # launches of each kernel in the run of the path it belongs to: K3's
    # pred mode in the bagged runs, the int8 modes and K5 in the quantized
    # carried run, the f32 modes in the f32 carried run, K7 in the label
    # run; the kernels both carried paths run (K1, K4) report the quantized
    # run; launches_by_path has every path's run.  The kernels of NO_PATH
    # are on no training path and report 0
    for name, r in results.items():
        r["launches_by_path"] = {p: int(launches[p].get(name, 0))
                                 for p in launches}
        if name in NO_PATH:
            r["launches"] = 0
            r["no_path"] = NO_PATH[name]
            expect(not any(r["launches_by_path"].values()),
                   "kernel %s was launched on a training path" % name)
            continue
        if name == "leaf_histogram":
            path = "label_f32"
        elif name.startswith("partition_segment_pred"):
            path = "bagged_quantized" if name.endswith("_i8") else "bagged_f32"
        elif name in ("segment_histogram", "partition_segment",
                      "compact_carry"):
            path = "f32"
        else:
            path = "quantized"
        r["launches"] = int(launches[path].get(name, 0))
        expect(r["launches"] > 0, "kernel %s was not launched on the %s "
               "training path" % (name, path))
    print(json.dumps({"card": card, "training": train, "parity": parity}))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print("chip_smoke: FAILED: %s" % exc, file=sys.stderr)
        sys.exit(1)
