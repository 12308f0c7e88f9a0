#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--rounds R]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from csrc/ (one nvcc per source, in
   parallel) and prints the build time;
3. kernel phase: each kernel of the two training paths runs on the card at
   the main paths' shapes against its plain PyTorch version on the same
   inputs, with the tolerance stated per kernel, and is timed with CUDA
   events beside the plain version and, where one PyTorch call computes the
   same function, that call.  f32 arenas: K1 split_scan, K2
   segment_histogram, K3 partition_segment, K4 scatter_segments, K6
   compact_carry; quantized arenas (int8 codes made on the CPU): K2 in int8
   mode, K5 fused_refresh_histogram, K3 moving the codes, K6 moving the
   codes, each held exactly equal to its plain version;
4. parity phase: a 20k-row, 3-round, 31-leaf run on the card against the
   same run on the CPU (plain versions), with f32 and with quantized
   gradients, unweighted (the carried arena) and weighted (the pristine
   one);
5. training phase: a Higgs-shaped binary GBDT (28 dense features,
   num_leaves=255, max_bin=255, min_data_in_leaf=20, learning_rate=0.1,
   10.5M rows by default) trains through lightgbm_tpu_torch.train on the
   card four times: with f32 gradients and then with tpu_quantized_grad=True,
   both on the carried arena, then both again with row weights, which keep
   the tree rooted at the pristine block (the non-carried path); each run
   predicts a 100k-row holdout; the launch counters, zeroed just before each
   train call and read just after, show that every kernel of that path ran;
   trees must reach more than one leaf, the holdout AUC must reach 0.75 and
   each quantized run's must be within 0.02 of its f32 run's; after each
   unweighted run, one more round runs under torch.profiler for the device
   time by kernel;
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
# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores (the integer adds of the histogram kernels are counted at the
# same rate); bounds below are stated against these, beside the card's power
# limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the __global__ functions of lightgbm_tpu_torch/csrc/*.cu
PORT_KERNELS = ("split_scan_kernel", "select_best_kernel", "histogram_kernel",
                "count_kernel", "scatter_kernel", "copy_back_kernel",
                "scatter_segments_kernel", "carry_offsets_kernel",
                "carry_copy_kernel")
# the training paths: (quantized, weighted); weights keep the tree rooted
# at the pristine block, without them the port runs the carried arena
PATHS = {"f32": (False, False), "quantized": (True, False),
         "weighted_f32": (False, True), "weighted_quantized": (True, True)}
# the kernels each training path must launch (their launch-counter names)
PATH_KERNELS = {
    "f32": ("split_scan", "segment_histogram", "partition_segment",
            "scatter_segments", "compact_carry"),
    "quantized": ("split_scan", "segment_histogram_i8", "fused_root_histogram",
                  "partition_segment_i8", "scatter_segments",
                  "compact_carry_i8"),
    "weighted_f32": ("split_scan", "segment_histogram", "partition_segment",
                     "scatter_segments"),
    "weighted_quantized": ("split_scan", "segment_histogram_i8",
                           "fused_root_histogram", "partition_segment_i8",
                           "scatter_segments"),
}
SRC = "lightgbm_tpu_torch/csrc/%s.cu"
REPLACES = {
    "split_scan": "lightgbm_tpu/ops/split_pallas.py:242",
    "segment_histogram": "lightgbm_tpu/ops/partition_pallas.py:1019",
    "partition_segment": "lightgbm_tpu/ops/partition_pallas.py:528",
    "scatter_segments": "lightgbm_tpu/ops/partition_pallas.py:820",
    "fused_root_histogram": "lightgbm_tpu/ops/partition_pallas.py:1168",
    "compact_carry": "lightgbm_tpu/ops/partition_pallas.py:691",
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

    def child(r):
        return dict({k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                       "rows")},
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
            plain_ms=cuda_ms(lambda: pk.fused_refresh_histogram_plain(
                ap, fresh, seg, B), 3),
            library_ms=index_add_ms(ak, 0, n),
            bytes=pk.fused_refresh_bytes(n, G, B), ops=3 * G * n, rows=n)
        print("K5 fused_refresh_histogram: root %d rows %.4f ms (plain %.4f, "
              "index_add_ %.4f); exact" % (n, k5["ms"], k5["plain_ms"],
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
            plain_ms=cuda_ms(lambda: pk.segment_histogram_plain(ak, seg, B),
                             5),
            library_ms=index_add_ms(ak, s, c),
            bytes=pk.segment_histogram_bytes(c, G, B, quantized),
            ops=3 * G * c, rows=c, hist=got)
    print("K2 segment_histogram (%s): root %d rows %.4f ms (plain %.4f, "
          "index_add_ %.4f); child %d rows %.4f ms; rel err %.3g"
          % (mode, n, k2["root"]["ms"], k2["root"]["plain_ms"],
             k2["root"]["library_ms"], segs["child"][1], k2["child"]["ms"],
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
                  plain_ms=cuda_ms(lambda: sk.split_scan_plain(
                      hist2, fvec, svec, pvec), 5),
                  bytes=k1_bytes, ops=k1_ops, library_ms=None)
        print("K1 split_scan: CH=2 F=%d B=%d %.4f ms (plain %.4f); gain rel "
              "err %.3g, %d valid features" % (G, B, k1["ms"], k1["plain_ms"],
                                              gain_rel, int(valid.sum())))
        entry("split_scan", "split_scan", k1, k1_err,
              "feature, threshold, default_left equal; gain rtol 1e-5",
              shape="CH=2 F=%d B=%d" % (G, B))
    del k2

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
    # the leaves in a shuffled order, so leaf-index order is not column
    # order; compacted past both output regions
    order = np.random.RandomState(5).permutation(LEAVES)
    seg6 = seg[torch.as_tensor(order, device=dev)].contiguous()
    dst0 = cursor + n_al + pk.TILE
    used_k = pk.compact_carry(ak, seg6, nl, dst0)
    used_p = pk.compact_carry_plain(ap, seg6, nl, dst0)
    expect(int(used_k[0]) == int(used_p[0]) == n, "K6: rows written differ")
    for pk_, pp_ in ((ak.bins, ap.bins), (ak.payload, ap.payload),
                     (ak.rid[None], ap.rid[None])):
        expect(torch.equal(pk_[:, dst0:dst0 + n], pp_[:, dst0:dst0 + n]),
               "K6: compacted planes differ")
    cols = torch.cat([torch.arange(s, s + c, device=dev)
                      for s, c in (pieces[i] for i in order)])
    k6 = dict(
        ms=cuda_ms(lambda: pk.compact_carry(ak, seg6, nl, dst0), 20),
        plain_ms=cuda_ms(lambda: pk.compact_carry_plain(ap, seg6, nl, dst0),
                         3),
        library_ms=cuda_ms(lambda: torch.index_select(ak.bins, 1, cols), 5),
        bytes=pk.compact_carry_bytes(n, G, LEAVES, quantized), rows=n)
    print("K6 compact_carry (%s payload): %d rows %d leaves %.4f ms (plain "
          "%.4f, index_select of the bins %.4f); exact"
          % (mode, n, LEAVES, k6["ms"], k6["plain_ms"], k6["library_ms"]))
    entry("compact_carry" + sfx, "compact_carry", k6, 0.0, "exact",
          library="torch.index_select of the bin planes over the "
                  "precomputed column list")
    del arenas, ak, ap, cols
    torch.cuda.empty_cache()


def parity_phase(dev, path: str):
    """A small run on the card against the same run on the CPU."""
    import lightgbm_tpu_torch as lt
    quantized, weighted = PATHS[path]
    X, y, _, _ = higgs_like(20_000, seed=11)
    w = row_weights(len(y)) if weighted else None
    params = dict(QPARAMS if quantized else PARAMS, num_leaves=31)
    out = {}
    for d in (dev, "cpu"):
        bst = lt.train(params, lt.Dataset(X, y, weight=w, device=d),
                       num_boost_round=3, device=d)
        g = bst._gbdt
        expect(g._quantized is quantized
               and g._carried_active is not weighted,
               "parity %s: the %s run took another path" % (path, d))
        out[str(d)] = bst
    gb, cb = out[str(dev)]._gbdt.models, out["cpu"]._gbdt.models
    expect(len(gb) == len(cb), "parity %s: tree counts differ" % path)
    moved = []
    for a, b in zip(gb, cb):
        k = a.num_leaves - 1
        expect(a.num_leaves == b.num_leaves
               and np.array_equal(a.split_feature[:k], b.split_feature[:k]),
               "parity %s: card and CPU trees split on different features"
               % path)
        expect(np.array_equal(a.predict_leaf_index(X),
                              b.predict_leaf_index(X)),
               "parity %s: training rows land in different leaves" % path)
        expect(np.allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                           rtol=1e-4, atol=1e-6),
               "parity %s: leaf values differ" % path)
        # a threshold may move across bins that hold no row of the node:
        # both thresholds then split the rows alike (checked above) and
        # their f32 gains tie up to reassociation of the histograms
        moved.append(int((a.threshold_in_bin[:k]
                          != b.threshold_in_bin[:k]).sum()))
    pg = out[str(dev)].predict(X, raw_score=True)
    pc = out["cpu"].predict(X, raw_score=True)
    err = float(np.abs(pg - pc).max())
    expect(np.all(np.isfinite(pg)) and err <= 1e-4,
           "parity %s: raw training predictions differ by %.3g" % (path, err))
    print("parity (%s, %s arena): 20000 rows, 3 rounds, 31 leaves: card and "
          "CPU trees split on the same features with every row in the same "
          "leaf (thresholds moved across empty bins, per tree: %s); raw "
          "training prediction max diff %.3g"
          % (path, "pristine" if weighted else "carried", moved, err))
    return dict(thresholds_moved=moved, max_raw_diff=err)


def training_phase(X, Xh, yh, ds_obj, rounds, dev, reduced, path):
    """A main path: lightgbm_tpu_torch.train on the card, then predict on
    the holdout.  The launch counters are zeroed just before train and read
    just after."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc
    from lightgbm_tpu_torch.ops import _cuda

    quantized, weighted = PATHS[path]
    ds_obj.set_weight(row_weights(len(X)) if weighted else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lt.train(QPARAMS if quantized else PARAMS, ds_obj,
                       num_boost_round=rounds, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    g = booster._gbdt
    expect(g._quantized is quantized and g._carried_active is not weighted,
           "%s training: quantized %s, carried %s" % (path, g._quantized,
                                                      g._carried_active))
    for name in PATH_KERNELS[path]:
        expect(launches.get(name, 0) > 0, "kernel %s was not launched on the "
               "%s training path" % (name, path))
    t = time.perf_counter()
    pred = booster.predict(Xh)
    predict_s = time.perf_counter() - t
    expect(pred.shape == (len(Xh),) and np.all(np.isfinite(pred)),
           "%s holdout predictions are not finite [n]" % path)
    leaves = [m.num_leaves for m in g.models]
    expect(len(leaves) == rounds and min(leaves) > 1,
           "%s trees did not grow: leaves %s" % (path, leaves))
    holdout_auc = auc(yh, pred)
    expect(holdout_auc >= AUC_FLOOR, "%s holdout AUC %.4f < %.2f"
           % (path, holdout_auc, AUC_FLOOR))
    round_ms = train_s * 1e3 / rounds
    rate = len(X) * rounds / train_s
    print("training (%s, %s arena): %d rows%s x %d features, "
          "%d rounds, leaves %s; train %.3f s (%.1f ms a round, %.4g "
          "rows*rounds/s, set-up included); peak device memory %.3f GB; "
          "holdout AUC %.4f on %d rows (predict %.3f s)"
          % (path, "pristine" if weighted else "carried", len(X),
             " (cut by --rows)" if reduced else "", X.shape[1],
             rounds, leaves, train_s, round_ms, rate, peak / 1e9,
             holdout_auc, len(Xh), predict_s))
    return booster, launches, dict(
        train_s=train_s, round_ms=round_ms, rows_rounds_per_s=rate,
        peak_bytes=peak, holdout_auc=holdout_auc, leaves=leaves,
        predict_s=predict_s, rows=len(X), launches=launches)


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
           if i < 12 or any("namespace)::%s%s" % (k, c) in kv[0]
                            for k in PORT_KERNELS for c in "(<")]
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
    return dict(wall_ms=wall_ms, device_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms,
                device_launches=sum(c for _, c in by_name.values()),
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

    results = {}
    for quantized in (False, True):
        kernel_phase(ds_obj._binned, dev, results, quantized)
    parity = {path: parity_phase(dev, path) for path in PATHS}
    train = {}
    launches = {}
    for path in PATHS:
        booster, launches[path], train[path] = training_phase(
            X, Xh, yh, ds_obj, args.rounds, dev, args.rows != ROWS, path)
        if not PATHS[path][1]:
            train[path]["profile"] = profile_round(booster, path)
        del booster
        torch.cuda.empty_cache()
    for f32, q in (("f32", "quantized"),
                   ("weighted_f32", "weighted_quantized")):
        gap = abs(train[q]["holdout_auc"] - train[f32]["holdout_auc"])
        expect(gap <= AUC_GAP, "%s holdout AUC is %.4f from the %s run's "
               "(limit %.2f)" % (q, gap, f32, AUC_GAP))
    # launches of each kernel in the run of the carried path it belongs to:
    # the int8 modes and K5 in the quantized run, the f32 modes in the f32
    # run; the kernels both paths run (K1, K4) report the quantized run;
    # launches_by_path has every path's run, the weighted (pristine) ones
    # included
    for name, r in results.items():
        path = ("f32" if name in ("segment_histogram", "partition_segment",
                                  "compact_carry") else "quantized")
        r["launches"] = int(launches[path].get(name, 0))
        r["launches_by_path"] = {p: int(launches[p].get(name, 0))
                                 for p in launches}
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
