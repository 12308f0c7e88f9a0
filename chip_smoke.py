#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--rounds R]

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from csrc/ (one nvcc per source, in
   parallel) and prints the build time;
3. kernel phase: each kernel of the training path (K1 split_scan, K2
   segment_histogram, K3 partition_segment, K4 scatter_segments) runs on the
   card at the main path's shapes against its plain PyTorch version on the
   same inputs, with the tolerance stated per kernel, and is timed with CUDA
   events beside the plain version and, where one PyTorch call computes the
   same function, that call;
4. training phase: a Higgs-shaped binary GBDT (28 dense features,
   num_leaves=255, max_bin=255, min_data_in_leaf=20, learning_rate=0.1,
   10.5M rows by default) trains through lightgbm_tpu_torch.train on the
   card and predicts a 100k-row holdout; the launch counters show that
   every kernel ran on that path, trees must reach more than one leaf and
   the holdout AUC must reach 0.75; before it, a small run on the card is
   held against the same run on the CPU (plain versions); after it, one
   more round runs under torch.profiler for the device time by kernel;
5. prints one JSON line of training results and one of per-kernel results,
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
AUC_FLOOR = 0.75
# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores; bounds below are stated against these, beside the card's
# power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the __global__ functions of lightgbm_tpu_torch/csrc/*.cu
PORT_KERNELS = ("split_scan_kernel", "select_best_kernel",
                "segment_histogram_kernel", "count_kernel", "scatter_kernel",
                "copy_back_kernel", "scatter_segments_kernel")


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
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Failure(Exception):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def kernel_phase(ds, dev, results):
    """K1-K4 against their plain versions at the main path's shapes."""
    import torch
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops import split_kernel as sk
    from lightgbm_tpu_torch.ops.split import SplitParams

    n, G = ds.num_data, ds.num_features
    B = int(ds.feature_num_bins().max())
    gen = torch.Generator(device=dev).manual_seed(7)
    bins_t = ds.device_bins(dev).t()
    arenas = []
    for _ in range(2):          # kernel arena, plain arena
        a = pk.Arena(n, G, 6, dev)
        pk.init_pristine(a, bins_t)
        arenas.append(a)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    for a in arenas:
        a.gh[0, :n] = g
        a.gh[1, :n] = h
    ak, ap = arenas
    work0 = pk.pristine_work0(n)
    cursor = work0 + -(-n // pk.TILE) * pk.TILE

    # ---- K2 -----------------------------------------------------------
    child_start = 123_456 % max(n - CHILD_ROWS, 1)
    segs = {"root": (0, n), "child": (child_start, min(CHILD_ROWS, n))}
    k2 = {}
    for name, (s, c) in segs.items():
        seg = torch.tensor([s, c], dtype=torch.int32, device=dev)
        got = pk.segment_histogram(ak, seg, B)
        want = pk.segment_histogram_plain(ak, seg, B)
        # scale for the f32 reassociation tolerance: sums of |g|, h, 1
        absg = ak.gh[:, s:s + c].clone()
        ak.gh[0, s:s + c] = absg[0].abs()
        scale = pk.segment_histogram_plain(ak, seg, B)
        ak.gh[:, s:s + c] = absg
        err = (got - want).abs()
        rel = float((err / scale.clamp_min(1e-30)).max())
        expect(torch.equal(got[..., 2], want[..., 2]),
               "K2 %s: counts differ" % name)
        expect(rel <= 1e-5, "K2 %s: error %.3g of the |value| sums exceeds "
               "rtol 1e-5" % (name, rel))
        ms = cuda_ms(lambda: pk.segment_histogram(ak, seg, B), 20)
        plain_ms = cuda_ms(lambda: pk.segment_histogram_plain(ak, seg, B), 5)
        flat = (torch.arange(G, device=dev)[:, None] * B
                + ak.bins[:, s:s + c].long()).reshape(-1)
        vals = torch.stack([ak.gh[0, s:s + c].expand(G, c).reshape(-1),
                            ak.gh[1, s:s + c].expand(G, c).reshape(-1),
                            torch.ones(G * c, device=dev)], dim=1)
        hist0 = torch.zeros((G * B, 3), device=dev)
        lib_ms = cuda_ms(lambda: hist0.index_add_(0, flat, vals), 5)
        del flat, vals
        k2[name] = dict(max_abs_err=float(err.max()), rel_err=rel, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms,
                        bytes=pk.segment_histogram_bytes(c, G, B),
                        ops=3 * G * c, rows=c, hist=got)
    print("K2 segment_histogram: root %d rows %.4f ms (plain %.4f, "
          "index_add_ %.4f); child %d rows %.4f ms; rel err %.3g"
          % (n, k2["root"]["ms"], k2["root"]["plain_ms"],
             k2["root"]["library_ms"], segs["child"][1], k2["child"]["ms"],
             max(k2["root"]["rel_err"], k2["child"]["rel_err"])))

    # ---- K1 -----------------------------------------------------------
    hist2 = torch.stack([k2["root"]["hist"], k2["child"]["hist"]])
    params = SplitParams(min_data_in_leaf=20)
    nb = torch.as_tensor(ds.feature_num_bins(), device=dev)
    db = torch.as_tensor(np.array([m.default_bin for m in ds.bin_mappers],
                                  np.int32), device=dev)
    mt = torch.as_tensor(np.array([m.missing_type for m in ds.bin_mappers],
                                  np.int32), device=dev)
    fvec = sk.build_feature_statics(nb, db, mt, children=2)
    svec = sk.child_vector(hist2[:, 0, :, 0].sum(1), hist2[:, 0, :, 1].sum(1),
                           hist2[:, 0, :, 2].sum(1))
    pvec = sk.params_vector(params, dev)
    rows_k, best_k = sk.split_scan(hist2, fvec, svec, pvec)
    rows_p, best_p = sk.split_scan_plain(hist2, fvec, svec, pvec)
    expect(torch.equal(rows_k[:, [sk._OF, sk._OT, sk._ODL]],
                       rows_p[:, [sk._OF, sk._OT, sk._ODL]]),
           "K1: feature, threshold or default_left differ")
    expect(torch.equal(best_k[:, [sk._OF, sk._OT, sk._ODL]],
                       best_p[:, [sk._OF, sk._OT, sk._ODL]]),
           "K1: selected feature or threshold differ")
    valid = rows_p[:, sk._OG] > sk.NEG_GATE
    k1_err = float((rows_k - rows_p)[valid].abs().max()) if valid.any() else 0.0
    gain_rel = (float(((rows_k[:, sk._OG] - rows_p[:, sk._OG]).abs()
                       / rows_p[:, sk._OG].abs())[valid].max())
                if valid.any() else 0.0)
    expect(gain_rel <= 1e-5, "K1: gain rel err %.3g exceeds 1e-5" % gain_rel)
    k1_ms = cuda_ms(lambda: sk.split_scan(hist2, fvec, svec, pvec), 50)
    k1_plain = cuda_ms(lambda: sk.split_scan_plain(hist2, fvec, svec, pvec), 5)
    k1_bytes, k1_ops = sk.scan_bytes_and_ops(2, G, B)
    print("K1 split_scan: CH=2 F=%d B=%d %.4f ms (plain %.4f); gain rel err "
          "%.3g, %d valid features" % (G, B, k1_ms, k1_plain, gain_rel,
                                      int(valid.sum())))

    # ---- K3 -----------------------------------------------------------
    chan = 0
    goleft = (torch.arange(256, device=dev) <= 127).to(torch.uint8)

    def make_sc(s, c, da, db_, xr):
        return torch.tensor([s, c, da, db_, 0, 0, chan, xr],
                            dtype=torch.int32, device=dev)

    def compare_regions(regions, what):
        for s, c in regions:
            for pk_, pp_ in ((ak.bins, ap.bins), (ak.gh, ap.gh)):
                expect(torch.equal(pk_[:, s:s + c], pp_[:, s:s + c]),
                       "K3 %s: planes differ" % what)
            expect(torch.equal(ak.rid[s:s + c], ap.rid[s:s + c]),
                   "K3 %s: row ids differ" % what)

    k3 = {}
    sc_k, sc_p = make_sc(0, n, work0, cursor, 1), make_sc(0, n, work0, cursor, 1)
    pk.partition_segment(ak, sc_k, goleft)
    pk.partition_segment_plain(ap, sc_p, goleft)
    expect(torch.equal(sc_k, sc_p), "K3 root: counts differ")
    n_b, n_a = int(sc_k[pk.SC_CNT_B]), int(sc_k[pk.SC_CNT_A])
    compare_regions([(work0, n_a), (cursor, n_b)], "root")
    root_regions = [(work0, n_a), (cursor, n_b)]
    lib_key = (goleft[ak.bins[chan, :n].long()] != 0).to(torch.uint8)
    k3["root"] = dict(
        ms=cuda_ms(lambda: pk.partition_segment(ak, sc_k, goleft), 10),
        plain_ms=cuda_ms(lambda: pk.partition_segment_plain(
            ap, sc_p, goleft), 3),
        library_ms=cuda_ms(lambda: torch.sort(lib_key, stable=True), 5),
        bytes=pk.partition_bytes(n, G), rows=n)
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
        bytes=pk.partition_bytes(c_rows, G), rows=c_rows)
    print("K3 partition_segment: root %d rows %.4f ms (plain %.4f, stable "
          "sort %.4f); child %d rows %.4f ms; exact"
          % (n, k3["root"]["ms"], k3["root"]["plain_ms"],
             k3["root"]["library_ms"], c_rows, k3["child"]["ms"]))

    # ---- K4 -----------------------------------------------------------
    # 255 leaf segments over the root split's output regions (every row
    # once, row ids permuted by the partition)
    pieces = []
    for s, c in root_regions:
        k = LEAVES // 2 + (1 if s == work0 else 0)
        cuts = np.linspace(0, c, k + 1).astype(np.int64)
        pieces += [(s + int(cuts[i]), int(cuts[i + 1] - cuts[i]))
                   for i in range(k)]
    # recompute the root split so both regions hold the permutation again
    sc_r = make_sc(0, n, work0, cursor, 1)
    pk.partition_segment(ak, sc_r, goleft)
    seg = torch.tensor(pieces, dtype=torch.int32, device=dev)
    vals = torch.randn(LEAVES, generator=gen, device=dev)
    nl = torch.tensor([LEAVES], dtype=torch.int32, device=dev)
    out_k = torch.zeros(n, device=dev)
    out_p = torch.zeros(n, device=dev)
    pk.scatter_segments(ak, seg, vals, nl, out_k)
    pk.scatter_segments_plain(ak, seg, vals, nl, out_p)
    expect(torch.equal(out_k, out_p), "K4: row-ordered outputs differ")
    rid_all = torch.cat([ak.rid[s:s + c].long() for s, c in pieces])
    val_all = torch.cat([vals[i].expand(c) for i, (_s, c) in enumerate(pieces)])
    k4 = dict(
        ms=cuda_ms(lambda: pk.scatter_segments(ak, seg, vals, nl, out_k), 20),
        plain_ms=cuda_ms(lambda: pk.scatter_segments_plain(
            ak, seg, vals, nl, out_p), 3),
        library_ms=cuda_ms(lambda: out_p.index_put_((rid_all,), val_all), 5),
        bytes=pk.scatter_bytes(n, LEAVES), rows=n)
    print("K4 scatter_segments: %d rows %d leaves %.4f ms (plain %.4f, "
          "index_put_ %.4f); exact" % (n, LEAVES, k4["ms"], k4["plain_ms"],
                                       k4["library_ms"]))

    def entry(name, src, replaces, r, err, tol):
        b_ms, b_by = bound(r["bytes"], r.get("ops", 0))
        results[name] = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=0, max_abs_err=err, tolerance=tol, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=r.get("library_ms"), rows=r.get("rows"))

    entry("split_scan", "lightgbm_tpu_torch/csrc/split_scan.cu",
          "lightgbm_tpu/ops/split_pallas.py:242",
          dict(ms=k1_ms, plain_ms=k1_plain, bytes=k1_bytes, ops=k1_ops,
               library_ms=None), k1_err,
          "feature, threshold, default_left equal; gain rtol 1e-5")
    entry("segment_histogram", "lightgbm_tpu_torch/csrc/segment_histogram.cu",
          "lightgbm_tpu/ops/partition_pallas.py:1019", k2["root"],
          max(k2["root"]["max_abs_err"], k2["child"]["max_abs_err"]),
          "counts equal; g/h within 1e-5 of the bin's |value| sum")
    entry("partition_segment", "lightgbm_tpu_torch/csrc/partition_segment.cu",
          "lightgbm_tpu/ops/partition_pallas.py:528", k3["root"], 0.0, "exact")
    entry("scatter_segments", "lightgbm_tpu_torch/csrc/scatter_segments.cu",
          "lightgbm_tpu/ops/partition_pallas.py:820", k4, 0.0, "exact")
    results["split_scan"]["shape"] = "CH=2 F=%d B=%d" % (G, B)
    for name, r in (("segment_histogram", k2["child"]),
                    ("partition_segment", k3["child"])):
        results[name]["child"] = dict(
            {k: r[k] for k in ("ms", "plain_ms", "library_ms", "rows")},
            bound_ms=bound(r["bytes"], r.get("ops", 0))[0])
    del arenas, ak, ap
    torch.cuda.empty_cache()


def parity_phase(dev):
    """A small run on the card against the same run on the CPU."""
    import lightgbm_tpu_torch as lt
    X, y, _, _ = higgs_like(20_000, seed=11)
    params = dict(PARAMS, num_leaves=31)
    out = {}
    for d in (dev, "cpu"):
        bst = lt.train(params, lt.Dataset(X, y, device=d), num_boost_round=3,
                       device=d)
        out[str(d)] = bst
    gb, cb = out[str(dev)]._gbdt.models, out["cpu"]._gbdt.models
    expect(len(gb) == len(cb), "parity: tree counts differ")
    moved = 0
    for a, b in zip(gb, cb):
        k = a.num_leaves - 1
        expect(a.num_leaves == b.num_leaves
               and np.array_equal(a.split_feature[:k], b.split_feature[:k]),
               "parity: card and CPU trees split on different features")
        expect(np.allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                           rtol=1e-4, atol=1e-6),
               "parity: leaf values differ")
        # a threshold may move across bins that hold no row of the node:
        # both thresholds then split the rows alike and their gains tie up
        # to f32 reassociation of the histograms (atomics on the card);
        # the training predictions below hold the partitions equal
        moved += int((a.threshold_in_bin[:k] != b.threshold_in_bin[:k]).sum())
    pg = out[str(dev)].predict(X, raw_score=True)
    pc = out["cpu"].predict(X, raw_score=True)
    err = float(np.abs(pg - pc).max())
    expect(np.all(np.isfinite(pg)) and err <= 1e-4,
           "parity: raw training predictions differ by %.3g" % err)
    print("parity: 20000 rows, 3 rounds, 31 leaves: card and CPU trees split "
          "on the same features (%d thresholds moved across empty bins); raw "
          "training prediction max diff %.3g" % (moved, err))


def training_phase(X, y, Xh, yh, ds_obj, rounds, dev, reduced):
    """The main path: lightgbm_tpu_torch.train on the card, then predict on
    the holdout.  The launch counters are zeroed just before train and read
    just after."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metric import auc
    from lightgbm_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lt.train(PARAMS, ds_obj, num_boost_round=rounds, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    pred = booster.predict(Xh)
    predict_s = time.perf_counter() - t
    expect(pred.shape == (len(Xh),) and np.all(np.isfinite(pred)),
           "holdout predictions are not finite [n]")
    leaves = [m.num_leaves for m in booster._gbdt.models]
    expect(len(leaves) == rounds and min(leaves) > 1,
           "trees did not grow: leaves %s" % leaves)
    holdout_auc = auc(yh, pred)
    expect(holdout_auc >= AUC_FLOOR, "holdout AUC %.4f < %.2f"
           % (holdout_auc, AUC_FLOOR))
    round_ms = train_s * 1e3 / rounds
    print("training: %d rows%s x %d features, %d rounds, leaves %s; train "
          "%.3f s (%.1f ms a round, set-up included); peak device memory "
          "%.3f GB; holdout AUC %.4f on %d rows (predict %.3f s)"
          % (len(X), " (cut by --rows)" if reduced else "", X.shape[1],
             rounds, leaves, train_s, round_ms, peak / 1e9, holdout_auc,
             len(Xh), predict_s))
    return booster, launches, dict(
        train_s=train_s, round_ms=round_ms, peak_bytes=peak,
        holdout_auc=holdout_auc, leaves=leaves, predict_s=predict_s,
        rows=len(X))


def profile_round(booster) -> dict:
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
        print("profile: the profiler saw no device events; device time not "
              "measured")
        return dict(wall_ms=wall_ms, device_ms=None, idle_share=None)
    print("profile of one round (profiler on): wall %.1f ms, device busy "
          "%.1f ms, idle share %.3f, %d device launches"
          % (wall_ms, busy_ms, 1 - busy_ms / wall_ms,
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
    kernel_phase(ds_obj._binned, dev, results)
    parity_phase(dev)
    booster, launches, train = training_phase(X, y, Xh, yh, ds_obj,
                                              args.rounds, dev,
                                              args.rows != ROWS)
    train["profile"] = profile_round(booster)
    for name, r in results.items():
        r["launches"] = int(launches.get(name, 0))
        expect(r["launches"] > 0, "kernel %s was not launched on the "
               "training path" % name)
    print(json.dumps({"training": train}))
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
