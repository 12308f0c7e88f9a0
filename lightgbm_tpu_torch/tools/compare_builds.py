"""Another build of the port's kernels against this one, on the card.

    python -m lightgbm_tpu_torch.tools.compare_builds OTHER_CSRC [rows_millions]
        [--save-leaf-seg PATH] [--only sass,K3,K7,K2,K1,K6,K4,KP1]

OTHER_CSRC is the `lightgbm_tpu_torch/csrc` directory of another checkout
(a parent commit unpacked with `git archive`, say).  In one process:

1. K3 (`partition_segment.cu`), K7 (`leaf_histogram.cu`), K2
   (`segment_histogram.cu`), K5 (`fused_root_histogram.cu`), K1
   (`split_scan.cu`), K6 (`compact_carry.cu`), K4
   (`scatter_segments.cu`) and KP1 (`predict_ensemble.cu`) of both trees
   compiled
   with `ptxas -v` to cubins: each kernel's resource line and whether its
   SASS (`cuobjdump -sass`, kernel names demangled and K8's stage template
   argument dropped) is identical in the two trees;
2. the four K3 instances (decision and pred mode with the bag's
   histogram, f32 and int8 payload) of both trees on a random 10.5M-row,
   28-feature arena (or rows_millions): at the root, off the pristine
   block, and on a 40k-row child, in place; each first held equal between
   the two trees (planes, counts, histograms up to f32 reassociation),
   then timed in the order other, this, this, other (CUDA events over
   10 or 20 launches);
3. K7 of both trees, f32 and int8, at the root (every row in leaf 0) and
   on one leaf of 255 spread over the rows, held equal and timed in the
   same order, and this tree's kernels timed apart by torch.profiler;
4. K2 f32 and int8 of both trees at the root and on a 40k-row and a
   500k-row child (near the largest that K2's int8 mode packs), on
   uniform bins and on skewed ones (two features in three with 2-3 bins
   and 96% of the rows in one), held equal and timed in the same order,
   each tree's kernel-only time (torch.profiler) beside; K5 at the root;
5. K1 of both trees through their C entry points, one child and two
   (F=28, B=255), held equal (feature, threshold, default_left, gains
   within 1e-5) and timed likewise, kernel-only beside; then this tree's
   wrapper against the first version's wrapper work around the other
   tree's entry point;
6. K6 of both trees, f32 and int8, at rows_millions rows: the
   smoke's 255 even leaves in a shuffled order, a skewed tree (one leaf
   of half the rows, the rest geometric down to 20 rows), both with their
   sources at any column, and the leaf_seg of a real carried tree in its
   own arena geometry (`carried_leaf_seg.json` beside this file: the last
   tree of four carried rounds of chip_smoke.py's data with its
   parameters, which --save-leaf-seg PATH trains and writes anew); held
   equal between the trees (every plane), then timed in the order other,
   this, this, other, kernel-only beside; and a `copy_` of the bytes K6
   moves (half read, half written) as the yardstick of a plain copy;
7. K4 of both trees on the same three layouts: set mode (f32 and int32)
   and add mode held equal bit for bit, then timed likewise, kernel-only
   beside, with the bounds and index_put_ (accumulate=True for the add)
   over the expanded (row, value) pairs; where the other tree's K4 has no
   add mode, the chain it replaces (a zeroed delta, K4 in set mode, a
   multiply and an add) stands in;
8. KP1 (`predict_ensemble.cu`) of both trees on one model: 500 rounds of
   chip_smoke.py's f32 carried configuration trained on its data at
   min(rows_millions, 1) million rows (kept as model text in the build
   directory), walked over the 100k holdout and the training rows: the
   sums held equal bit for bit (the other tree's on f64 rows, this tree's
   on f64 and on f32 rows), then timed in the order other, this, this,
   other (CUDA events), kernel-only beside, with the node visits (the
   depths of the leaves reached, from this tree's leaf mode) and ns a
   visit; then the sweep over batch sizes (kp1_sweep: this tree's row
   tiles and small-batch walk beside the other tree's walk, 1 to 100k
   rows); then Booster.predict from numpy, f32 and f64 rows, of each
   tree's package (the other tree's package is OTHER_CSRC's parent
   directory), a process each, in the same order.

`--only` runs the named sections alone (sass is step 1).  The other
tree's K3, K7, K1, K6 and K4 may take the C interface of the first
versions (a scratch arena and block counts for K3, no row list for K7, no
ticket for K1, two launches over a grid of blocks a leaf for K6, a grid
of blocks a leaf for K4, one thread a row over the first walk tables for
KP1, built here as that version built them); the tool reads which from
the other tree's sources.
Needs nvcc and a CUDA device;
builds into lightgbm_tpu_torch/_build/compare and prints one line per
kernel and case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda
from ..ops import histogram_kernel as hk
from ..ops import partition_kernel as pk
from ..ops import split_kernel as sk
from ..ops.split import SplitParams
from . import cuda_ms, tree_row_order

G, B, LEAVES, CHILD = 28, 255, 255, 40_000
MID_CHILD = 500_000     # K2's int8 mode packs its words up to 540,672 rows
K3_STAGE_ARG = re.compile(r", \(int\)\d>")
LEAF_SEG = Path(__file__).resolve().parent / "carried_leaf_seg.json"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C interface of the first K3 and K7 (scratch arena, block counts; no
# row list), of the first K1 (two launches, no ticket) and of the first K6
# (two launches, a grid of blocks a leaf)
OLD_ENTRY_POINTS = {
    "partition_segment": {
        "lgbt_partition_segment": [_P, _P, _P, _LL, _P, _P, _P, _LL, _P, _P,
                                   _P, _I, _I, _P],
        "lgbt_partition_segment_i8": [_P, _P, _P, _LL, _P, _P, _P, _LL, _P,
                                      _P, _P, _I, _I, _P],
        "lgbt_partition_segment_pred": [_P, _P, _P, _LL, _P, _P, _P, _LL, _P,
                                        _P, _LL, _P, _I, _I, _P, _I, _I, _P],
        "lgbt_partition_segment_pred_i8": [_P, _P, _P, _LL, _P, _P, _P, _LL,
                                           _P, _P, _LL, _P, _I, _I, _P, _I,
                                           _I, _P]},
    "leaf_histogram": {
        "lgbt_leaf_histogram": [_P, _P, _P, _P, _P, _LL, _P, _I, _I, _I, _P],
        "lgbt_leaf_histogram_i8": [_P, _P, _P, _P, _P, _LL, _P, _I, _I, _I,
                                   _P]},
    "split_scan": {
        "lgbt_split_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "compact_carry": {
        "lgbt_compact_carry": [_P, _P, _P, _LL, _P, _P, _I, _P, _P, _LL, _I,
                               _I, _P],
        "lgbt_compact_carry_i8": [_P, _P, _P, _LL, _P, _P, _I, _P, _P, _LL,
                                  _I, _I, _P]},
    "scatter_segments": {
        "lgbt_scatter_segments_f32": [_P, _P, _P, _P, _P, _I, _I, _P],
        "lgbt_scatter_segments_i32": [_P, _P, _P, _P, _P, _I, _I, _P]},
    "predict_ensemble": {
        "lgbt_predict_ensemble": [_P] * 12 + [_LL, _I, _I, _I, _I, _I,
                                              ctypes.c_double, _P, _LL, _P,
                                              _P]},
}
# K4's add mode before its shrinkage became a device scalar: s by value
ADD_BY_VALUE = [_P, _P, _P, _P, ctypes.c_float, _P, _I, _P]
OLD_PART_BLOCKS, OLD_PRED_BLOCKS, OLD_LEAF_BLOCKS = 1024, 264, 264
OLD_CARRY_BLOCKS = OLD_SCATTER_BLOCKS = 64
SECTIONS = ("sass", "K3", "K7", "K2", "K1", "K6", "K4", "KP1")
KP1_ROUNDS, KP1_HOLDOUT = 500, 100_000
KP1_SWEEP_ROWS = (1, 64, 256, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
                  100_000)


def _tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_cuda.find_nvcc()), name)
    return path if os.path.exists(path) else name


def _demangle(names):
    r = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                       text=True, capture_output=True)
    return r.stdout.strip().split("\n") if r.returncode == 0 else list(names)


def _name(demangled: str) -> str:
    """A kernel's name with the template argument that only names a build
    variant dropped (K8's stage)."""
    return K3_STAGE_ARG.sub(">", demangled)


def _nvcc(src_dir: str, stem: str, out: str, cubin: bool) -> str:
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           src_dir, "-o", out, os.path.join(src_dir, stem + ".cu")]
    if cubin:
        cmd = [c for c in cmd if c not in ("-shared", "-Xcompiler", "-fPIC")]
        cmd.insert(1, "-cubin")
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed on %s/%s.cu:\n%s"
                           % (src_dir, stem, r.stdout + r.stderr))
    return r.stdout + r.stderr


def sass_report(other: str, stem: str, out_dir: str) -> None:
    """Resource line of every kernel of csrc/<stem>.cu in both trees and
    whether its SASS is identical."""
    res = {}
    for tag, src in (("other", other), ("this", str(_cuda.CSRC))):
        cubin = os.path.join(out_dir, "%s_%s.cubin" % (stem, tag))
        text = _nvcc(src, stem, cubin, cubin=True)
        lines, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = m.group(1)
            elif ("Used" in line or "spill" in line) and cur:
                lines[cur] = "; ".join(filter(None, (
                    lines.get(cur), line.split(":", 1)[-1].strip())))
        names = list(lines)
        res_lines = {_name(d): lines[n]
                     for n, d in zip(names, _demangle(names))}
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True)
        bodies, cur = {}, None
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = _name(_demangle([m.group(1)])[0])
                bodies[cur] = []
            elif cur is not None:
                bodies[cur].append(re.sub(r"_Z\w+", "SYM", line.strip()))
        res[tag] = (res_lines, bodies)
    (ol, ob), (tl, tb) = res["other"], res["this"]
    for k in sorted(set(ol) | set(tl)):
        print("%s %s: other %s; this %s; SASS %s" % (
            stem, k.split("(")[0], ol.get(k), tl.get(k),
            "identical" if ob.get(k) == tb.get(k) else "differs"))


def _is_old(src_dir: str, stem: str) -> bool:
    with open(os.path.join(src_dir, stem + ".cu")) as f:
        text = f.read()
    if stem == "partition_segment":
        return "long long scap" in text
    if stem == "split_scan":
        return "int* ticket" not in text
    if stem == "compact_carry":
        return "carry_offsets_kernel" in text
    if stem == "scatter_segments":
        return "grid_x" in text
    if stem == "predict_ensemble":
        return "node_off" in text
    return "int* rows" not in text


def _load(src_dir: str, stem: str, out_dir: str, tag: str):
    """The C entry points of csrc/<stem>.cu of one tree, and whether they
    take the first versions' interface."""
    out = os.path.join(out_dir, "%s_%s.so" % (stem, tag))
    _nvcc(src_dir, stem, out, cubin=False)
    old = stem in OLD_ENTRY_POINTS and _is_old(src_dir, stem)
    lib = ctypes.CDLL(out)
    fns = {}
    for name, argtypes in (OLD_ENTRY_POINTS if old
                           else _cuda._ENTRY_POINTS)[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    if stem == "scatter_segments" and not old and _add_by_value(src_dir):
        fns["lgbt_scatter_segments_add"].argtypes = ADD_BY_VALUE
    return fns, old


def _add_by_value(src_dir: str) -> bool:
    """K4's add mode takes its shrinkage by value (the tree's sources
    before the device scalar)."""
    with open(os.path.join(src_dir, "scatter_segments.cu")) as f:
        return "const float* s, float* out" not in f.read()


def _check(rc, what):
    if rc:
        raise RuntimeError("%s failed to launch: cudaError %d" % (what, rc))


class _K3:
    """One tree's K3 entry points over an arena, in its own interface."""

    def __init__(self, fns, old, arena):
        self.fns, self.old, self.a = fns, old, arena
        if old:
            n, pdt = arena.num_data, arena.payload.dtype
            dev = arena.device
            self.s_bins = torch.empty((G, n), dtype=torch.uint8, device=dev)
            self.s_pay = torch.empty((2, n), dtype=pdt, device=dev)
            self.s_rid = torch.empty(n, dtype=torch.int32, device=dev)
            self.blocks = torch.zeros(OLD_PART_BLOCKS, dtype=torch.int32,
                                      device=dev)

    def _head(self):
        a = self.a
        head = [a.bins.data_ptr(), a.payload.data_ptr(), a.rid.data_ptr(),
                a.cap]
        if self.old:
            head += [self.s_bins.data_ptr(), self.s_pay.data_ptr(),
                     self.s_rid.data_ptr(), a.num_data]
        return head

    def _state(self, blocks):
        a = self.a
        if self.old:
            return [self.blocks.data_ptr(), blocks]
        return [a.tile_state.data_ptr(), a.tile_state.numel(), a.num_data]

    def decision(self, sc, goleft):
        sfx = "_i8" if self.a.quantized else ""
        _check(self.fns["lgbt_partition_segment" + sfx](
            *self._head(), sc.data_ptr(), goleft.data_ptr(),
            *self._state(OLD_PART_BLOCKS), G, _cuda.stream()), "K3")

    def pred(self, sc, pred, hist):
        sfx = "_i8" if self.a.quantized else ""
        hist.zero_()
        _check(self.fns["lgbt_partition_segment_pred" + sfx](
            *self._head(), sc.data_ptr(), pred.data_ptr(), pred.shape[0],
            *self._state(OLD_PRED_BLOCKS), G, hist.data_ptr(), B, 0,
            _cuda.stream()), "K3 pred")


def _same_hist(x, y, quantized):
    if quantized:
        return torch.equal(x, y)
    scale = x.abs().max().clamp_min(1.0)
    return (torch.equal(x[..., 2], y[..., 2])
            and float((x - y).abs().max() / scale) <= 1e-5)


def partitions(other: str, n: int, out_dir: str) -> None:
    """The four K3 instances of both trees, root and child."""
    dev = torch.device("cuda")
    impl = {tag: _load(src, "partition_segment", out_dir, tag)
            for tag, src in (("other", other), ("this", str(_cuda.CSRC)))}
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)
                            ).to(dev)
    work0 = pk.pristine_work0(n)
    n_al = -(-n // pk.TILE) * pk.TILE
    goleft = (torch.arange(256, device=dev) <= 127).to(torch.uint8)
    bag = torch.from_numpy((rng.rand(n) < 0.8).astype(np.uint8)).to(dev)
    bag_c = torch.zeros(work0 + CHILD, dtype=torch.uint8, device=dev)
    bag_c[work0:] = torch.from_numpy(
        (rng.rand(CHILD) < 0.8).astype(np.uint8)).to(dev)
    for quantized in (False, True):
        arenas = {}
        for tag in ("other", "this"):
            a = pk.Arena(n, G, 4, dev, quantized=quantized)
            pk.init_pristine(a, bins)
            if quantized:
                a.payload[:, :n] = torch.from_numpy(np.random.RandomState(
                    1).randint(-127, 128, (2, n)).astype(np.int8)).to(dev)
            else:
                a.payload[:, :n] = torch.from_numpy(np.random.RandomState(
                    1).randn(2, n).astype(np.float32)).to(dev)
            arenas[tag] = _K3(*impl[tag], a)
        hdt = torch.int32 if quantized else torch.float32
        hists = {t: torch.zeros((G, B, 3), dtype=hdt, device=dev)
                 for t in arenas}
        mode = "int8" if quantized else "f32"
        cases = (
            ("decision root", lambda k, sc: k.decision(sc, goleft),
             [0, n, work0, work0 + n_al, 0, 0, 0, 1], 10),
            ("decision child", lambda k, sc: k.decision(sc, goleft),
             [work0, CHILD, work0, work0 + 2 * n_al, 0, 0, 3, 0], 20),
            ("pred root", lambda k, sc: k.pred(sc, bag, hists[k.tag]),
             [0, n, work0, work0 + n_al, 0, 0, 0, 0], 10),
            ("pred child", lambda k, sc: k.pred(sc, bag_c, hists[k.tag]),
             [work0, CHILD, work0, work0 + 2 * n_al, 0, 0, 0, 0], 20))
        for tag, k in arenas.items():
            k.tag = tag
        for what, run, sc_list, reps in cases:
            scs = {}
            for tag, k in arenas.items():
                scs[tag] = torch.tensor(sc_list, dtype=torch.int32,
                                        device=dev)
                run(k, scs[tag])
            torch.cuda.synchronize()
            same = torch.equal(scs["other"], scs["this"])
            n_a = int(scs["this"][pk.SC_CNT_A])
            for s0, c in ((sc_list[2], n_a),
                          (sc_list[3], sc_list[1] - n_a)):
                for x, y in ((arenas["other"].a.bins, arenas["this"].a.bins),
                             (arenas["other"].a.payload,
                              arenas["this"].a.payload),
                             (arenas["other"].a.rid[None],
                              arenas["this"].a.rid[None])):
                    same = same and torch.equal(x[:, s0:s0 + c],
                                                y[:, s0:s0 + c])
            if what.startswith("pred"):
                same = same and _same_hist(hists["other"], hists["this"],
                                           quantized)
            ms = ["%s %.4f" % (tag, cuda_ms(
                lambda: run(arenas[tag], scs[tag]), reps))
                  for tag in ("other", "this", "this", "other")]
            print("K3 %s %s, %d rows: %s ms; the two trees %s" % (
                what, mode, sc_list[1], ", ".join(ms),
                "agree" if same else "DIFFER"))
        del arenas
        torch.cuda.empty_cache()


def _kernel_ms(fn, reps: int) -> str:
    """Device ms a call of fn, by kernel of the port (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        m = re.search(r"::(\w+_kernel)", ev.name)
        if ev.device_type == torch.autograd.DeviceType.CUDA and m:
            by[m.group(1)] = (by.get(m.group(1), 0.0)
                              + ev.time_range.elapsed_us() / 1e3 / reps)
    return ", ".join("%s %.4f" % kv for kv in sorted(by.items())) or "none"


def leaf_histograms(other: str, n: int, out_dir: str) -> None:
    """K7 of both trees, f32 and int8, root and leaf."""
    dev = torch.device("cuda")
    impl = {tag: _load(src, "leaf_histogram", out_dir, tag)
            for tag, src in (("other", other), ("this", str(_cuda.CSRC)))}
    rng = np.random.RandomState(2)
    bins = torch.from_numpy(rng.randint(0, B, (n, G)).astype(np.uint8)
                            ).to(dev)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
    gq = torch.from_numpy(rng.randint(-127, 128, n).astype(np.int8)).to(dev)
    hq = torch.from_numpy(rng.randint(0, 128, n).astype(np.int8)).to(dev)
    leaves = torch.from_numpy(rng.randint(0, LEAVES, n).astype(np.int32)
                              ).to(dev)
    child = 7
    m = int((leaves == child).sum())
    rows = hk.row_list(n, dev)
    s = _cuda.stream()

    def call(tag, quantized, ids, lf, out):
        fns, old = impl[tag]
        name = "lgbt_leaf_histogram" + ("_i8" if quantized else "")
        pg, ph = (gq, hq) if quantized else (g, h)
        args = [bins.data_ptr(), pg.data_ptr(), ph.data_ptr(), ids.data_ptr(),
                lf.data_ptr(), n, out.data_ptr(), G, B]
        if old:
            args += [OLD_LEAF_BLOCKS]
        else:
            args += [rows.data_ptr(), rows[n:].data_ptr(),
                     hk.LEAF_HIST_BLOCKS, hk.LEAF_ROWS_PER_BLOCK]

        def run():
            out.zero_()
            _check(fns[name](*args, s), "K7")
        return run

    for quantized in (False, True):
        for what, ids, leaf in (("root", torch.zeros_like(leaves), 0),
                                ("leaf of %d rows" % m, leaves, child)):
            ids = ids.to(torch.uint8) if quantized else ids
            lf = torch.tensor([leaf], dtype=torch.int32, device=dev)
            odt = torch.int32 if quantized else torch.float32
            outs = {t: torch.zeros((G, B, 3), dtype=odt, device=dev)
                    for t in impl}
            runs = {t: call(t, quantized, ids, lf, outs[t]) for t in impl}
            for r in runs.values():
                r()
            torch.cuda.synchronize()
            same = _same_hist(outs["other"], outs["this"], quantized)
            ms = ["%s %.4f" % (t, cuda_ms(runs[t], 20))
                  for t in ("other", "this", "this", "other")]
            print("K7 %s %s, %d rows: %s ms; the two trees %s; this tree's "
                  "kernels by the profiler, ms: %s" % (
                      "int8" if quantized else "f32", what, n, ", ".join(ms),
                      "agree" if same else "DIFFER",
                      _kernel_ms(runs["this"], 10)))


def _skewed_bins(rng, n):
    """[G, n] bins where two features in three have 2-3 bins with 96% of
    the rows in one (the real Higgs's b-tag columns); the rest uniform."""
    bins = rng.randint(0, B, (G, n)).astype(np.uint8)
    for f in range(G):
        if f % 3 != 2:
            rare = rng.rand(n) >= 0.96
            bins[f] = np.where(rare, rng.randint(1, 2 + f % 2, n), 0)
    return bins


def _both_ms(runs, reps):
    """CUDA-event ms of each tree's call in the order other, this, this,
    other, then each tree's kernel-only ms (torch.profiler)."""
    ev = ", ".join("%s %.4f" % (t, cuda_ms(runs[t], reps))
                   for t in ("other", "this", "this", "other"))
    ko = "; ".join("%s %s" % (t, _kernel_ms(runs[t], reps))
                   for t in ("other", "this"))
    return "%s ms; kernel-only, ms: %s" % (ev, ko)


def histograms(other: str, n: int, out_dir: str) -> None:
    """K2 f32 and int8 of both trees at the root and on a 40k child, on
    uniform and on skewed bins, and K5 at the root: held equal between the
    trees, then timed."""
    dev = torch.device("cuda")
    libs = {tag: {} for tag in ("other", "this")}
    for stem in ("segment_histogram", "fused_root_histogram"):
        for tag, src in (("other", other), ("this", str(_cuda.CSRC))):
            libs[tag].update(_load(src, stem, out_dir, tag)[0])
    s = _cuda.stream()
    for skewed in (False, True):
        rng = np.random.RandomState(0)
        bins = torch.from_numpy(_skewed_bins(rng, n) if skewed else
                                rng.randint(0, B, (G, n)).astype(np.uint8)
                                ).to(dev)
        af = pk.Arena(n, G, 4, dev)
        aq = pk.Arena(n, G, 4, dev, quantized=True)
        for a in (af, aq):
            pk.init_pristine(a, bins)
        del bins
        af.payload[:, :n] = torch.from_numpy(
            rng.randn(2, n).astype(np.float32)).to(dev)
        codes = torch.from_numpy(rng.randint(-127, 128, (2, n)).astype(
            np.int8)).to(dev)
        aq.payload[:, :n] = codes
        kind = "skewed" if skewed else "uniform"
        for what, start, cnt in (("root", 0, n), ("child", 12_345, CHILD),
                                 ("child", 7_000, MID_CHILD)):
            seg = torch.tensor([start, cnt], dtype=torch.int32, device=dev)
            for mode, a, name in (
                    ("f32", af, "lgbt_segment_histogram"),
                    ("int8", aq, "lgbt_segment_histogram_i8")):
                q = mode == "int8"
                outs = {t: torch.zeros((G, B, 3), device=dev, dtype=(
                    torch.int32 if q else torch.float32)) for t in libs}

                def call(t, a=a, name=name, outs=outs, seg=seg):
                    return lambda: _check(libs[t][name](
                        a.bins.data_ptr(), a.payload.data_ptr(),
                        seg.data_ptr(), outs[t].data_ptr(), G, B, a.cap,
                        pk.HIST_BLOCKS, s), "K2")
                runs = {t: call(t) for t in libs}
                for r in runs.values():
                    r()
                torch.cuda.synchronize()
                same = _same_hist(outs["other"], outs["this"], q)
                print("K2 %s %s %s, %d rows: %s; the two trees %s" % (
                    mode, kind, what, cnt, _both_ms(
                        runs, 20 if what == "root" else 200),
                    "agree" if same else "DIFFER"))
        if not skewed:
            seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
            out_i = torch.zeros((G, B, 3), dtype=torch.int32, device=dev)
            runs = {t: (lambda t=t: _check(
                libs[t]["lgbt_fused_root_histogram"](
                    aq.bins.data_ptr(), aq.payload.data_ptr(),
                    codes.data_ptr(), n, seg.data_ptr(), out_i.data_ptr(), G,
                    B, aq.cap, pk.HIST_BLOCKS, s), "K5"))
                for t in libs}
            print("K5 root, %d rows: %s" % (n, _both_ms(runs, 20)))
        del af, aq, codes
        torch.cuda.empty_cache()


def _scan_inputs(dev, CH, seed):
    """Histograms of CH children over G features and B bins (the Higgs
    shape), their statics and the default split parameters."""
    rng = np.random.default_rng(seed)
    cnt = rng.multinomial(40_000, np.ones(G * B) / (G * B), size=CH
                          ).reshape(CH, G, B)
    g = rng.standard_normal((CH, G, B)) * np.sqrt(cnt + 1e-3)
    h = rng.random((CH, G, B)) * cnt * 0.25 + cnt * 1e-3
    hist = torch.from_numpy(np.stack([g, h, cnt], -1).astype(np.float32)
                            ).to(dev)
    nb = torch.full((G,), B, dtype=torch.int32, device=dev)
    z = torch.zeros(G, dtype=torch.int32, device=dev)
    fvec = sk.build_feature_statics(nb, z, z, children=CH)
    svec = sk.child_vector(hist[:, 0, :, 0].sum(1), hist[:, 0, :, 1].sum(1),
                           hist[:, 0, :, 2].sum(1))
    pvec = sk.params_vector(SplitParams(min_data_in_leaf=20), dev)
    return hist, fvec, svec, pvec


def scans(other: str, out_dir: str) -> None:
    """K1 of both trees through their C entry points (the other tree's may
    be the first version's two launches with no ticket), CH = 1 and 2, held
    equal, then timed; and the wrappers: this tree's split_scan against the
    first version's wrapper work (four checks, two allocations, the stream
    object) around the other tree's entry point."""
    dev = torch.device("cuda", torch.cuda.current_device())
    impl = {tag: _load(src, "split_scan", out_dir, tag)
            for tag, src in (("other", other), ("this", str(_cuda.CSRC)))}
    ticket = torch.zeros(8, dtype=torch.int32, device=dev)
    lanes = [sk._OF, sk._OT, sk._ODL]
    for CH in (1, 2):
        hist, fvec, svec, pvec = _scan_inputs(dev, CH, CH)
        outs = {t: (torch.empty((CH * G, sk.ROW_W), device=dev),
                    torch.empty((CH, sk.ROW_W), device=dev)) for t in impl}

        def call(t):
            fns, old = impl[t]
            rows, best = outs[t]
            args = [hist.data_ptr(), fvec.data_ptr(), svec.data_ptr(),
                    pvec.data_ptr(), rows.data_ptr(), best.data_ptr()]
            if not old:
                args.append(ticket.data_ptr())
            args += [CH, G, B, _cuda.stream()]
            return lambda: _check(fns["lgbt_split_scan"](*args), "K1")
        runs = {t: call(t) for t in impl}
        for r in runs.values():
            r()
        torch.cuda.synchronize()
        (ro, bo), (rt, bt) = outs["other"], outs["this"]
        same = (torch.equal(ro[:, lanes], rt[:, lanes])
                and torch.equal(bo[:, lanes], bt[:, lanes])
                and float((ro[:, sk._OG] - rt[:, sk._OG]).abs().max()
                          / ro[:, sk._OG].abs().max()) <= 1e-5)
        print("K1 CH=%d F=%d B=%d, entry points: %s; the two trees %s" % (
            CH, G, B, _both_ms(runs, 200), "agree" if same else "DIFFER"))

        def parent_wrapper(fns=impl["other"][0]):
            CH_, F, B_, three = hist.shape
            if three != 3 or not 1 <= B_ <= 256:
                raise ValueError("hist shape")
            f32 = torch.float32
            _cuda.require(hist, "hist", f32, dev)
            _cuda.require(fvec, "fvec", f32, dev, (CH_ * F, 8))
            _cuda.require(svec, "svec", f32, dev, (CH_, 8))
            _cuda.require(pvec, "pvec", f32, dev, (8,))
            _cuda.plain_or_cuda(dev)
            rows = torch.empty((CH_ * F, sk.ROW_W), dtype=f32, device=dev)
            best = torch.empty((CH_, sk.ROW_W), dtype=f32, device=dev)
            args = [hist.data_ptr(), fvec.data_ptr(), svec.data_ptr(),
                    pvec.data_ptr(), rows.data_ptr(), best.data_ptr()]
            if not impl["other"][1]:
                args.append(ticket.data_ptr())
            _check(fns["lgbt_split_scan"](
                *args, CH_, F, B_, torch.cuda.current_stream().cuda_stream),
                "K1")
            return rows, best
        wraps = {"other": parent_wrapper,
                 "this": lambda: sk.split_scan(hist, fvec, svec, pvec)}
        print("K1 CH=%d wrappers (the other tree's wrapper work around its "
              "entry point; this tree's split_scan), ms: %s" % (
                  CH, ", ".join("%s %.4f" % (t, cuda_ms(wraps[t], 1000))
                                for t in ("other", "this", "this",
                                          "other"))))


def _skewed_counts(n, leaves=LEAVES):
    """One leaf of half the rows, the others geometric down to 20 rows,
    summing to n."""
    rest = np.maximum(20, (n / 4 * 0.96 ** np.arange(leaves - 1)).astype(int))
    rest = np.maximum(20, rest * (n - n // 2) // max(int(rest.sum()), 1))
    sizes = np.concatenate([[n // 2], rest])
    sizes[0] += n - int(sizes.sum())
    return sizes


def save_leaf_seg(path: str, n: int, rounds: int = 4) -> dict:
    """Train `rounds` carried f32 rounds of chip_smoke.py's data (n rows)
    with its parameters and write the last tree's K6 arguments (leaf
    segments, nl, dst0, the arena's geometry) to path as JSON."""
    import lightgbm_tpu_torch as lt
    from ..ops import grow_partition as gp
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    dev = torch.device("cuda", torch.cuda.current_device())
    X, y, _xh, _yh = cs.higgs_like(n)
    ds = lt.Dataset(X, y, params=cs.PARAMS, device=dev).construct()
    seen = []
    real = gp.compact_carry

    def capture(arena, seg, nl, dst0):
        live = int(nl[0])
        seen.append(dict(nl=live, L=int(seg.shape[0]), dst0=int(dst0),
                         cap=int(arena.cap), rows=int(arena.num_data),
                         seg=seg[:live].tolist()))
        return real(arena, seg, nl, dst0)
    gp.compact_carry = capture
    try:
        booster = lt.train(cs.path_params("f32"), ds, num_boost_round=rounds,
                           device=dev)
    finally:
        gp.compact_carry = real
    factor = booster._gbdt._arena_factor()
    out = dict(seen[-1], factor=factor, tree=len(seen) - 1,
               card=torch.cuda.get_device_name(0),
               source="chip_smoke.py higgs_like(%d), PARAMS (f32, carried), "
                      "the last of %d trees" % (n, rounds))
    with open(path, "w") as f:
        json.dump(out, f)
    print("saved the carried leaf_seg of tree %d (%d leaves, %d rows) to %s"
          % (out["tree"], out["nl"], sum(c for _s, c in out["seg"]), path))
    return out


def carries(other: str, n: int, out_dir: str,
            carried: dict = None) -> None:
    """K6 of both trees, f32 and int8: the even, skewed and carried
    layouts (`carried`, else carried_leaf_seg.json), held equal, then
    timed."""
    dev = torch.device("cuda")
    impl = {tag: _load(src, "compact_carry", out_dir, tag)
            for tag, src in (("other", other), ("this", str(_cuda.CSRC)))}
    rng = np.random.RandomState(4)
    layouts = {}
    for kind, counts in (("even", np.full(LEAVES, n // LEAVES)),
                         ("skewed", _skewed_counts(n))):
        starts = np.zeros(len(counts), np.int64)
        pos = 0
        for leaf in rng.permutation(len(counts)):
            pos += int(rng.randint(0, 16))
            starts[leaf] = pos
            pos += int(counts[leaf])
        layouts[kind] = dict(seg=np.stack([starts, counts], 1).tolist(),
                             nl=len(counts), dst0=pk.pristine_work0(pos) + 777,
                             rows=n, factor=4)
    if carried is None and LEAF_SEG.exists():
        with open(LEAF_SEG) as f:
            carried = json.load(f)
    if carried is not None:
        layouts["carried"] = carried
    for quantized in (False, True):
        mode = "int8" if quantized else "f32"
        for kind, lay in layouts.items():
            seg = torch.tensor(lay["seg"], dtype=torch.int32, device=dev)
            nl = torch.tensor([lay["nl"]], dtype=torch.int32, device=dev)
            used = int(seg[:, 1].sum())
            arenas = {}
            for tag in impl:
                a = pk.Arena(lay["rows"], G, lay["factor"], dev,
                             quantized=quantized)
                gen = torch.Generator(device=dev).manual_seed(5)
                a.bins.copy_(torch.randint(0, 256, a.bins.shape, device=dev,
                                           dtype=torch.uint8, generator=gen))
                a.rid.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, a.rid.shape,
                                          device=dev, dtype=torch.int32,
                                          generator=gen))
                if quantized:
                    a.payload.copy_(torch.randint(
                        -128, 128, a.payload.shape, device=dev,
                        dtype=torch.int8, generator=gen))
                else:
                    a.payload.copy_(torch.randn(a.payload.shape, device=dev,
                                                generator=gen))
                arenas[tag] = a
            offs = torch.empty(seg.shape[0], dtype=torch.int32, device=dev)
            outs = {t: torch.empty(1, dtype=torch.int32, device=dev)
                    for t in impl}
            name = "lgbt_compact_carry" + ("_i8" if quantized else "")

            def call(t):
                fns, old = impl[t]
                a = arenas[t]
                args = [a.bins.data_ptr(), a.payload.data_ptr(),
                        a.rid.data_ptr(), a.cap, seg.data_ptr(),
                        nl.data_ptr(), seg.shape[0], offs.data_ptr(),
                        outs[t].data_ptr(), lay["dst0"], G]
                if old:
                    args.append(OLD_CARRY_BLOCKS)
                return lambda: _check(fns[name](*args, _cuda.stream()), "K6")
            runs = {t: call(t) for t in impl}
            for r in runs.values():
                r()
            torch.cuda.synchronize()
            same = (int(outs["other"][0]) == int(outs["this"][0]) == used
                    and all(torch.equal(getattr(arenas["other"], k),
                                        getattr(arenas["this"], k))
                            for k in ("bins", "payload", "rid")))
            nbytes = pk.compact_carry_bytes(used, G, seg.shape[0], quantized)
            print("K6 %s %s, %d leaves, %d rows (%d to %d a leaf; bound "
                  "%.4f ms): %s; the two trees %s" % (
                      mode, kind, lay["nl"], used, int(seg[:, 1].min()),
                      int(seg[:, 1].max()), nbytes / 3.35e12 * 1e3,
                      _both_ms(runs, 20), "agree" if same else "DIFFER"))
            del arenas
            torch.cuda.empty_cache()
        # the yardstick: a plain device copy of the bytes K6 moves
        src = torch.empty(nbytes // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        print("K6 %s yardstick: copy_ of %d MB, %.4f ms" % (
            mode, nbytes // 2 // 10 ** 6, cuda_ms(lambda: dst.copy_(src), 20)))
        del src, dst


def _scatter_layouts(n: int, carried: dict = None) -> dict:
    """K4's layouts, as K6's (`carries`): 255 even leaves and a skewed
    tree in a shuffled order at any column of a rid plane of their own
    length, and the carried tree's leaf_seg in its arena's plane."""
    rng = np.random.RandomState(8)
    layouts = {}
    for kind, counts in (("even", np.full(LEAVES, n // LEAVES)),
                         ("skewed", _skewed_counts(n))):
        starts = np.zeros(len(counts), np.int64)
        pos = 0
        for leaf in rng.permutation(len(counts)):
            pos += int(rng.randint(0, 16))
            starts[leaf] = pos
            pos += int(counts[leaf])
        layouts[kind] = dict(seg=np.stack([starts, counts], 1).tolist(),
                             nl=len(counts), cap=-(-pos // 2048) * 2048)
    if carried is None and LEAF_SEG.exists():
        with open(LEAF_SEG) as f:
            carried = json.load(f)
    if carried is not None:
        layouts["carried"] = carried
    return layouts


def scatters(other: str, n: int, out_dir: str, carried: dict = None) -> None:
    """K4 of both trees on the even, skewed and carried layouts, each
    leaf's row ids in the order a grown tree leaves them
    (`tools.tree_row_order`: the pristine root's row order for even and
    skewed, a previous 255-leaf tree's carried order for carried): set mode
    (f32 leaf values and int32 leaf ids) and add mode (shrinkage 0.1) held
    equal bit for bit, then timed in the order other, this, this, other,
    kernel-only beside.  Where the other tree's K4 has no add mode (the
    first version), its side of the add is the chain the add mode
    replaces: a zeroed delta, its K4 in set mode, a multiply and an add
    over n rows; where it takes the shrinkage by value (before the device
    scalar), it is given the number.  Beside them, the bounds and the library calls over the
    expanded (row, value) pairs: index_put_, with accumulate=True for the
    add."""
    dev = torch.device("cuda")
    impl = {tag: _load(src, "scatter_segments", out_dir, tag)
            for tag, src in (("other", other), ("this", str(_cuda.CSRC)))}
    shrink = 0.1
    s_t = torch.tensor(shrink, dtype=torch.float32, device=dev)
    for kind, lay in _scatter_layouts(n, carried).items():
        gen = torch.Generator(device=dev).manual_seed(9)
        seg_l = lay["seg"][:lay["nl"]]
        seg = torch.tensor(seg_l, dtype=torch.int32, device=dev)
        L = seg.shape[0]
        nl = torch.tensor([L], dtype=torch.int32, device=dev)
        rows = int(seg[:, 1].sum())
        rid = torch.randint(-2 ** 31, 2 ** 31 - 1, (lay["cap"],),
                            generator=gen, dtype=torch.int32, device=dev)
        counts = [c for _s, c in seg_l]
        order = torch.from_numpy(tree_row_order(
            counts, np.random.RandomState(len(kind)),
            LEAVES if kind == "carried" else 0)).to(dev)
        pos = 0
        for s0, c in seg_l:
            rid[s0:s0 + c] = order[pos:pos + c]
            pos += c
        vals = torch.randn(L, generator=gen, device=dev)
        ids = torch.arange(L, dtype=torch.int32, device=dev)
        score0 = torch.randn(rows, generator=gen, device=dev)
        outs = {t: {"f32": torch.zeros(rows, device=dev),
                    "i32": torch.zeros(rows, dtype=torch.int32, device=dev),
                    "add": score0.clone()} for t in impl}

        def set_call(t, v, out):
            fns, old = impl[t]
            name = "lgbt_scatter_segments_%s" % (
                "f32" if v.dtype == torch.float32 else "i32")
            args = [rid.data_ptr(), seg.data_ptr(), v.data_ptr(),
                    nl.data_ptr(), out.data_ptr(), L]
            if old:
                args.append(OLD_SCATTER_BLOCKS)
            return lambda: _check(fns[name](*args, _cuda.stream()), "K4")

        def add_call(t):
            fns, old = impl[t]
            out = outs[t]["add"]
            if old:
                def chain():
                    delta = torch.zeros(rows, device=dev)
                    set_call(t, vals, delta)()
                    out.add_(delta * s_t)
                return chain
            s_arg = (shrink if fns["lgbt_scatter_segments_add"].argtypes
                     == ADD_BY_VALUE else s_t.data_ptr())
            return lambda: _check(fns["lgbt_scatter_segments_add"](
                rid.data_ptr(), seg.data_ptr(), vals.data_ptr(),
                nl.data_ptr(), s_arg, out.data_ptr(), L, _cuda.stream()),
                "K4 add")
        runs = {"set": {t: set_call(t, vals, outs[t]["f32"]) for t in impl},
                "add": {t: add_call(t) for t in impl}}
        for t in impl:
            set_call(t, ids, outs[t]["i32"])()
            runs["set"][t]()
            runs["add"][t]()
        torch.cuda.synchronize()
        same = all(torch.equal(outs["other"][k].view(torch.int32),
                               outs["this"][k].view(torch.int32))
                   for k in ("f32", "i32", "add"))
        rid_all = torch.cat([rid[s0:s0 + c].long() for s0, c in seg_l])
        val_all = torch.cat([vals[i].expand(c)
                             for i, (_s, c) in enumerate(seg_l)])
        prod = val_all * s_t
        lib_out = torch.zeros(rows, device=dev)
        lib = {"set": lambda: lib_out.index_put_((rid_all,), val_all),
               "add": lambda: lib_out.index_put_((rid_all,), prod,
                                                 accumulate=True)}
        for mode in ("set", "add"):
            nbytes = pk.scatter_bytes(rows, L, add=mode == "add")
            print("K4 %s %s, %d leaves, %d rows (%d to %d a leaf; bound "
                  "%.4f ms; index_put_%s %.4f ms): %s%s; the two trees %s" % (
                      mode, kind, L, rows, int(seg[:, 1].min()),
                      int(seg[:, 1].max()), nbytes / 3.35e12 * 1e3,
                      ", accumulate" if mode == "add" else "",
                      cuda_ms(lib[mode], 5), _both_ms(runs[mode], 20),
                      " (other: the replaced chain)" if mode == "add"
                      and impl["other"][1] else "",
                      "agree" if same else "DIFFER"))
        del rid, order, rid_all, val_all, prod, outs, lib_out
        torch.cuda.empty_cache()


def _first_kp1_tables(trees, dev) -> list:
    """The first KP1's walk tables (node_off, leaf_off, cat_off, feature,
    threshold, decision, left, right, leaf_value, cat_bound, cat_words),
    as its ops/predict.py build_tables laid them out: per node 21 bytes,
    per leaf 8, children ~leaf for a leaf."""
    nn = [max(t.num_leaves - 1, 0) for t in trees]
    nl = [max(t.num_leaves, 1) for t in trees]
    node_off = np.concatenate([[0], np.cumsum(nn)]).astype(np.int32)
    leaf_off = np.concatenate([[0], np.cumsum(nl)]).astype(np.int32)
    N, L = max(int(node_off[-1]), 1), max(int(leaf_off[-1]), 1)
    cols = dict(feature=np.zeros(N, np.int32),
                threshold=np.zeros(N, np.float64),
                decision=np.zeros(N, np.int8), left=np.zeros(N, np.int32),
                right=np.zeros(N, np.int32))
    leaf_value = np.zeros(L, np.float64)
    cat_off = np.zeros(len(trees) + 1, np.int32)
    bounds, words = [], []
    for ti, t in enumerate(trees):
        a, k = node_off[ti], nn[ti]
        for name, src in (("feature", t.split_feature),
                          ("threshold", t.threshold),
                          ("decision", t.decision_type),
                          ("left", t.left_child), ("right", t.right_child)):
            cols[name][a:a + k] = src[:k]
        leaf_value[leaf_off[ti]:leaf_off[ti] + nl[ti]] = t.leaf_value[:nl[ti]]
        if t.num_cat > 0:
            bounds.extend(len(words) + int(b) for b in t.cat_boundaries)
            words.extend(int(w) for w in t.cat_threshold)
        cat_off[ti + 1] = len(bounds)
    arrays = [node_off, leaf_off, cat_off, cols["feature"],
              cols["threshold"], cols["decision"], cols["left"],
              cols["right"], leaf_value, np.array(bounds or [0], np.int32),
              np.array(words or [0], np.uint32).view(np.int32)]
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _kp1_model(n: int, path: str):
    """The trees of a KP1_ROUNDS-round model of chip_smoke.py's
    configuration (f32, carried) trained on its data at n rows, saved as
    model text at path (read back if it is there), the data, and
    chip_smoke itself."""
    import lightgbm_tpu_torch as lt
    from ..interop import booster_from_model_string
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    dev = torch.device("cuda", torch.cuda.current_device())
    X, y, Xh, _yh = cs.higgs_like(n)
    if not os.path.exists(path):
        ds = lt.Dataset(X, y, params=cs.PARAMS, device=dev).construct()
        bst = lt.train(cs.path_params("f32"), ds,
                       num_boost_round=KP1_ROUNDS, device=dev)
        with open(path, "w") as f:
            f.write(bst.model_to_string())
        del bst, ds
        torch.cuda.empty_cache()
    with open(path) as f:
        text = f.read()
    trees = booster_from_model_string(text, device=dev)._gbdt.models
    return trees, X, Xh, cs


_KP1_WALL = r"""
import sys, time, numpy as np, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import lightgbm_tpu_torch as lt
import chip_smoke as cs
X, _y, Xh, _yh = cs.higgs_like(int(sys.argv[4]))
with open(sys.argv[3]) as f:
    bst = lt.Booster(model_str=f.read(), device=torch.device("cuda"))
out = []
for what, Xs in (("holdout", Xh), ("train", X[:int(sys.argv[4])])):
    for dt in (np.float32, np.float64):
        Xn = np.ascontiguousarray(Xs, dt)
        bst.predict(Xn, raw_score=True)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bst.predict(Xn, raw_score=True)
            ms.append((time.perf_counter() - t) * 1e3)
        out.append("%s %s %.3f" % (what, np.dtype(dt).name, min(ms)))
print("; ".join(out))
"""


def kp1_sweep(tb, T: int, Xh, call_other, old: bool) -> None:
    """KP1's two paths of this tree and the other tree's walk over the
    first m rows of the holdout (f32; the first KP1 takes them as f64), m
    from one row to the whole holdout: held equal bit for bit, then timed
    by CUDA events over back-to-back calls in the order other, tiles,
    small, small, tiles, other (the small-batch walk whatever its default
    cap, the row tiles whatever their width)."""
    from ..ops.predict_kernel import predict_ensemble
    dev = torch.device("cuda")
    for m in KP1_SWEEP_ROWS:
        x32 = torch.from_numpy(np.ascontiguousarray(Xh[:m], np.float32)
                               ).to(dev)
        xo = x32.double() if old else x32
        outs = {k: torch.empty((1, m), dtype=torch.float64, device=dev)
                for k in ("other", "tiles", "small")}
        runs = {"other": lambda: call_other(xo, outs["other"]),
                "tiles": lambda: predict_ensemble(tb, x32, T, 1,
                                                  outs["tiles"], small=False),
                "small": lambda: predict_ensemble(tb, x32, T, 1,
                                                  outs["small"], small=True)}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        same = (torch.equal(outs["other"], outs["tiles"])
                and torch.equal(outs["tiles"], outs["small"]))
        reps = 50 if m <= 8192 else 10
        ev = {}
        for tag in ("other", "tiles", "small", "small", "tiles", "other"):
            ev.setdefault(tag, []).append(cuda_ms(runs[tag], reps))
        print("KP1 sweep, %d rows x %d trees, X f32: other %s; this tiles "
              "%s; this small %s ms (CUDA events, %d calls); %s" % (
                  m, T, *("/".join("%.4f" % v for v in ev[t])
                          for t in ("other", "tiles", "small")), reps,
                  "the paths agree" if same else "DIFFER"))
        del x32, xo, outs
        torch.cuda.empty_cache()


def kp1(other: str, n: int, out_dir: str) -> None:
    """KP1 of both trees on one 500-round model over the 100k holdout and
    n training rows: sums held equal bit for bit (the other tree's f64
    rows; this tree's f64 and f32 rows), then timed in the order other,
    this, this, other, kernel-only beside, with the node visits (the
    depths of the leaves reached) per ns; then the wall of Booster.predict
    from numpy (f32 and f64 rows) of each tree's package, a process each,
    in the same order."""
    from ..ops import predict as pr
    dev = torch.device("cuda")
    model_path = os.path.join(out_dir, "kp1_model_%d.txt" % n)
    trees, X, Xh, cs = _kp1_model(n, model_path)
    T = len(trees)
    fns, old = _load(other, "predict_ensemble", out_dir, "other")
    tb = pr.build_tables(trees, dev)
    from ..ops.predict_kernel import predict_ensemble
    first = _first_kp1_tables(trees, dev) if old else None
    depths = cs.leaf_depths(trees, dev)
    print("KP1 model: %d trees, %d leaves, %d walk-table bytes (the first "
          "layout %s)" % (T, sum(t.num_leaves for t in trees),
                          sum(x.numel() * x.element_size() for x in tb
                              if isinstance(x, torch.Tensor)),
                          sum(x.numel() * x.element_size() for x in first)
                          if old else "not built"))

    def call_other(Xd, out):
        if old:
            _check(fns["lgbt_predict_ensemble"](
                *(x.data_ptr() for x in first), Xd.data_ptr(), Xd.shape[0],
                Xd.shape[1], T, 1, 0, 1, 0.0, out.data_ptr(), Xd.shape[0],
                0, _cuda.stream()), "KP1 other")
        else:
            _check(fns["lgbt_predict_ensemble"](
                *(getattr(tb, k).data_ptr() for k in (
                    "items", "tree_off", "group_off", "cat_off",
                    "cat_bound", "cat_words")), Xd.data_ptr(),
                int(Xd.dtype == torch.float32), Xd.shape[0], Xd.shape[1],
                tb.max_feature + 1, T, 1, 0, 1, 0.0, tb.stage_items,
                out.data_ptr(), Xd.shape[0], 0, _cuda.stream()),
                "KP1 other")

    for what, Xs in (("holdout", Xh), ("train", X[:n])):
        x64 = torch.from_numpy(np.ascontiguousarray(Xs, np.float64)).to(dev)
        x32 = torch.from_numpy(np.ascontiguousarray(Xs, np.float32)).to(dev)
        m = x64.shape[0]
        outs = {k: torch.empty((1, m), dtype=torch.float64, device=dev)
                for k in ("other", "f64", "f32")}
        call_other(x64, outs["other"])
        predict_ensemble(tb, x64, T, 1, outs["f64"], small=False)
        predict_ensemble(tb, x32, T, 1, outs["f32"], small=False)
        torch.cuda.synchronize()
        same = (torch.equal(outs["other"], outs["f64"])
                and torch.equal(outs["f64"], outs["f32"]))
        visits = cs.walk_visits(tb, depths, x64, T)
        reps = 10 if m <= KP1_HOLDOUT else 3
        for dt, xd in (("f64", x64), ("f32", x32)):
            runs = {"other": lambda xd=xd: call_other(x64 if old else xd,
                                                     outs["other"]),
                    "this": lambda xd=xd, dt=dt: predict_ensemble(
                        tb, xd, T, 1, outs[dt], small=False)}
            ev = {}
            for tag in ("other", "this", "this", "other"):
                ev.setdefault(tag, []).append(cuda_ms(runs[tag], reps))
            ko = {tag: _kernel_ms(runs[tag], reps)
                  for tag in ("other", "this")}
            print("KP1 %s, %d rows x %d trees, X %s (the first KP1's f64): "
                  "other %.4f, this %.4f, this %.4f, other "
                  "%.4f ms; kernel-only, ms: other %s; this %s; %d visits "
                  "(%.1f a row): %.4f ns a visit this (%.4g visits/s), "
                  "%.4f other; the trees %s" % (
                      what, m, T, dt, ev["other"][0], ev["this"][0],
                      ev["this"][1], ev["other"][1], ko["other"],
                      ko["this"], visits, visits / m,
                      min(ev["this"]) * 1e6 / visits,
                      visits / min(ev["this"]) * 1e3,
                      min(ev["other"]) * 1e6 / visits,
                      "agree" if same else "DIFFER"))
        del x64, x32, outs
        torch.cuda.empty_cache()
    kp1_sweep(tb, T, Xh, call_other, old)
    # the wall of predict from numpy, each tree's package in a process
    roots = {"other": str(Path(other).resolve().parents[1]),
             "this": str(Path(__file__).resolve().parents[2])}
    for tag in ("other", "this", "this", "other"):
        r = subprocess.run([sys.executable, "-c", _KP1_WALL, roots[tag],
                            roots["this"], model_path, str(n)],
                           capture_output=True, text=True)
        line = (r.stdout.strip().splitlines() or ["(no output)"])[-1]
        print("KP1 predict from numpy, %s package, ms (best of 3): %s%s"
              % (tag, line, "" if r.returncode == 0
                 else "; FAILED: " + r.stderr[-400:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("rows_millions", nargs="?", type=float, default=10.5)
    ap.add_argument("--save-leaf-seg", metavar="PATH")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections to run, of %s"
                    % ", ".join(SECTIONS))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available() or (args.other is None
                                         and not args.save_leaf_seg):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    n = int(args.rows_millions * 1e6)
    print("%s; other tree %s" % (torch.cuda.get_device_name(0), args.other))
    _cuda.build()
    carried = None
    if args.save_leaf_seg:
        carried = save_leaf_seg(args.save_leaf_seg, n)
        torch.cuda.empty_cache()
    if args.other is None:
        return 0
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        print("--only takes %s" % ", ".join(SECTIONS), file=sys.stderr)
        return 1
    out_dir = str(_cuda.BUILD_DIR / "compare")
    os.makedirs(out_dir, exist_ok=True)
    if "sass" in only:
        for stem in ("partition_segment", "leaf_histogram",
                     "segment_histogram", "fused_root_histogram",
                     "split_scan", "compact_carry", "scatter_segments",
                     "predict_ensemble"):
            sass_report(args.other, stem, out_dir)
    sections = (("K3", lambda: partitions(args.other, n, out_dir)),
                ("K7", lambda: leaf_histograms(args.other, n, out_dir)),
                ("K2", lambda: histograms(args.other, n, out_dir)),
                ("K1", lambda: scans(args.other, out_dir)),
                ("K6", lambda: carries(args.other, n, out_dir, carried)),
                ("K4", lambda: scatters(args.other, n, out_dir, carried)),
                ("KP1", lambda: kp1(args.other, min(n, 1_000_000),
                                    out_dir)))
    for name, run in sections:
        if name in only:
            run()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
