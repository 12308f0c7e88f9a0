"""Another build of the port's kernels against this one, on the card.

    python -m lightgbm_tpu_torch.tools.compare_builds OTHER_CSRC [rows_millions]
        [--save-leaf-seg PATH]

OTHER_CSRC is the `lightgbm_tpu_torch/csrc` directory of another checkout
(a parent commit unpacked with `git archive`, say).  In one process:

1. K3 (`partition_segment.cu`), K7 (`leaf_histogram.cu`), K2
   (`segment_histogram.cu`), K5 (`fused_root_histogram.cu`), K1
   (`split_scan.cu`) and K6 (`compact_carry.cu`) of both trees compiled
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
   moves (half read, half written) as the yardstick of a plain copy.

The other tree's K3, K7, K1 and K6 may take the C interface of the first
versions (a scratch arena and block counts for K3, no row list for K7, no
ticket for K1, two launches over a grid of blocks a leaf for K6); the
tool reads which from the other tree's sources.
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
from . import cuda_ms

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
}
OLD_PART_BLOCKS, OLD_PRED_BLOCKS, OLD_LEAF_BLOCKS = 1024, 264, 264
OLD_CARRY_BLOCKS = 64


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
    return fns, old


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("rows_millions", nargs="?", type=float, default=10.5)
    ap.add_argument("--save-leaf-seg", metavar="PATH")
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
    out_dir = str(_cuda.BUILD_DIR / "compare")
    os.makedirs(out_dir, exist_ok=True)
    for stem in ("partition_segment", "leaf_histogram", "segment_histogram",
                 "fused_root_histogram", "split_scan", "compact_carry"):
        sass_report(args.other, stem, out_dir)
    partitions(args.other, n, out_dir)
    torch.cuda.empty_cache()
    leaf_histograms(args.other, n, out_dir)
    torch.cuda.empty_cache()
    histograms(args.other, n, out_dir)
    torch.cuda.empty_cache()
    scans(args.other, out_dir)
    carries(args.other, n, out_dir, carried)
    return 0


if __name__ == "__main__":
    sys.exit(main())
