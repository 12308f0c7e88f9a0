"""Another build of the port's kernels against this one, on the card.

    python -m lightgbm_tpu_torch.tools.compare_builds OTHER_CSRC [rows_millions]

OTHER_CSRC is the `lightgbm_tpu_torch/csrc` directory of another checkout
(a parent commit unpacked with `git archive`, say).  In one process:

1. K3 (`partition_segment.cu`) of both trees compiled with `ptxas -v` to
   cubins: each kernel's resource line and whether its SASS
   (`cuobjdump -sass`, kernel names demangled and K8's stage template
   argument dropped) is identical;
2. K2 f32, K2 int8 and K5 of both trees at the root of a random
   10.5M-row, 28-feature arena (or rows_millions), timed in the order
   other, this, this, other (CUDA events over 20 launches each);
3. this tree's K7 at the same rows, f32 and int8, at the root and on one
   leaf of 255 spread over the rows, at 132, 264 (the wrapper's grid) and
   528 blocks.

Needs nvcc and a CUDA device; builds into lightgbm_tpu_torch/_build/compare
and prints one line per kernel.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import _cuda
from ..ops import partition_kernel as pk
from . import cuda_ms

G, B, LEAVES = 28, 255, 255
K3_STAGE_ARG = re.compile(r", \(int\)3>")


def _tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_cuda.find_nvcc()), name)
    return path if os.path.exists(path) else name


def _demangle(names):
    r = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                       text=True, capture_output=True)
    return r.stdout.strip().split("\n") if r.returncode == 0 else list(names)


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


def k3_sass(other: str, out_dir: str) -> None:
    """Resource line and SASS identity of every K3 kernel."""
    res = {}
    for tag, src in (("other", other), ("this", str(_cuda.CSRC))):
        cubin = os.path.join(out_dir, "k3_%s.cubin" % tag)
        text = _nvcc(src, "partition_segment", cubin, cubin=True)
        lines, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = m.group(1)
            elif "Used" in line and cur:
                lines[cur] = line.split(":", 1)[-1].strip()
        names = list(lines)
        res_lines = {K3_STAGE_ARG.sub(">", d): lines[n]
                     for n, d in zip(names, _demangle(names))}
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True)
        bodies, cur = {}, None
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = K3_STAGE_ARG.sub(">", _demangle([m.group(1)])[0])
                bodies[cur] = []
            elif cur is not None:
                bodies[cur].append(re.sub(r"_Z\w+", "SYM", line.strip()))
        res[tag] = (res_lines, bodies)
    (ol, ob), (tl, tb) = res["other"], res["this"]
    for k in sorted(set(ol) | set(tl)):
        print("K3 %s: other %s; this %s; SASS %s" % (
            k.split("(")[0], ol.get(k), tl.get(k),
            "identical" if ob.get(k) == tb.get(k) else "DIFFERS"))


def _load(src_dir: str, stem: str, out_dir: str, tag: str):
    out = os.path.join(out_dir, "%s_%s.so" % (stem, tag))
    text = _nvcc(src_dir, stem, out, cubin=False)
    print("%s %s: %s" % (tag, stem, "; ".join(
        l.split(":", 1)[-1].strip() for l in text.splitlines()
        if "Used" in l or "spill stores" in l)))
    lib = ctypes.CDLL(out)
    fns = {}
    for name, argtypes in _cuda._ENTRY_POINTS[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def histograms(other: str, n: int, out_dir: str) -> None:
    """K2 and K5 of both trees, alternating; this tree's K7 by grid."""
    dev = torch.device("cuda")
    libs = {tag: {} for tag in ("other", "this")}
    for stem in ("segment_histogram", "fused_root_histogram"):
        for tag, src in (("other", other), ("this", str(_cuda.CSRC))):
            libs[tag].update(_load(src, stem, out_dir, tag))
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)
                            ).to(dev)
    af = pk.Arena(n, G, 4, dev)
    aq = pk.Arena(n, G, 4, dev, quantized=True)
    for a in (af, aq):
        pk.init_pristine(a, bins)
    af.payload[:, :n] = torch.from_numpy(
        rng.randn(2, n).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.randint(-127, 128, (2, n)).astype(np.int8)
                             ).to(dev)
    aq.payload[:, :n] = codes
    seg = torch.tensor([0, n], dtype=torch.int32, device=dev)
    s = _cuda.stream()
    out_f = torch.zeros((G, B, 3), device=dev)
    out_i = torch.zeros((G, B, 3), dtype=torch.int32, device=dev)

    def k2(tag, a, name, out):
        return lambda: libs[tag][name](
            a.bins.data_ptr(), a.payload.data_ptr(), seg.data_ptr(),
            out.data_ptr(), G, B, a.cap, pk.HIST_BLOCKS, s)

    def k5(tag):
        return lambda: libs[tag]["lgbt_fused_root_histogram"](
            aq.bins.data_ptr(), aq.payload.data_ptr(), codes.data_ptr(), n,
            seg.data_ptr(), out_i.data_ptr(), G, B, aq.cap, pk.HIST_BLOCKS, s)

    cases = (("K2 f32", lambda t: k2(t, af, "lgbt_segment_histogram", out_f)),
             ("K2 int8", lambda t: k2(t, aq, "lgbt_segment_histogram_i8",
                                      out_i)),
             ("K5", k5))
    for name, make in cases:
        print("%s root, %d rows, ms: %s" % (name, n, ", ".join(
            "%s %.4f" % (t, cuda_ms(make(t), 20))
            for t in ("other", "this", "this", "other"))))
    del af, aq
    rows = bins.t().contiguous()
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
    leaves = torch.from_numpy(rng.randint(0, LEAVES, n).astype(np.int32)
                              ).to(dev)
    child = 7
    m = int((leaves == child).sum())
    f32 = _cuda.fn("lgbt_leaf_histogram")
    i8 = _cuda.fn("lgbt_leaf_histogram_i8")
    for grid in (132, 264, 528):
        parts = []
        for what, ids, leaf in (("root", torch.zeros_like(leaves), 0),
                                ("leaf of %d rows" % m, leaves, child)):
            lf = torch.tensor([leaf], dtype=torch.int32, device=dev)
            ids8 = ids.to(torch.uint8)
            parts.append("%s f32 %.4f int8 %.4f" % (what, cuda_ms(
                lambda: f32(rows.data_ptr(), g.data_ptr(), h.data_ptr(),
                            ids.data_ptr(), lf.data_ptr(), n, out_f.data_ptr(),
                            G, B, grid, s), 20), cuda_ms(
                lambda: i8(rows.data_ptr(), codes[0].data_ptr(),
                           codes[1].data_ptr(), ids8.data_ptr(),
                           lf.data_ptr(), n, out_i.data_ptr(), G, B, grid,
                           s), 20)))
        print("K7 at %d blocks, ms: %s" % (grid, "; ".join(parts)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    n = int(float(argv[1]) * 1e6) if len(argv) > 1 else 10_500_000
    print("%s; other tree %s" % (torch.cuda.get_device_name(0), argv[0]))
    _cuda.build()
    out_dir = str(_cuda.BUILD_DIR / "compare")
    os.makedirs(out_dir, exist_ok=True)
    k3_sass(argv[0], out_dir)
    histograms(argv[0], n, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
