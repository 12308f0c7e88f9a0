"""Build, load and call the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` process into a shared
library with a plain C interface (no PyTorch headers, so a file builds in
seconds), all processes started together.  The libraries land in
`lightgbm_tpu_torch/_build/`, named by a hash of the sources and flags, so a
second call in the same checkout reuses them.  Nothing is built at import
time: the first wrapper that launches a kernel on a CUDA tensor triggers the
build.

Every entry point takes device pointers and the current stream and returns
`cudaGetLastError()`; `check` raises `KernelError` on anything but 0, as
`build` does when a source fails to compile.  `LAUNCHES` counts the
launches each wrapper made, so a run can show which kernels its path went
through; the build and the counts are safe from several threads at once
(a serving process launches from its batchers, warmups and promotions).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

# source stem -> {C entry point: argtypes}
_ENTRY_POINTS = {
    "split_scan": {
        "lgbt_split_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "segment_histogram": {
        "lgbt_segment_histogram": [_P, _P, _P, _P, _I, _I, _LL, _I, _P],
        "lgbt_segment_histogram_i8": [_P, _P, _P, _P, _I, _I, _LL, _I, _P]},
    "fused_root_histogram": {
        "lgbt_fused_root_histogram": [_P, _P, _P, _LL, _P, _P, _I, _I, _LL,
                                      _I, _P]},
    "partition_segment": {
        "lgbt_partition_segment": [_P, _P, _P, _LL, _P, _P, _P, _LL, _LL, _I,
                                   _P],
        "lgbt_partition_segment_i8": [_P, _P, _P, _LL, _P, _P, _P, _LL, _LL,
                                      _I, _P],
        "lgbt_partition_segment_pred": [_P, _P, _P, _LL, _P, _P, _LL, _P, _LL,
                                        _LL, _I, _P, _I, _I, _P],
        "lgbt_partition_segment_pred_i8": [_P, _P, _P, _LL, _P, _P, _LL, _P,
                                           _LL, _LL, _I, _P, _I, _I, _P]},
    "partition_ablate": {
        "lgbt_partition_ablate": [_I, _P, _P, _P, _LL, _P, _P, _P, _LL, _LL,
                                  _I, _P, _P],
        "lgbt_partition_ablate_i8": [_I, _P, _P, _P, _LL, _P, _P, _P, _LL,
                                     _LL, _I, _P, _P]},
    "leaf_histogram": {
        "lgbt_leaf_histogram": [_P, _P, _P, _P, _P, _LL, _P, _I, _I, _P, _P,
                                _I, _I, _P],
        "lgbt_leaf_histogram_i8": [_P, _P, _P, _P, _P, _LL, _P, _I, _I, _P,
                                   _P, _I, _I, _P],
        **{"lgbt_leaf_histogram_" + form: [_P, _P, _P, _P, _P, _LL, _P, _I,
                                           _I, _P, _P, _I, _I, _P]
           for form in ("u16", "f64", "u16_f64")}},
    "scatter_segments": {
        "lgbt_scatter_segments_f32": [_P, _P, _P, _P, _P, _I, _P],
        "lgbt_scatter_segments_i32": [_P, _P, _P, _P, _P, _I, _P],
        "lgbt_scatter_segments_add": [_P, _P, _P, _P, _P, _P, _I, _P]},
    "compact_carry": {
        "lgbt_compact_carry": [_P, _P, _P, _LL, _P, _P, _I, _P, _P, _LL, _I,
                               _P],
        "lgbt_compact_carry_i8": [_P, _P, _P, _LL, _P, _P, _I, _P, _P, _LL,
                                  _I, _P]},
    "predict_ensemble": {
        "lgbt_predict_ensemble": [_P] * 7 + [_I, _LL, _I, _I, _I, _I, _I,
                                             _I, _D, _I, _P, _LL, _P, _P],
        "lgbt_predict_ensemble_small": [_P] * 7 + [_I, _LL, _I, _I, _I, _I,
                                                   _I, _I, _D, _I, _P, _LL,
                                                   _P, _P, _P]},
    "walk_binned": {
        "lgbt_walk_binned": [_P] * 7 + [_I, _P, _P, _I] + [_P] * 4
                            + [_P, _I, _LL, _I, _P, _P, _I, _P, _P, _P, _P,
                               _I, _P]},
}

LAUNCHES: Counter = Counter()
_FUNCS: Dict[str, object] = {}
BUILD_LOG: Dict[str, object] = {}
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel that did not build or did not launch.  Nothing in the port
    falls back to the CPU or to a plain version on it."""


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels cannot be built "
                          "(CUDA_HOME, /usr/local/cuda and PATH searched)")
    return found


def _lib_path(stem: str) -> Path:
    h = hashlib.sha1()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / (stem + ".cu")]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("%s-%s.so" % (stem, h.hexdigest()[:12]))


def build(verbose: bool = False) -> Dict[str, object]:
    """Compile every kernel source that has no up-to-date library, one
    nvcc per source, all in parallel; load all libraries.  Returns a log:
    seconds taken, the sources compiled and those found built (`cached`)
    and, with verbose, each compiler's output (ptxas register and
    shared-memory use)."""
    with _BUILD_LOCK:
        if not _FUNCS:
            _build(verbose)
    return BUILD_LOG


def _build(verbose: bool) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    for stem in _ENTRY_POINTS:
        out = _lib_path(stem)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(".tmp%d.so" % os.getpid())
        cmd = [find_nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / (stem + ".cu"))]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    outputs = {}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        outputs[stem] = text
        if proc.returncode != 0:
            failed.append(stem)
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(outputs[s] for s in failed)))
    funcs = {}
    for stem, entries in _ENTRY_POINTS.items():
        lib = ctypes.CDLL(str(_lib_path(stem)))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            funcs[name] = fn
    BUILD_LOG.update(seconds=time.perf_counter() - t0, compiled=sorted(procs),
                     cached=sorted(set(_ENTRY_POINTS) - set(procs)),
                     output=outputs)
    _FUNCS.update(funcs)


def fn(name: str):
    """The loaded C entry point `name` (building the libraries first)."""
    f = _FUNCS.get(name)
    if f is None:
        build()
        f = _FUNCS[name]
    return f


def stream(device: Optional[torch.device] = None) -> int:
    """The current CUDA stream of device (the current device by default),
    as the raw handle the entry points take."""
    index = torch.cuda.current_device() if device is None or \
        device.index is None else device.index
    return _raw_stream(index)


def _raw_stream(index: int) -> int:
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise KernelError("CUDA kernel %s failed to launch: cudaError %d"
                          % (kernel, rc))
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device,
            shape: Optional[tuple] = None) -> None:
    """Raise unless t has the dtype, device, shape and contiguity the
    kernel takes."""
    if t.dtype != dtype:
        raise TypeError("%s: dtype %s, expected %s" % (name, t.dtype, dtype))
    if t.device != device:
        raise ValueError("%s: on %s, expected %s" % (name, t.device, device))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s: shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def plain_or_cuda(device: torch.device) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (run
    the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError("no kernel or plain version for device %s" % device)
