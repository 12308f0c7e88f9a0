"""Device-side observability on the card: the caching allocator's live
state and the kernels' build log.

The port's counterpart of lightgbm_tpu/obs/device.py.  A quantity that
exists on the card keeps the JAX package's name (obs/adapters.py): live
device allocations and their bytes, the high-water mark of device bytes,
backend compilations (here each kernel source that `nvcc` compiled,
ops/_cuda.build) and compilation-cache hits (each source whose library
was found already built under `_build/`).  The JAX package's jaxpr traces,
pjit cache entries, XLA cost analyses and donation audits have no
counterpart: PyTorch runs eagerly and the kernels take any shape, so
nothing is traced or retraced.

On the CPU every allocator quantity reads 0; nothing here raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _cuda(device) -> Optional[torch.device]:
    if device is None:
        return None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def device_stats(device=None) -> Dict[str, int]:
    """The caching allocator's view of `device`: live allocations
    (`active.all.current`), their bytes (`memory_allocated`) and the
    high-water mark of those bytes (`max_memory_allocated`); zeros for the
    CPU.  Host-side bookkeeping only, no device sync."""
    dev = _cuda(device)
    if dev is None or not torch.cuda.is_available():
        return {"live_buffers": 0, "live_bytes": 0, "peak_bytes": 0}
    stats = torch.cuda.memory_stats(dev)
    return {"live_buffers": int(stats.get("active.all.current", 0)),
            "live_bytes": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def compile_counts() -> Dict[str, int]:
    """Kernel sources compiled by this process's build (`nvcc` runs) and
    found already built; zeros before the first launch."""
    from ..ops import _cuda as cuda_ops
    log = cuda_ops.BUILD_LOG
    return {"backend_compiles": len(log.get("compiled", ())),
            "cache_hits": len(log.get("cached", ()))}
