"""CUDA graphs of the driver's rounds.

The JAX package compiles a boosting round into one program
(lightgbm_tpu/models/gbdt.py `_build_fused_iter` :719-780 and
`_build_fused_iter_carried` :904-984, jitted) and dispatches it once.  A
PyTorch round is tens of thousands of eager launches: the growers' Python
loops of L-1 steps, each with K3, K2, K1 and about a hundred small
launches of table bookkeeping.  Their counterpart of `jit` is a CUDA graph:
`RoundGraphs.run` captures a round's launches once per static key and
replays them with one call.

A function run here keeps these rules:
- it reads its inputs from device buffers that the caller owns and
  rewrites before each call, and bakes in only Python values that the key
  fixes (arena columns, leaf counts, the shrinkage);
- nothing between its inputs and its outputs reads a value on the host or
  copies one to the device (a capture refuses both);
- it returns a tuple of tensors, its outputs, which are the graph's own
  and are overwritten by its next replay;
- a caller consumes the outputs on the stream before the next call of any
  key: the graphs share one memory pool (torch.cuda.graph_pool_handle()),
  so one graph's temporaries may lie where another's outputs lay when it
  ran.  They never run at the same time.

The first call of the cache for a warm-up key runs the function eagerly on
the cache's side stream: it builds the kernels, loads their modules and
makes the per-stream state (K1's tickets) that a capture must find made.
The first call of each key after that captures the function on the same
stream, instantiates the graph and replays it; later calls replay it.  A
capture or replay fault raises: nothing falls back to eager launches.

`_cuda.LAUNCHES` counts at the wrappers, which a capture runs once without
launching: a capture's counts are taken back and kept with its graph, and
added at every replay.  On a CPU device `run` calls the function: there
are no graphs.
"""
from __future__ import annotations

import ctypes
import time
from collections import Counter
from typing import Callable, Dict, Hashable, List, Tuple

import torch

from . import _cuda

Outputs = Tuple[torch.Tensor, ...]


class _Graph:
    """One captured round: the graph, its outputs, the launches a replay
    makes by kernel, its node count and the seconds its capture and
    instantiation took."""

    def __init__(self, graph, outputs: Outputs, launches: Counter,
                 nodes: int, seconds: float):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.nodes = nodes
        self.seconds = seconds
        self.replays = 0


class RoundGraphs:
    """A booster's CUDA graphs, keyed by what a capture bakes in."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = _cuda.plain_or_cuda(self.device)
        self.graphs: Dict[Hashable, _Graph] = {}
        self._warm = set()
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    def run(self, key: Hashable, warm_key: Hashable,
            fn: Callable[[], Outputs]) -> Outputs:
        """fn's outputs, from its graph under `key` on a CUDA device; the
        first call for `warm_key` (the key less what changes no kernel,
        say the carried slot) runs fn eagerly."""
        if not self.cuda:
            return fn()
        g = self.graphs.get(key)
        if g is None:
            if warm_key not in self._warm:
                out = self._side_stream(fn)
                self._warm.add(warm_key)
                return out
            g = self.graphs[key] = self._capture(fn)
        g.graph.replay()
        g.replays += 1
        _cuda.LAUNCHES.update(g.launches)
        return g.outputs

    def _side_stream(self, fn) -> Outputs:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        for t in out:
            if t.numel():
                t.record_stream(cur)
        return out

    def _capture(self, fn) -> _Graph:
        before = Counter(_cuda.LAUNCHES)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = fn()
        nodes = graph_nodes(graph)
        graph.instantiate()
        seconds = time.perf_counter() - t0
        launches = _cuda.LAUNCHES - before
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(before)
        return _Graph(graph, out, launches, nodes, seconds)

    def reset(self) -> None:
        """Drop every graph (their pool with them); the next call of each
        key captures anew."""
        self.graphs.clear()
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()

    def stats(self) -> List[dict]:
        """Each graph's key, node count, capture-and-instantiate seconds,
        replays and launches of the port's kernels a replay."""
        return [dict(key=repr(k), nodes=g.nodes, capture_s=g.seconds,
                     replays=g.replays, launches=sum(g.launches.values()))
                for k, g in self.graphs.items()]


_LIBCUDA = None


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured graph kept before instantiation
    (`keep_graph=True`), from the driver's cuGraphGetNodes."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        _LIBCUDA = lib
    count = ctypes.c_size_t(0)
    rc = _LIBCUDA.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                  ctypes.byref(count))
    if rc != 0:
        raise RuntimeError("cuGraphGetNodes failed: CUresult %d" % rc)
    return count.value
