# Copied from lightgbm_tpu/utils/profiling.py (Profiler); TraceSession,
# the jax.profiler wrapper, waits for ROADMAP item 14.
"""Per-phase timing — the TIMETAG analogue.

The reference accumulates per-phase std::chrono durations in the tree
learner and prints them at destruction (serial_tree_learner.cpp:15-42).
This module keeps host-side phase accumulators with an optional device
sync at phase exit, so a phase can mean device time and not launch time;
the serving request path reports its phases (model load and warmup, batch
predict, host fallback) through one shared Profiler.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from . import log
from ..obs import tracing


class Profiler:
    """Named wall-clock accumulators with optional device sync.

    sync_fn, when provided, is called at phase exit before the clock
    stops (a scalar device fetch), so asynchronously dispatched work is
    charged to the phase that launched it.  Without it, phases measure
    dispatch time only — still useful for host-overhead attribution.

    Accumulation is lock-guarded: the serving request path updates one
    shared Profiler from many HTTP worker threads.
    """

    def __init__(self, enabled: bool = False, sync_fn=None):
        self.enabled = enabled
        self.sync_fn = sync_fn
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.mins: Dict[str, float] = {}
        self.maxs: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str):
        # every phase site doubles as a span site: the tracer records a
        # nested span for this phase even when the accumulators are off,
        # so tpu_trace_path alone yields a full timeline.  The span
        # closes AFTER sync_fn, so it covers device time like the clock.
        tracer = tracing.get_tracer()
        span = tracer.span(name, "phase") if tracer.enabled else None
        if not self.enabled and span is None:
            yield
            return
        if span is not None:
            span.__enter__()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_fn is not None:
                try:
                    self.sync_fn()
                except Exception as exc:  # noqa: BLE001 — must not kill train
                    log.debug("profiler sync failed: %s", exc)
            if span is not None:
                try:
                    span.__exit__(None, None, None)
                except Exception as exc:  # noqa: BLE001
                    log.debug("profiler span exit failed: %s", exc)
            dt = time.perf_counter() - start
            if not self.enabled:
                return
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
                if dt < self.mins.get(name, float("inf")):
                    self.mins[name] = dt
                if dt > self.maxs.get(name, float("-inf")):
                    self.maxs[name] = dt

    def reset(self) -> None:
        """Zero every accumulator and restart the wall clock — serving
        /stats and long-running boosters can re-baseline instead of
        accumulating unboundedly stale totals."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.mins.clear()
            self.maxs.clear()
            self._t0 = time.perf_counter()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Machine-readable view of the accumulators (the /stats wire
        format of the serving subsystem): {phase: {total_s, calls,
        ms_per_call, min_ms, max_ms}}."""
        with self._lock:
            return {
                name: {
                    "total_s": round(total, 6),
                    "calls": self.counts[name],
                    "ms_per_call": round(
                        1e3 * total / max(self.counts[name], 1), 3),
                    "min_ms": round(1e3 * self.mins[name], 3),
                    "max_ms": round(1e3 * self.maxs[name], 3),
                }
                for name, total in self.totals.items()
            }

    def report(self, header: str = "profile") -> Optional[str]:
        if not self.enabled or not self.totals:
            return None
        wall = time.perf_counter() - self._t0
        tracked = sum(self.totals.values())
        lines = ["[%s] wall %.3fs, tracked %.3fs" % (header, wall, tracked)]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append("  %-24s %8.3fs  (%6d calls, %7.2f ms/call)"
                         % (name, total, c, 1e3 * total / max(c, 1)))
        text = "\n".join(lines)
        log.info(text)
        return text
