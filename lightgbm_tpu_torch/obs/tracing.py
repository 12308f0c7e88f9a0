# Copied from lightgbm_tpu/obs/tracing.py, but for the file write (the
# port's local atomic write), the build counts in the metadata (the card's
# kernel builds, obs/device.py, in place of XLA's compiles) and what only
# the JAX package's socket layer and training recorder read
# (set_metadata, set_clock_offset, current_context, kind_snapshot: ROADMAP
# items 12 and 14).
"""Span tracing: Chrome trace-event JSON of nested host spans.

The timeline half of the observability layer.  The registry answers "how
much, in total"; a timeline of nested spans answers "why was this request
slow": the queue wait, the coalesced batch, the device walk.  Spans come
from monotonic clocks and are written as Chrome trace-event JSON,
loadable in Perfetto / ``chrome://tracing``.

Design contract:

- ZERO-COST WHEN DISABLED: every public helper checks one attribute and
  returns a shared ``nullcontext`` — no allocation, no lock, no clock
  read.  Output is bitwise-identical with tracing on or off.
- THREAD-SAFE: spans nest per thread (thread-local stacks); the event
  buffer is lock-guarded because serving records from many HTTP worker
  threads at once.
- MONOTONIC: timestamps come from ``time.perf_counter_ns`` so NTP steps
  can't fold a span negative; the wall-clock epoch of ts=0 is stored in
  the file metadata.
- BOUNDED: the in-memory buffer caps at ``tpu_trace_max_events``;
  overflow increments a drop counter (reported in metadata) instead of
  growing without bound.

File format: ``{"traceEvents": [...], "metadata": {...}}`` — the JSON
object form of the Chrome trace-event spec.  Span durations also feed
``lgbm_trace_span_ms{kind=...}`` histograms in the default registry, so
/metrics carries p50/p99 per span kind without parsing the trace file.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from contextlib import nullcontext
from typing import Dict, List, Optional

from ..utils import log

SCHEMA_VERSION = 1

# bucket bounds for the per-kind span-duration histograms (ms): spans
# range from sub-ms host phases to multi-second compiles
_SPAN_MS_BOUNDS = (0.05, 0.2, 1.0, 5.0, 20.0, 100.0, 500.0, 2000.0, 10000.0)

_NULL_CM = nullcontext()


class _Span:
    """One live span: a reusable context manager pushed on the calling
    thread's stack at enter, turned into a complete ('X') event at exit."""

    __slots__ = ("tracer", "name", "cat", "args", "span_id", "parent_id",
                 "t0_us", "tid")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[Dict]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        tr = self.tracer
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else 0
        self.span_id = tr._next_span_id()
        self.tid = tr._tid()
        self.t0_us = tr._now_us()
        stack.append(self)
        return self

    def set(self, **kv) -> None:
        """Attach args discovered mid-span (e.g. batch size at dispatch)."""
        if self.args is None:
            self.args = {}
        self.args.update(kv)

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:            # mismatched exits: drop to self
            del stack[stack.index(self):]
        dur = tr._now_us() - self.t0_us
        args = dict(self.args) if self.args else {}
        args["span_id"] = self.span_id
        if self.parent_id:
            args["parent_id"] = self.parent_id
        if exc_type is not None:
            args["error"] = exc_type.__name__
        tr._emit({"name": self.name, "cat": self.cat or "span", "ph": "X",
                  "ts": self.t0_us, "dur": dur, "pid": tr.pid,
                  "tid": self.tid, "args": args})
        tr._observe_kind(self.cat or self.name, dur / 1e3)


class SpanTracer:
    """Process-wide span recorder; disabled (and free) until configured."""

    def __init__(self):
        self.enabled = False
        self.path: Optional[str] = None
        self.pid = 0                       # Chrome pid slot: the rank
        self.world = 1
        self.max_events = 500_000
        self.trace_id = ""                 # 32-hex run id, shared via comm
        self._events: List[Dict] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._span_seq = 0
        self._ts0_us = 0
        self._wall_epoch_us = 0
        self._tid_map: Dict[int, int] = {}
        self._thread_names: Dict[int, str] = {}
        self._hist_cache: Dict[str, object] = {}

    # -- configuration -------------------------------------------------- #
    def configure(self, path: str, rank: int = 0, world: int = 1,
                  max_events: int = 500_000) -> "SpanTracer":
        """Arm the tracer.  Reconfiguring with a new path starts a fresh
        buffer (one trace file per run); re-arming the same path mid-run
        is a no-op so serving + training in one process share the buffer."""
        resolved = "%s.rank%d" % (path, rank) if world > 1 else path
        with self._lock:
            if self.enabled and self.path == resolved:
                return self
            self._events = []
            self._dropped = 0
            self._span_seq = 0
            self._tid_map = {}
            self._thread_names = {}
            self.path = resolved
            self.pid = max(int(rank), 0)
            self.world = max(int(world), 1)
            self.max_events = max(int(max_events), 1024)
            self.trace_id = uuid.uuid4().hex
            now_ns = time.perf_counter_ns()
            self._ts0_us = now_ns // 1000
            self._wall_epoch_us = time.time_ns() // 1000 - (
                time.perf_counter_ns() // 1000 - self._ts0_us)
            self.enabled = True
        return self

    def disable(self) -> None:
        with self._lock:
            self.enabled = False

    # -- recording ------------------------------------------------------ #
    def span(self, name: str, cat: str = "",
             args: Optional[Dict] = None):
        if not self.enabled:
            return _NULL_CM
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        args["span_id"] = self._next_span_id()
        self._emit({"name": name, "cat": cat or "instant", "ph": "i",
                    "ts": self._now_us(), "pid": self.pid,
                    "tid": self._tid(), "s": "t", "args": args})

    def complete(self, name: str, dur_s: float, cat: str = "",
                 **args) -> None:
        """Record a span that ENDED now with a known duration (event +
        elapsed seconds)."""
        if not self.enabled:
            return
        end = self._now_us()
        dur = max(int(dur_s * 1e6), 0)
        args["span_id"] = self._next_span_id()
        self._emit({"name": name, "cat": cat or "span", "ph": "X",
                    "ts": end - dur, "dur": dur, "pid": self.pid,
                    "tid": self._tid(), "args": args})
        self._observe_kind(cat or name, dur / 1e3)

    # -- output --------------------------------------------------------- #
    def flush(self) -> Optional[str]:
        """Write the buffered trace to ``path`` (atomic rewrite; call as
        often as you like).  Returns the path written, or None."""
        if self.path is None:
            return None
        with self._lock:
            events = list(self._events)
            meta = {}
            thread_names = dict(self._thread_names)
            dropped = self._dropped
        for tid, tname in sorted(thread_names.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                           "tid": tid, "args": {"name": tname}})
        events.append({"name": "process_name", "ph": "M", "pid": self.pid,
                       "tid": 0, "args": {"name": "rank %d" % self.pid}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": self.pid, "tid": 0,
                       "args": {"sort_index": self.pid}})
        meta.update({
            "schema": SCHEMA_VERSION,
            "trace_id": self.trace_id,
            "rank": self.pid,
            "world": self.world,
            "wall_epoch_us": self._wall_epoch_us,
            "dropped_events": dropped,
        })
        try:
            from . import device
            meta["compile_counts"] = device.compile_counts()
        except Exception as exc:  # noqa: BLE001 — metadata only
            log.debug("compile counts unavailable: %s", exc)
        payload = {"traceEvents": events, "displayTimeUnit": "ms",
                   "metadata": meta}
        try:
            from ..models.gbdt import atomic_write_text
            atomic_write_text(self.path,
                              json.dumps(payload, separators=(",", ":")))
        except Exception as exc:  # noqa: BLE001 — tracing must not raise
            log.warning("trace: could not write %s: %s", self.path, exc)
            return None
        if dropped:
            log.warning("trace: %d events dropped (tpu_trace_max_events=%d)",
                        dropped, self.max_events)
        return self.path

    def close(self) -> Optional[str]:
        """Flush and disarm; subsequent spans are free no-ops again."""
        path = self.flush()
        with self._lock:
            self.enabled = False
        return path

    # -- internals ------------------------------------------------------ #
    def _now_us(self) -> int:
        return time.perf_counter_ns() // 1000 - self._ts0_us

    def _stack(self) -> List[_Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _next_span_id(self) -> int:
        with self._lock:
            self._span_seq += 1
            return self._span_seq

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tid_map.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tid_map.setdefault(ident, len(self._tid_map) + 1)
                self._thread_names[tid] = threading.current_thread().name
        return tid

    def _emit(self, event: Dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(event)

    def _observe_kind(self, kind: str, ms: float) -> None:
        hist = self._hist_cache.get(kind)
        if hist is None:
            try:
                from . import default_registry
                hist = default_registry().histogram(
                    "lgbm_trace_span_ms", bounds=_SPAN_MS_BOUNDS,
                    help="Recorded span durations (ms) per span kind",
                    kind=kind)
            except Exception:  # noqa: BLE001 — metrics must not kill a span
                return
            # benign last-wins race: the registry dedupes children by
            # label key, so concurrent builders store the same object
            self._hist_cache[kind] = hist  # tpulint: ok=lock-shared-write
        try:
            hist.observe(ms)
        except Exception as exc:  # noqa: BLE001
            log.debug("span histogram observe failed: %s", exc)


_tracer = SpanTracer()


def get_tracer() -> SpanTracer:
    """The process-wide tracer (disabled until configured)."""
    return _tracer


def configure_from_config(config) -> Optional[SpanTracer]:
    """Arm the process tracer from Config.tpu_trace_path; no-op (None)
    when the param is empty.  Call site: the serving Server's
    construction."""
    path = getattr(config, "tpu_trace_path", "")
    if not path:
        return None
    rank = max(int(getattr(config, "machine_rank", -1)), 0)
    world = max(int(getattr(config, "num_machines", 1)), 1)
    return _tracer.configure(
        path, rank=rank, world=world,
        max_events=int(getattr(config, "tpu_trace_max_events", 500_000)))


def span(name: str, cat: str = "", **args):
    """Open a nested span on the current thread; a shared null context
    when tracing is off (no allocation)."""
    t = _tracer
    return t.span(name, cat, args or None) if t.enabled else _NULL_CM


def instant(name: str, cat: str = "", **args) -> None:
    t = _tracer
    if t.enabled:
        t.instant(name, cat, **args)


def complete(name: str, dur_s: float, cat: str = "", **args) -> None:
    t = _tracer
    if t.enabled:
        t.complete(name, dur_s, cat, **args)


def flush() -> Optional[str]:
    return _tracer.flush() if _tracer.path else None
