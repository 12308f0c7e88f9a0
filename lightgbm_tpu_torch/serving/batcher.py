# Copied from lightgbm_tpu/serving/batcher.py; its code kept in step with it (docstrings
# and comments aside) by tests/test_torch_obs_serving.py.
"""Adaptive micro-batching queue for the serving predict path.

Every device dispatch pays a fixed cost on the host (the copy of X into
pinned staging and over PCIe, KP1's launch, the fetch of the output) that
a one-row request cannot amortize.  The classic serving fix
(Clipper-style adaptive batching): concurrent requests are coalesced into
ONE batch per dispatch, padded to the power-of-two row buckets of
ops/predict.py that the registry warmed, so the fixed cost is shared by
every rider.

Policy knobs (Config serve_*):
- max_batch_rows: dispatch as soon as this many rows are waiting;
- max_wait_ms:    dispatch a partial batch once the OLDEST rider has
                  waited this long (latency deadline, not a fixed tick);
- max_queue_rows: bounded queue — submits beyond it raise QueueFullError
                  (the HTTP layer maps it to 429, or host-fallback);
- timeout_ms:     per-request deadline covering queue wait + predict;
                  expired riders are dropped before dispatch so one
                  slow dispatch can't cascade timeouts down the queue.

One worker thread per batcher (one batcher per served model name); the
predict function itself resolves the registry's CURRENT model version,
so hot-swaps never drain the queue.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..obs import tracing
from ..utils import log
from .admission import DrainingError
from .metrics import ModelStats


class QueueFullError(Exception):
    """Bounded queue overflow — backpressure; map to HTTP 429."""


class RequestTimeoutError(Exception):
    """The request missed its deadline (queue wait + predict)."""


class BatcherStoppedError(Exception):
    """Submit after stop() — the server is shutting down."""


class _Request:
    __slots__ = ("rows", "n", "enqueue_t", "deadline_t", "event", "result",
                 "error", "cancelled")

    def __init__(self, rows: np.ndarray, timeout_s: float):
        self.rows = rows
        self.n = rows.shape[0]
        self.enqueue_t = time.perf_counter()
        self.deadline_t = self.enqueue_t + timeout_s
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False


class MicroBatcher:
    """Coalesces concurrent predict requests into one dispatch.

    predict_fn: Callable[[np.ndarray], np.ndarray] taking the coalesced
    [rows, features] matrix and returning per-row outputs whose leading
    axis is rows (1-D scores or [rows, k] multiclass both work).
    """

    def __init__(self, predict_fn: Callable[[np.ndarray], np.ndarray],
                 *, max_batch_rows: int = 256, max_wait_ms: float = 2.0,
                 max_queue_rows: int = 4096, timeout_ms: float = 1000.0,
                 stats: Optional[ModelStats] = None, name: str = ""):
        self.predict_fn = predict_fn
        self.max_batch_rows = max(int(max_batch_rows), 1)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self.max_queue_rows = max(int(max_queue_rows), self.max_batch_rows)
        self.timeout_s = float(timeout_ms) / 1e3
        self.stats = stats or ModelStats()
        self.name = name
        self._queue: List[_Request] = []
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._stopped = False
        self._draining = False
        self._inflight = 0           # requests inside a dispatch right now
        self._worker = threading.Thread(
            target=self._run, name="lgbm-serve-batcher-%s" % (name or "?"),
            daemon=True)
        self._started = False

    # -- public API ---------------------------------------------------- #
    def start(self) -> "MicroBatcher":
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._worker.start()
        return self

    def stop(self, join: bool = True) -> None:
        with self._lock:
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            self._not_empty.notify_all()
        for req in pending:
            req.error = BatcherStoppedError("batcher %s stopped" % self.name)
            req.event.set()
        if join and self._started and self._worker.is_alive() \
                and threading.current_thread() is not self._worker:
            self._worker.join(timeout=5.0)

    def queue_depth_rows(self) -> int:
        with self._lock:
            return self._queued_rows

    # -- graceful drain ------------------------------------------------- #
    def begin_drain(self) -> None:
        """Stop admitting new work; queued and in-flight requests still
        complete.  Irreversible for this batcher instance."""
        with self._lock:
            self._draining = True
            self._not_empty.notify_all()

    def drained(self) -> bool:
        with self._lock:
            return (self._draining and not self._queue
                    and self._inflight == 0)

    def drain(self, timeout_s: float = 10.0) -> bool:
        """begin_drain() and wait until every admitted request finished
        (or the timeout passes).  Returns True when fully drained."""
        self.begin_drain()
        deadline = time.perf_counter() + max(float(timeout_s), 0.0)
        while not self.drained():
            if time.perf_counter() >= deadline:
                return False
            time.sleep(0.005)
        return True

    def submit(self, rows: np.ndarray,
               timeout_ms: Optional[float] = None) -> np.ndarray:
        """Blocking predict through the coalescing queue.

        Raises QueueFullError on backpressure, RequestTimeoutError when
        the deadline passes, BatcherStoppedError after stop().
        """
        if not self._started:
            self.start()
        timeout_s = (self.timeout_s if timeout_ms is None
                     else float(timeout_ms) / 1e3)
        req = _Request(rows, timeout_s)
        with tracing.span("serve/enqueue", "serve", rows=req.n,
                          model=self.name):
            with self._lock:
                if self._stopped:
                    raise BatcherStoppedError(
                        "batcher %s stopped" % self.name)
                if self._draining:
                    raise DrainingError(
                        "batcher %s is draining for shutdown" % self.name)
                if self._queued_rows + req.n > self.max_queue_rows:
                    self.stats.record_reject()
                    raise QueueFullError(
                        "queue full: %d rows waiting, +%d over the %d cap"
                        % (self._queued_rows, req.n, self.max_queue_rows))
                self._queue.append(req)
                self._queued_rows += req.n
                self.stats.set_queue_depth(self._queued_rows)
                self._not_empty.notify()
        if not req.event.wait(timeout_s):
            # mark cancelled so the worker skips it if still queued; a
            # dispatch already in flight just discards the result
            req.cancelled = True
            self.stats.record_timeout()
            raise RequestTimeoutError(
                "request (%d rows) missed its %.0f ms deadline"
                % (req.n, timeout_s * 1e3))
        if req.error is not None:
            raise req.error
        return req.result

    # -- worker -------------------------------------------------------- #
    def _take_batch(self) -> List[_Request]:
        """Block until requests are waiting, then coalesce until the
        batch is full or the oldest rider's max-wait deadline passes."""
        with self._lock:
            while not self._queue and not self._stopped:
                self._not_empty.wait()
            if self._stopped:
                return []
            dispatch_at = self._queue[0].enqueue_t + self.max_wait_s
            while True:
                waiting = sum(r.n for r in self._queue)
                now = time.perf_counter()
                if waiting >= self.max_batch_rows or now >= dispatch_at:
                    break
                if not self._not_empty.wait(timeout=dispatch_at - now):
                    break       # deadline hit with no new arrivals
                if self._stopped:
                    return []
            batch: List[_Request] = []
            taken = 0
            while self._queue:
                nxt = self._queue[0]
                if batch and taken + nxt.n > self.max_batch_rows:
                    break       # keep oversize requests whole, alone
                batch.append(self._queue.pop(0))
                taken += nxt.n
            self._queued_rows -= taken
            self._inflight += len(batch)
            self.stats.set_queue_depth(self._queued_rows)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stopped:
                    return
                continue
            try:
                self._dispatch(batch)
            finally:
                with self._lock:
                    self._inflight -= len(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.cancelled or now >= req.deadline_t:
                req.cancelled = True    # expired in queue: don't pay
                continue                # the dispatch for a dead rider
            live.append(req)
            self.stats.record_wait((now - req.enqueue_t) * 1e3)
        if not live:
            return
        try:
            X = (live[0].rows if len(live) == 1
                 else np.concatenate([r.rows for r in live], axis=0))
            with tracing.span("serve/micro_batch", "serve",
                              rows=X.shape[0], riders=len(live),
                              model=self.name):
                out = np.asarray(self.predict_fn(X))
            a = 0
            for req in live:
                req.result = out[a:a + req.n]
                a += req.n
                req.event.set()
        except BaseException as e:  # noqa: BLE001 — riders must wake
            log.warning("serving batch dispatch failed: %s", e)
            self.stats.record_error()
            for req in live:
                req.error = e
                req.event.set()
