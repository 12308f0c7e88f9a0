# Copied from lightgbm_tpu/serving/shadow.py; its code kept in step with it (docstrings
# and comments aside) by tests/test_torch_obs_serving.py.
"""Shadow-mode traffic mirror for candidate models.

A `ShadowMirror` sits beside one served model: every batch the server
predicts is *offered* to the mirror AFTER the live output is final, and
a daemon worker replays it on the CANDIDATE booster to accumulate
paired-prediction divergence stats.  Three properties make it safe to
attach to production traffic:

- the serving thread only copies the batch and enqueues it — the live
  output array is never handed to the worker, so the served response is
  bitwise what it would be with no mirror attached;
- the queue is bounded and `observe` drops (with a counter) when the
  candidate can't keep up — shadow scoring sheds, serving never does;
- the worker predicts on the HOST walk, so the candidate never takes
  device memory or a launch from the served models.

The quality verdict itself (held-out metric window) lives in
`resilience/supervisor.py`; the mirror answers the cheaper streaming
question "how far apart are live and candidate on real traffic".
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from ..obs import default_registry
from ..utils import log


class ShadowMirror:
    """Paired live-vs-candidate predictions on mirrored traffic."""

    def __init__(self, name: str, booster, max_queue_batches: int = 64):
        self.name = name
        self.booster = booster
        # materialize any deferred trees NOW, on this thread: after this
        # the worker's predicts are pure reads, safe to run concurrently
        # with whoever else holds the candidate (supervisor, registry)
        booster._gbdt._sync_model()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, max_queue_batches))
        self._lock = threading.Lock()
        self._count = 0            # rows scored
        self._sum_abs = 0.0
        self._max_abs = 0.0
        self._dropped = 0          # rows shed off the full queue
        self._errors = 0
        self._offered = 0          # batches enqueued
        self._done = 0             # batches fully processed
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="shadow-%s" % name, daemon=True)
        self._thread.start()

    # -- serving side --------------------------------------------------- #
    def observe(self, X: np.ndarray, live_out: np.ndarray) -> None:
        """Offer one served batch to the mirror.  Non-blocking, never
        raises, never mutates or retains the caller's arrays."""
        if self._stopped.is_set():
            return
        try:
            self._q.put_nowait((np.array(X, copy=True),
                                np.array(live_out, copy=True)))
            with self._lock:
                self._offered += 1
        except queue.Full:
            with self._lock:
                self._dropped += int(X.shape[0])
            default_registry().counter(
                "lgbm_shadow_dropped_total",
                help="Mirrored rows shed because the shadow queue was full",
                model=self.name).inc(int(X.shape[0]))

    # -- worker side ---------------------------------------------------- #
    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stopped.is_set():
                    return
                continue
            if item is None:
                return
            X, live = item
            try:
                cand = self.booster._gbdt.predict(X, device=False)
                delta = np.abs(np.asarray(cand, np.float64).reshape(-1)
                               - np.asarray(live, np.float64).reshape(-1))
                with self._lock:
                    self._count += int(X.shape[0])
                    self._sum_abs += float(delta.sum())
                    self._max_abs = max(self._max_abs, float(delta.max()))
            except Exception as exc:   # noqa: BLE001 — shadow never escapes
                with self._lock:
                    self._errors += 1
                log.debug("shadow %s: scoring batch failed: %s",
                          self.name, exc)
            finally:
                with self._lock:
                    self._done += 1

    # -- lifecycle / stats ---------------------------------------------- #
    def snapshot(self) -> Dict:
        with self._lock:
            mean = self._sum_abs / self._count if self._count else 0.0
            return {
                "model": self.name,
                "rows": self._count,
                "mean_abs_delta": mean,
                "max_abs_delta": self._max_abs,
                "dropped_rows": self._dropped,
                "errors": self._errors,
                "pending_batches": self._q.qsize(),
            }

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Best-effort wait until every offered batch is PROCESSED (not
        merely dequeued) — tests and the supervisor's shadow verdict
        read snapshot() right after this."""
        import time
        deadline = time.monotonic() + timeout_s

        def _settled() -> bool:
            with self._lock:
                return self._done >= self._offered
        while time.monotonic() < deadline:
            if _settled():
                return True
            time.sleep(0.01)
        return _settled()

    def stop(self, timeout_s: Optional[float] = 5.0) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=timeout_s)
