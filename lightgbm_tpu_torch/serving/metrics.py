# Copied from lightgbm_tpu/serving/metrics.py; its code kept in step with it (docstrings
# and comments aside) by tests/test_torch_obs_serving.py.
"""Request-path observability: counters + histograms per served model.

The serving analogue of the phase timers (utils/profiling.py): every request, batch dispatch, rejection and
fallback increments lock-guarded accumulators, and /stats renders one
JSON snapshot — request counts, batch-size distribution, latency
percentiles, live queue depth — cheap enough to leave on in production
(two dict updates per request; no locks on the predict dispatch itself).

The Histogram implementation moved to the shared telemetry layer
(lightgbm_tpu/obs/registry.py) so training and serving report through
one type; it is re-exported here for API compatibility.  ModelStats
stays the serving-local accumulator; obs/adapters.publish_model_stats
exposes it through the MetricsRegistry for `GET /metrics`.
"""
from __future__ import annotations

import threading
from typing import Dict, Sequence

from ..obs.registry import Histogram  # noqa: F401 — shared impl, re-exported

# Latency buckets (ms): log-spaced from half a millisecond to seconds, so
# the histogram resolves both the coalesced fast path and a stall's tail.
DEFAULT_LATENCY_BOUNDS_MS = (
    0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)
# Batch-size buckets: power-of-two edges matching the batcher's row
# buckets, so the histogram reads as "which executables are hot".
DEFAULT_BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class ModelStats:
    """Per-model request-path accumulators; one per registry name."""

    def __init__(self,
                 latency_bounds_ms: Sequence[float] = DEFAULT_LATENCY_BOUNDS_MS,
                 batch_bounds: Sequence[float] = DEFAULT_BATCH_BOUNDS):
        self._lock = threading.Lock()
        self.requests = 0            # requests admitted
        self.rows = 0                # total rows predicted
        self.batches = 0             # coalesced dispatches
        self.device_batches = 0      # dispatches that rode the device path
        self.host_batches = 0        # dispatches on the host walk
        self.host_fallback = 0       # overload requests served host-side
        self.rejected_queue_full = 0  # 429-style rejections
        self.shed = 0                # admission-control sheds (429+Retry-After)
        self.breaker_batches = 0     # batches forced host-side (breaker open)
        self.timeouts = 0            # requests that missed their deadline
        self.errors = 0              # predict-path exceptions
        self.queue_depth = 0         # live gauge (rows waiting)
        self.latency_ms = Histogram(latency_bounds_ms)
        self.batch_size = Histogram(batch_bounds)
        self.wait_ms = Histogram(latency_bounds_ms)   # queue wait per rider

    def record_request(self, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += rows

    def record_batch(self, rows: int, device: bool) -> None:
        with self._lock:
            self.batches += 1
            if device:
                self.device_batches += 1
            else:
                self.host_batches += 1
            self.batch_size.observe(rows)

    def record_latency(self, ms: float) -> None:
        with self._lock:
            self.latency_ms.observe(ms)

    def record_wait(self, ms: float) -> None:
        with self._lock:
            self.wait_ms.observe(ms)

    def record_reject(self) -> None:
        with self._lock:
            self.rejected_queue_full += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_breaker_batch(self) -> None:
        with self._lock:
            self.breaker_batches += 1

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_fallback(self) -> None:
        with self._lock:
            self.host_fallback += 1

    def set_queue_depth(self, rows: int) -> None:
        with self._lock:
            self.queue_depth = rows

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "device_batches": self.device_batches,
                "host_batches": self.host_batches,
                "host_fallback": self.host_fallback,
                "rejected_queue_full": self.rejected_queue_full,
                "shed": self.shed,
                "breaker_batches": self.breaker_batches,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "queue_depth": self.queue_depth,
                "rows_per_batch": round(self.rows / self.batches, 3)
                if self.batches else None,
                "latency_ms": self.latency_ms.snapshot(),
                "batch_size": self.batch_size.snapshot(),
                "wait_ms": self.wait_ms.snapshot(),
            }
