# Copied from lightgbm_tpu/serving/admission.py; its code kept in step with it (docstrings
# and comments aside) by tests/test_torch_obs_serving.py.
"""Admission control for the serving predict path.

Four protections sit in front of the micro-batcher so overload and
device trouble degrade predictably instead of cascading:

- **Load shedding** (ShedError -> HTTP 429 + Retry-After): requests are
  refused at the door once the queue holds more than
  ``tpu_serve_shed_queue_rows`` rows.  Shedding fires BEFORE enqueue —
  a shed request costs one counter bump, the queue never grows
  unboundedly, and the client learns exactly when to come back.
- **Circuit breaker** around device execution: after
  ``tpu_serve_breaker_failures`` consecutive dispatch failures the
  breaker OPENS and batches ride the host walk (always available — it
  is plain NumPy) until ``tpu_serve_breaker_reset_s`` passes; then one
  HALF-OPEN probe decides whether the device path is healthy again.
- **Draining** (DrainingError -> HTTP 503): after SIGTERM the server
  stops admitting work, finishes every queued and in-flight request
  within ``tpu_serve_drain_timeout_s``, then exits — no request is
  abandoned mid-predict.
- **Per-tenant quotas** (``TenantQuota`` -> HTTP 429 + Retry-After):
  with ``tpu_fleet_tenant_qps`` set, each model name gets its own token
  bucket, so one noisy tenant sheds against its OWN quota instead of
  starving every other tenant's batcher — the multi-tenant counterpart
  of the global queue-depth shed.
"""
from __future__ import annotations

import threading
import time
from typing import Dict


class ShedError(Exception):
    """Load shed at admission — HTTP 429 with a Retry-After hint."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DrainingError(Exception):
    """The server is draining for shutdown — HTTP 503."""


class TenantQuota:
    """Per-tenant token-bucket admission quota.

    Each tenant (model name) refills at ``qps`` tokens/s up to a
    ``burst`` ceiling (default 2x qps, floor 1 — a tenant idle for a
    while may burst briefly, steady state is capped at qps).
    ``try_admit`` consumes one token and returns None, or returns the
    seconds until a token refills — the Retry-After hint for the 429.
    Sheds are counted per tenant so a quota-limited tenant is
    attributable in /metrics.  Thread-safe; clock injectable for tests.
    """

    def __init__(self, qps: float, burst: float = 0.0,
                 clock=time.monotonic):
        self.qps = max(float(qps), 1e-9)
        self.burst = float(burst) if burst > 0 else max(2.0 * self.qps, 1.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, list] = {}      # name -> [tokens, last_t]
        self._sheds: Dict[str, int] = {}

    def try_admit(self, tenant: str):
        """None = admitted (one token consumed); otherwise the seconds
        until the tenant's next token — shed with 429 + Retry-After."""
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = [self.burst, now]
            tokens, last = bucket
            tokens = min(self.burst, tokens + (now - last) * self.qps)
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                bucket[1] = now
                return None
            bucket[0] = tokens
            bucket[1] = now
            self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
            return (1.0 - tokens) / self.qps

    def shed_count(self, tenant: str) -> int:
        with self._lock:
            return self._sheds.get(tenant, 0)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"qps": self.qps, "burst": self.burst,
                    "sheds": dict(self._sheds)}


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half-open).

    ``allow()`` answers "may this dispatch use the guarded path?":
    CLOSED always, OPEN no until ``reset_s`` elapsed, then exactly ONE
    caller gets a HALF-OPEN probe; its ``record_success`` re-closes the
    breaker, its ``record_failure`` re-opens it for another full
    ``reset_s``.  Thread-safe; the clock is injectable for tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, reset_s: float = 30.0,
                 clock=time.monotonic):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_s = max(float(reset_s), 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.open_count = 0          # times the breaker tripped

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_out = True
                return True
            # HALF_OPEN: one probe at a time
            if self._probe_out:
                return False
            self._probe_out = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_out = False
            self._state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            self._probe_out = False
            if (self._state == self.HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                if self._state != self.OPEN:
                    self.open_count += 1
                self._state = self.OPEN
                self._opened_at = self._clock()

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "open_count": self.open_count}
