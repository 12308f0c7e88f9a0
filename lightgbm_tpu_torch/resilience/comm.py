# Copied from lightgbm_tpu/resilience/comm.py (CommFailure, RetryPolicy,
# FaultInjector); Heartbeat and WorldChangedError wait for ROADMAP items
# 12 and 14.
"""Robustness primitives: retry policy, fault injection, a typed abort.

- ``RetryPolicy``    exponential backoff + jitter with a bounded budget;
                     the serving fleet's promotions retry with it
- ``FaultInjector``  deterministic chaos hook (fail/delay/drop/partition/
                     kill), used by tests and the fleet's fault drills
- ``CommFailure``    typed abort naming the dead peer rank
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils import log


class CommFailure(ConnectionError):
    """A comm operation exhausted its retry budget against one peer.

    Carries enough to act on: ``rank`` (the peer observed dead), ``op``
    (send/recv/allgather), ``attempts`` and the last underlying error.
    """

    def __init__(self, op: str, rank: int, attempts: int,
                 cause: Optional[BaseException] = None):
        self.op = op
        self.rank = int(rank)
        self.attempts = int(attempts)
        self.cause = cause
        super().__init__(
            "comm %s failed against rank %d after %d attempt(s): %s"
            % (op, rank, attempts, cause))


class RetryPolicy:
    """Bounded exponential backoff with jitter.

    ``retries`` is the number of RE-tries after the first attempt, so a
    policy with retries=4 makes at most 5 attempts.  Delay for attempt
    ``n`` (1-based) is ``base_ms * 2**(n-1)`` capped at ``max_ms``, then
    scaled by a uniform jitter in [0.5, 1.0] so a whole fleet retrying
    the same dead hub does not thundering-herd in lockstep.  Jitter
    affects timing only — never training output — so the seeded RNG here
    has no bearing on model determinism.
    """

    def __init__(self, retries: int = 4, base_ms: float = 50.0,
                 max_ms: float = 2000.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        self.retries = max(int(retries), 0)
        self.base_ms = max(float(base_ms), 0.0)
        self.max_ms = max(float(max_ms), self.base_ms)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self._rng = random.Random(seed)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry `attempt` (1-based), in seconds."""
        raw = min(self.base_ms * (2.0 ** max(attempt - 1, 0)), self.max_ms)
        scale = 1.0 - self.jitter * self._rng.random()
        return raw * scale / 1e3

    @classmethod
    def from_config(cls, config) -> "RetryPolicy":
        return cls(retries=getattr(config, "tpu_comm_retries", 4),
                   base_ms=getattr(config, "tpu_comm_backoff_ms", 50.0),
                   max_ms=getattr(config, "tpu_comm_backoff_max_ms", 2000.0))


class FaultInjector:
    """Deterministic chaos hook for the comm layer, used by tests and
    tools/chaos_run.py.

    Armed per (operation name); ``check(op)`` is called by SocketComm
    immediately before the real wire operation and either raises (fail),
    sleeps (delay), tells the caller to silently lose the frame (drop),
    or terminates the process outright (kill — SIGKILL, so no cleanup
    handler can soften the failure the survivors must ride out).
    ``count=-1`` arms a fault forever: ``partition`` is sugar for an
    infinite drop, the network-partition model where every frame to/from
    this rank vanishes but the process stays up.  Unarmed operations
    cost one dict lookup.

        inj = FaultInjector()
        inj.fail("allgather", count=2)        # next 2 allgathers raise
        inj.delay("send", count=1, seconds=0.2)
        inj.drop("send", count=1)             # frame silently lost
        inj.partition("send")                 # every frame lost, forever
        inj.kill("allgather", after=3)        # 4th allgather: SIGKILL
        comm = SocketComm(..., injector=inj)
    """

    OK, DROP = "ok", "drop"

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: Dict[str, List[dict]] = {}
        self.injected = 0

    def fail(self, op: str, count: int = 1,
             exc_factory: Optional[Callable[[], BaseException]] = None) -> None:
        self._arm(op, {"kind": "fail", "count": int(count),
                       "exc": exc_factory})

    def delay(self, op: str, count: int = 1, seconds: float = 0.05) -> None:
        self._arm(op, {"kind": "delay", "count": int(count),
                       "seconds": float(seconds)})

    def drop(self, op: str, count: int = 1) -> None:
        self._arm(op, {"kind": "drop", "count": int(count)})

    def partition(self, op: str) -> None:
        """Permanent silent frame loss on `op` — the process stays alive
        but is unreachable through this operation (network partition)."""
        self._arm(op, {"kind": "drop", "count": -1})

    def kill(self, op: str, after: int = 0) -> None:
        """SIGKILL this process on the (after+1)-th `op`.  The real
        rank-death fault: no exception propagates, no socket is closed
        gracefully — peers see RST/EOF, exactly like an OOM-kill or a
        preempted VM."""
        if after > 0:
            self._arm(op, {"kind": "noop", "count": int(after)})
        self._arm(op, {"kind": "kill", "count": 1})

    def reset(self) -> None:
        with self._lock:
            self._faults.clear()

    def armed(self, op: Optional[str] = None) -> bool:
        with self._lock:
            if op is None:
                return any(self._faults.values())
            return bool(self._faults.get(op))

    def _arm(self, op: str, fault: dict) -> None:
        with self._lock:
            self._faults.setdefault(op, []).append(fault)

    def check(self, op: str) -> str:
        """Consume one armed fault for `op`.  Returns OK or DROP; raises
        for fail faults (a ConnectionError by default, so the retry loop
        treats it exactly like a real transient wire error).  A count of
        -1 never depletes (partition)."""
        with self._lock:
            queue = self._faults.get(op)
            if not queue:
                return self.OK
            fault = queue[0]
            if fault["count"] > 0:
                fault["count"] -= 1
                if fault["count"] <= 0:
                    queue.pop(0)
            self.injected += 1
        kind = fault["kind"]
        if kind == "noop":
            return self.OK
        if kind == "delay":
            time.sleep(fault["seconds"])
            return self.OK
        if kind == "drop":
            return self.DROP
        if kind == "kill":
            log.warning("fault injector: SIGKILL on %s", op)
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)  # unreachable; keep the op blocked while dying
        exc_factory = fault.get("exc")
        raise (exc_factory() if exc_factory is not None
               else ConnectionError("injected fault: %s" % op))
