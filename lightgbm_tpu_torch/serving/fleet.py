# Copied from lightgbm_tpu/serving/fleet.py, but for the docstrings, what
# waits for later items of ROADMAP.md (the per-device replica ledger for
# the replica sets, item 13b; pre_spill and the policy lever, item 14,
# control: tpu_policy raises NotImplementedError) and a kernel that fails
# to build or launch, which the tenant's requests raise from then on,
# never hidden behind the host walk.
"""Device-memory residency manager for multi-tenant model fleets.

Production GBDT serving is a per-segment/per-region *fleet*: thousands
of small boosters, a handful hot at any instant.  Keeping every loaded
ensemble device-resident forever means the Nth tenant does not degrade
capacity — it runs the card out of memory and takes every tenant down.
This module turns the card's memory into an explicitly byte-accounted,
LRU-managed cache over the registry's models (the names keep the JAX
package's "HBM"):

- **Residency states**: each tenant is RESIDENT (walk tables on the card,
  its buckets warm), SPILLED (host tier only: the booster's trees plus a
  hashed model-text snapshot; device tables dropped) or PROMOTING (a
  build is in flight).  A request hitting a SPILLED tenant is served
  IMMEDIATELY via the host tree-walk while an asynchronous promotion
  runs — cold tenants cost latency, never availability.
- **Byte budget before allocation**: ``tpu_fleet_hbm_budget_mb`` with
  high/low watermarks.  Ensembles are sized from
  ``ops.predict.estimate_device_bytes`` (exact: equal to the built
  tables' ``device_bytes()``) and LRU tenants are spilled BEFORE the new
  tables are built, so pressure resolves by eviction, not by an
  allocator OOM.  The accounting invariant — resident + reserved bytes
  never exceed the budget — holds at every instant;
  ``peak_resident_bytes`` records the high-water mark so drills can
  assert it.
- **Shape-bucketed warmup cache**: warmups are keyed on the ensemble's
  shape signature (its table sizes and features) plus the row bucket.
  KP1 takes any shape and its kernels build once per process, so a warm
  (signature, bucket) is one that has had its warmup launch; a second
  tenant of the same signature skips that launch.
- **Faults**: ``FleetFaultInjector`` arms promotion failure, slow
  device and spill-read corruption (manifest sha256 mismatch).
  Promotions retry with the resilience ``RetryPolicy``'s exponential
  backoff; an exhausted budget DEGRADES the tenant to the host walk —
  counted (``promote_failures``), never raised to clients — and the
  tenant re-arms after a cool-down.  A kernel that fails to build or to
  launch (``ops._cuda.KernelError``) is no transient fault: it is not
  retried, the synchronous load raises it, and from then on every
  checkout of the tenant raises it too, so no request rides the host walk
  over a broken kernel (the port has no fallback that hides one) until
  the tenant is loaded or rolled back anew.  A corrupt spill
  snapshot is detected before use and healed from the authoritative
  in-memory trees.

Lock discipline: the manager lock guards only dict/counter state; every
expensive operation — table build, bucket warmup, model-text snapshot,
backoff sleep — runs OUTSIDE the lock with a generation re-check at
commit time, the same pattern the registry's load() uses.
"""
from __future__ import annotations

import hashlib
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import default_registry
from ..obs import tracing as obs_tracing
from ..obs.recorder import fleet_event
from ..ops import predict as predict_ops
from ..ops._cuda import KernelError
from ..resilience.comm import FaultInjector, RetryPolicy
from ..utils import log

RESIDENT, SPILLED, PROMOTING = "resident", "spilled", "promoting"


class FleetFaultInjector(FaultInjector):
    """Deterministic chaos hooks for the residency manager, extending
    the comm-layer verbs (fail/delay/drop/partition/kill) with spilled-
    tier corruption:

        inj = FleetFaultInjector()
        inj.fail("promote", count=2)      # next 2 promotions raise
        inj.delay("promote", seconds=0.2) # slow device: build stalls
        inj.corrupt("spill_read")         # next spill read: bad sha256
        fleet = HbmResidencyManager(..., injector=inj)

    ``corrupt`` faults are consumed by :meth:`corrupt_check` (NOT by the
    base ``check``, which treats unknown kinds as failures): the spilled
    model text comes back mutated, so the manifest hash recorded at
    spill time no longer matches and the manager must detect and heal.
    """

    CORRUPT = "corrupt"

    def corrupt(self, op: str = "spill_read", count: int = 1) -> None:
        self._arm(op, {"kind": self.CORRUPT, "count": int(count)})

    def corrupt_check(self, op: str, payload: str) -> str:
        """Consume one armed corrupt fault for `op`: returns `payload`
        with its first byte flipped (any hash-breaking mutation would
        do), or unchanged when no corrupt fault is armed."""
        with self._lock:
            q = self._faults.get(op)
            if not q or q[0]["kind"] != self.CORRUPT:
                return payload
            fault = q[0]
            if fault["count"] > 0:
                fault["count"] -= 1
                if fault["count"] <= 0:
                    q.pop(0)
            self.injected += 1
        if not payload:
            return "\x00"
        flipped = chr(ord(payload[0]) ^ 0x01)
        return flipped + payload[1:]


class ShapeBucketCache:
    """Fleet-wide (shape signature, row bucket) warmup cache.

    KP1 takes any shape and builds once per process, so a (signature,
    bucket) is warm once one tenant has had its warmup launch there.
    Promotion consults this cache per (signature, bucket) and skips the
    warmups a sibling of the same signature already ran, so a 64-tenant
    fleet of same-shape models pays each bucket's first launch once, not
    64 times.  Signatures come from ``DeviceEnsemble.shape_signature``;
    a skipped warmup can never change results (every launch computes
    from its own tables), and unequal signatures never collide.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._warm: set = set()
        self.hits = 0
        self.misses = 0

    def check(self, signature: tuple, bucket: int) -> bool:
        """True when this (signature, bucket) is already warm fleet-wide
        (counted as a hit); False counts a miss — the caller warms it,
        then calls :meth:`mark`."""
        key = (tuple(signature), int(bucket))
        with self._lock:
            if key in self._warm:
                self.hits += 1
                return True
            self.misses += 1
            return False

    def mark(self, signature: tuple, bucket: int) -> None:
        with self._lock:
            self._warm.add((tuple(signature), int(bucket)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._warm)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"entries": len(self._warm), "hits": self.hits,
                    "misses": self.misses}


class _Record:
    """Per-tenant residency record; every field is guarded by the
    manager lock.  ``gen`` increments on each admit so an in-flight
    promotion for a superseded entry can detect the race at commit time
    and discard its work instead of installing a torn mix."""

    __slots__ = ("name", "entry", "state", "ens", "bytes", "est",
                 "last_access", "spill_text", "spill_sha", "host_only",
                 "degraded", "queued", "retry_at", "gen",
                 "promote_failures", "kernel_error")

    def __init__(self, name: str, entry):
        self.name = name
        self.entry = entry
        self.state = SPILLED
        self.ens = None               # DeviceEnsemble while RESIDENT
        self.bytes = 0                # accounted device bytes while RESIDENT
        self.est = 0                  # layout-exact build estimate
        self.last_access = 0.0
        self.spill_text = None        # host-tier model snapshot + manifest
        self.spill_sha = None
        self.host_only = False        # over the budget
        self.degraded = False         # promotion budget exhausted
        self.queued = False           # promotion enqueued/in flight
        self.retry_at = 0.0           # degraded cool-down deadline
        self.gen = 0
        self.promote_failures = 0
        self.kernel_error = None      # KernelError of the last promotion


class HbmResidencyManager:
    """Byte-accounted LRU residency over the serving registry's models.

    The registry calls :meth:`admit` at load/rollback time and
    :meth:`release` at evict time; the per-batch hot path calls
    :meth:`checkout`, which returns the tenant's live DeviceEnsemble
    (touching LRU recency) or None — in which case the caller rides the
    host walk and an asynchronous promotion has been scheduled.  A
    checkout that raced with an eviction still finishes on the buffers
    it was handed (plain references keep them alive, the same in-flight
    semantics hot-swap has); the accounting drops the bytes at evict
    time, so actual usage can only exceed the accounting transiently,
    never the other way around.
    """

    def __init__(self, budget_bytes: int, high_watermark: float = 0.9,
                 low_watermark: float = 0.7,
                 warmup_buckets: Optional[List[int]] = None,
                 retry: Optional[RetryPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 compile_cache: Optional[ShapeBucketCache] = None,
                 config=None, degrade_cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.budget_bytes = max(int(budget_bytes), 0)
        self.high_watermark = min(max(float(high_watermark), 1e-6), 1.0)
        self.low_watermark = min(max(float(low_watermark), 1e-6),
                                 self.high_watermark)
        self.warmup_buckets = list(warmup_buckets or [])
        self.retry = retry or RetryPolicy()
        self.injector = injector
        # explicit None test: an EMPTY cache is falsy (__len__ == 0) and
        # `or` would silently drop a caller-shared instance
        self.compile_cache = (ShapeBucketCache() if compile_cache is None
                              else compile_cache)
        self.config = config
        self.degrade_cooldown_s = max(float(degrade_cooldown_s), 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._records: Dict[str, _Record] = {}
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stopped = False
        # counters (ints, bumped under the lock; scraped lock-free)
        self.resident_bytes = 0       # includes in-flight reservations
        self.peak_resident_bytes = 0
        self.promotions = 0
        self.promote_retries = 0
        self.promote_failures = 0
        self.evictions = 0
        self.spill_corruptions = 0
        self.device_hits = 0
        self.host_serves = 0
        self._check_policy()

    @classmethod
    def from_config(cls, config, **kwargs) -> "HbmResidencyManager":
        buckets = (list(config.serve_warmup_buckets)
                   if config.serve_warmup_buckets
                   else predict_ops.pow2_buckets(config.serve_max_batch_rows))
        return cls(
            budget_bytes=int(config.tpu_fleet_hbm_budget_mb * (1 << 20)),
            high_watermark=config.tpu_fleet_high_watermark,
            low_watermark=config.tpu_fleet_low_watermark,
            warmup_buckets=buckets,
            retry=RetryPolicy(
                retries=config.tpu_fleet_promote_retries,
                base_ms=config.tpu_fleet_promote_backoff_ms),
            config=config, **kwargs)

    # -- hot path ------------------------------------------------------ #
    def checkout(self, name: str, entry) -> Optional[object]:
        """The per-batch residency decision: the tenant's DeviceEnsemble
        when RESIDENT (LRU recency touched), else None — the caller
        serves on the host walk and, for a SPILLED tenant, promotion has
        been scheduled.  Raises the KernelError of the tenant's last
        promotion, if a kernel failed to build or launch there.  Never
        blocks on a build."""
        promote = False
        with self._lock:
            rec = self._records.get(name)
            if rec is None or rec.entry is not entry:
                # mid-swap stale entry: the host walk is always safe
                return None
            if rec.kernel_error is not None:
                raise KernelError("%s: %s" % (name, rec.kernel_error))
            rec.last_access = self._clock()
            if rec.state == RESIDENT:
                self.device_hits += 1
                return rec.ens
            self.host_serves += 1
            if (rec.state == SPILLED and not rec.host_only
                    and not rec.queued
                    and self._clock() >= rec.retry_at):
                rec.queued = True
                promote = True
        if promote:
            self._enqueue(name)
        return None

    # -- lifecycle ----------------------------------------------------- #
    def admit(self, entry, promote: bool = True) -> bool:
        """Register `entry` as the current model for its name.  With
        ``promote=True`` (the load path) the ensemble is built and
        warmed synchronously — evicting LRU tenants first, exactly like
        any promotion; with ``promote=False`` (the rollback path) the
        entry is installed host-serving and promotion runs
        asynchronously, so the install itself stays O(dict assignment).
        Returns True when the entry ended up device-RESIDENT."""
        name = entry.name
        g = entry.booster._gbdt
        est = predict_ops.estimate_device_bytes(
            g.models, g.num_tree_per_iteration)
        demoted = None
        with obs_tracing.span("serving/fleet_admit", "fleet", model=name,
                              est_bytes=est):
            with self._lock:
                rec = self._records.get(name)
                if rec is None:
                    rec = _Record(name, entry)
                    self._records[name] = rec
                else:
                    if rec.entry is not entry:
                        if (getattr(rec.entry, "version", 0)
                                >= getattr(entry, "version", 0)):
                            # a newer load admitted past this one while it
                            # was off-lock (registry stale-load race): the
                            # freshest version keeps the record
                            return rec.state == RESIDENT
                        demoted = (rec.entry, rec.state == RESIDENT)
                    if rec.state == RESIDENT:
                        # the replaced entry's bytes leave the budget NOW;
                        # in-flight batches on the old buffers finish on
                        # plain references (hot-swap semantics)
                        self.resident_bytes -= rec.bytes
                        self.evictions += 1
                    rec.entry = entry
                    rec.ens = None
                    rec.bytes = 0
                    rec.spill_text = None
                    rec.spill_sha = None
                    rec.gen += 1
                rec.state = SPILLED
                rec.est = est
                # every ensemble builds (ops/predict.ensemble_layout), so a
                # tenant is host-only only when it outgrows the budget
                rec.host_only = 0 < self.budget_bytes < est
                rec.degraded = False
                rec.kernel_error = None
                rec.retry_at = 0.0
                rec.last_access = self._clock()
                host_only = rec.host_only
                rec.queued = not host_only
        if demoted is not None:
            # drop the demoted entry's device buffers: the prior tier is
            # host-RAM, and rollback() transparently re-promotes
            self._drop_device_state(demoted[0])
            self._event("demote", model=name, was_resident=demoted[1])
        if host_only:
            log.warning("fleet: %s needs %d bytes but the budget is %d; "
                        "serving host-only", name, est, self.budget_bytes)
            self._event("oversize", model=name, est_bytes=est,
                        budget_bytes=self.budget_bytes)
        self._event("admit", model=name, est_bytes=est,
                    host_only=host_only)
        if host_only:
            return False
        if promote:
            return self._promote_with_retry(name)
        self._enqueue(name)
        return False

    def release(self, name: str) -> None:
        """Forget a tenant (registry eviction): its accounted bytes
        leave the budget and its record is dropped."""
        with self._lock:
            rec = self._records.pop(name, None)
            if rec is None:
                return
            if rec.state == RESIDENT:
                self.resident_bytes -= rec.bytes
            rec.gen += 1          # in-flight promotions discard at commit
            entry = rec.entry
        self._drop_device_state(entry)
        self._event("release", model=name)

    def stop(self) -> None:
        """Stop the promotion worker (idempotent)."""
        with self._lock:
            self._stopped = True
            worker, self._worker = self._worker, None
        self._queue.put(None)
        if worker is not None:
            worker.join(timeout=5.0)

    # -- control-plane levers ------------------------------------------- #
    def _check_policy(self) -> None:
        """The residency levers of the policy engine (``tpu_policy``:
        fleet_pre_spill) wait for the port's control plane."""
        if bool(getattr(self.config, "tpu_policy", False)):
            raise NotImplementedError(
                "tpu_policy: the fleet_pre_spill lever needs the control "
                "plane, ROADMAP item 14 (control) of the port")

    # -- promotion ------------------------------------------------------ #
    def _enqueue(self, name: str) -> None:
        with self._lock:
            if self._stopped:
                return
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, name="lgbm-fleet-promoter",
                    daemon=True)
                self._worker.start()
        self._queue.put(name)

    def _worker_loop(self) -> None:
        while True:
            name = self._queue.get()
            if name is None:
                return
            try:
                self._promote_with_retry(name)
            except KernelError as exc:
                # recorded on the tenant: its next checkout raises it
                log.warning("fleet: promotion of %s: %s", name, exc)
            except Exception as exc:  # noqa: BLE001 — worker never dies
                log.warning("fleet: promotion worker error for %s: %s",
                            name, exc)

    def _promote_with_retry(self, name: str) -> bool:
        """Promote with the RetryPolicy's exponential backoff.  An
        exhausted budget DEGRADES the tenant: it keeps serving on the
        host walk (counted, nothing raised to clients) and re-arms for
        promotion after a cool-down."""
        attempts = self.retry.retries + 1
        for attempt in range(1, attempts + 1):
            try:
                self._promote_once(name)
                return True
            except KernelError as exc:
                # a kernel that does not build or launch is no transient
                # fault: counted and degraded, not retried, then raised
                # (_promote_once recorded it on the tenant)
                self._degrade(name, exc)
                raise
            except Exception as exc:  # noqa: BLE001 — degrade, never raise
                if attempt >= attempts:
                    self._degrade(name, exc)
                    return False
                with self._lock:
                    self.promote_retries += 1
                delay = self.retry.backoff_s(attempt)
                log.warning("fleet: promotion of %s failed (%s); retry "
                            "%d/%d in %.0f ms", name, exc, attempt,
                            attempts - 1, delay * 1e3)
                time.sleep(delay)
        return False

    def _degrade(self, name: str, exc: BaseException) -> None:
        with self._lock:
            self.promote_failures += 1
            rec = self._records.get(name)
            # a racing admit may have promoted a NEWER entry under this
            # name; never demote a resident record from a stale failure
            if rec is not None and rec.state != RESIDENT:
                rec.state = SPILLED
                rec.degraded = True
                rec.queued = False
                rec.promote_failures += 1
                rec.retry_at = self._clock() + self.degrade_cooldown_s
        log.warning("fleet: promotion of %s exhausted %d attempt(s) (%s); "
                    "tenant degraded to the host walk for %.1fs", name,
                    self.retry.retries + 1, exc, self.degrade_cooldown_s)
        self._event("degrade", model=name, error=str(exc))

    def _promote_once(self, name: str) -> None:
        """One promotion attempt: reserve bytes (evicting LRU tenants
        first), build + warm OUTSIDE the lock, commit under a generation
        re-check.  Raises on injected/real faults — the caller retries."""
        with obs_tracing.span("serving/fleet_promote", "fleet", model=name):
            with self._lock:
                rec = self._records.get(name)
                if rec is None or rec.host_only or rec.state == RESIDENT:
                    if rec is not None:
                        rec.queued = False
                    return
                entry, est, gen0 = rec.entry, rec.est, rec.gen
                spill_text, spill_sha = rec.spill_text, rec.spill_sha
                fits, victims = self._make_room_locked(est, exclude=name)
                if not fits:
                    rec.queued = False
                else:
                    rec.state = PROMOTING
                    self.resident_bytes += est     # reservation
                    self._touch_peak_locked()
            if not fits:
                # victims (if any) are already marked SPILLED — finish
                # their spill so no device bytes outlive the accounting
                self._finish_spills(victims)
                raise RuntimeError(
                    "fleet: no room for %s (%d bytes; %d of %d in use)"
                    % (name, est, self.resident_bytes, self.budget_bytes))
            try:
                self._finish_spills(victims)
                if self.injector is not None:
                    # promotion failure / slow device, armed by chaos
                    self.injector.check("promote")
                if spill_text is not None:
                    self._verify_spill(name, spill_text, spill_sha)
                g = entry.booster._gbdt
                ens = g._device_ensemble()
                warmed = self._warm(entry, ens)
            except BaseException as exc:
                with self._lock:
                    self.resident_bytes -= est   # release the reservation
                    if self._records.get(name) is rec and rec.gen == gen0:
                        rec.state = SPILLED
                        if isinstance(exc, KernelError):
                            # every later checkout raises it: no request
                            # rides the host walk over a broken kernel
                            rec.kernel_error = exc
                raise
            committed = stale = False
            with self._lock:
                self.resident_bytes -= est       # reservation ->
                rec2 = self._records.get(name)
                stale = (rec2 is not rec or rec.gen != gen0
                         or self._stopped)
                if not stale:
                    actual = ens.device_bytes()
                    rec.ens = ens
                    rec.bytes = actual
                    self.resident_bytes += actual   # -> actual bytes
                    rec.state = RESIDENT
                    rec.degraded = False
                    rec.queued = False
                    self.promotions += 1
                    self._touch_peak_locked()
                    committed = True
        if stale:
            # a newer admit/release raced past this build: the ensemble
            # it cached on the old entry's booster must not outlive the
            # accounting
            self._drop_device_state(entry)
        if committed:
            entry.warmed_buckets = warmed
            self._event("promote", model=name, bytes=rec.bytes,
                        buckets=warmed)
            log.info("fleet: %s promoted (%d bytes resident, buckets %s)",
                     name, rec.bytes, warmed or "none")

    def _verify_spill(self, name: str, text: str,
                      sha: Optional[str]) -> None:
        """Integrity-check the host-tier snapshot against the manifest
        hash recorded at spill time.  A mismatch (bit rot, injected
        corruption) is counted and HEALED: the in-memory booster's
        frozen node arrays are authoritative, so promotion proceeds from
        them and the bad snapshot is discarded — corrupt bytes are never
        promoted."""
        cc = getattr(self.injector, "corrupt_check", None)
        if cc is not None:
            text = cc("spill_read", text)
        if sha is not None and hashlib.sha256(
                text.encode()).hexdigest() == sha:
            return
        with self._lock:
            self.spill_corruptions += 1
            rec = self._records.get(name)
            if rec is not None:
                rec.spill_text = None
                rec.spill_sha = None
        log.warning("fleet: spilled snapshot of %s failed its manifest "
                    "hash; rebuilding from the in-memory trees", name)
        self._event("spill_corrupt", model=name)

    def _warm(self, entry, ens) -> List[int]:
        """Warm the buckets through the fleet-wide warmup cache:
        (signature, bucket) pairs a sibling tenant already launched at
        are skipped, so fleet size does not multiply warmup launches."""
        g = entry.booster._gbdt
        iters = len(g.models) // max(g.num_tree_per_iteration, 1)
        sig = ens.shape_signature(entry.num_features)
        warmed: List[int] = []
        for b in sorted({int(x) for x in self.warmup_buckets}):
            if b <= 0 or not entry.use_device(b):
                continue
            if self.compile_cache.check(sig, b):
                warmed.append(b)      # a sibling already launched here
                continue
            ens.warmup_buckets(entry.num_features, [b], iters)
            self.compile_cache.mark(sig, b)
            warmed.append(b)
        return warmed

    # -- eviction ------------------------------------------------------- #
    def _make_room_locked(self, incoming: int,
                          exclude: str) -> Tuple[bool, List[Tuple]]:
        """Called UNDER the lock: spill LRU residents until `incoming`
        bytes fit.  Crossing the high watermark evicts down to the low
        watermark (hysteresis — one oversized admit does not thrash the
        whole fleet); the hard invariant is resident + incoming <=
        budget.  Returns (fits, victims); the caller ALWAYS finishes the
        victims' spill outside the lock — even on a failed fit — so no
        device bytes outlive the accounting."""
        if self.budget_bytes <= 0 or incoming > self.budget_bytes:
            return False, []
        victims: List[Tuple] = []
        trigger = self.high_watermark * self.budget_bytes
        target = min(self.low_watermark * self.budget_bytes,
                     self.budget_bytes - incoming)
        if self.resident_bytes + incoming > trigger:
            cands = sorted(
                (r for r in self._records.values()
                 if r.state == RESIDENT and r.name != exclude),
                key=lambda r: r.last_access)
            for r in cands:
                if self.resident_bytes <= target:
                    break
                # every caller holds self._lock (the _locked suffix
                # contract, same as supervisor.IngestBuffer)
                self.resident_bytes -= r.bytes  # tpulint: ok=lock-unguarded-write
                self.evictions += 1  # tpulint: ok=lock-unguarded-write
                victims.append((r, r.entry, r.ens))
                r.bytes = 0
                r.ens = None
                r.state = SPILLED
        # remaining overshoot means everything else is an in-flight
        # reservation: the caller backs off and retries
        return self.resident_bytes + incoming <= self.budget_bytes, victims

    def _finish_spills(self, victims: List[Tuple]) -> None:
        """OUTSIDE the lock: drop the victims' device caches and record
        their host-tier snapshot (model text + sha256 manifest).  The
        snapshot write is the expensive part — model_to_string — which
        is exactly why it cannot run under the lock."""
        for rec, entry, _ens in victims or ():
            with obs_tracing.span("serving/fleet_spill", "fleet",
                                  model=rec.name):
                self._drop_device_state(entry)
                try:
                    text = entry.booster.model_to_string()
                    sha = hashlib.sha256(text.encode()).hexdigest()
                except Exception as exc:  # noqa: BLE001 — trees stay valid
                    log.warning("fleet: spill snapshot of %s failed (%s); "
                                "host tier keeps the node arrays only",
                                rec.name, exc)
                    text = sha = None
                with self._lock:
                    if self._records.get(rec.name) is rec \
                            and rec.entry is entry:
                        rec.spill_text = text
                        rec.spill_sha = sha
            self._event("spill", model=rec.name)
            log.info("fleet: spilled %s to the host tier", rec.name)

    @staticmethod
    def _drop_device_state(entry) -> None:
        """Drop an entry's device tables: clear the gbdt ensemble cache
        and the warmed-bucket list.  In-flight dispatches holding the
        old ensemble finish on plain references (the caching allocator
        takes the tables back when the last one drops); the NEXT dispatch
        sees a host-only entry."""
        try:
            entry.booster._gbdt._dev_ens_cache = None
        except Exception as exc:  # noqa: BLE001 — cache drop is advisory
            log.debug("fleet: dev cache drop failed: %s", exc)
        entry.warmed_buckets = []

    def _touch_peak_locked(self) -> None:
        # every caller holds self._lock (the _locked suffix contract)
        if self.resident_bytes > self.peak_resident_bytes:
            self.peak_resident_bytes = self.resident_bytes  # tpulint: ok=lock-unguarded-write

    # -- observability -------------------------------------------------- #
    def _event(self, what: str, **fields) -> None:
        if self.config is not None:
            fleet_event(self.config, what, **fields)

    def state_counts(self) -> Dict[str, int]:
        with self._lock:
            out = {RESIDENT: 0, SPILLED: 0, PROMOTING: 0, "degraded": 0,
                   "host_only": 0}
            for r in self._records.values():
                out[r.state] += 1
                if r.degraded:
                    out["degraded"] += 1
                if r.host_only:
                    out["host_only"] += 1
        return out

    def residency(self, name: str) -> Optional[str]:
        with self._lock:
            rec = self._records.get(name)
            return None if rec is None else rec.state

    def snapshot(self) -> Dict:
        with self._lock:
            tenants = {
                r.name: {"state": r.state, "bytes": r.bytes,
                         "degraded": r.degraded, "host_only": r.host_only,
                         "promote_failures": r.promote_failures,
                         "kernel_error": (None if r.kernel_error is None
                                          else str(r.kernel_error)),
                         "spilled_snapshot": r.spill_sha is not None}
                for r in self._records.values()}
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self.resident_bytes,
                "peak_resident_bytes": self.peak_resident_bytes,
                "high_watermark": self.high_watermark,
                "low_watermark": self.low_watermark,
                "promotions": self.promotions,
                "promote_retries": self.promote_retries,
                "promote_failures": self.promote_failures,
                "evictions": self.evictions,
                "spill_corruptions": self.spill_corruptions,
                "device_hits": self.device_hits,
                "host_serves": self.host_serves,
                "compile_cache": self.compile_cache.snapshot(),
                "tenants": tenants,
            }


def publish_fleet_metrics(reg=None,
                          fleet: Optional[HbmResidencyManager] = None):
    """Expose a residency manager on the process-wide metrics registry
    (gauges pull live values at scrape time, obs/adapters idiom)."""
    reg = reg or default_registry()
    reg.gauge("lgbm_fleet_budget_bytes",
              help="Device byte budget for resident ensembles").set_fn(
        lambda: fleet.budget_bytes)
    reg.gauge("lgbm_fleet_resident_bytes",
              help="Accounted resident + reserved ensemble bytes").set_fn(
        lambda: fleet.resident_bytes)
    reg.gauge("lgbm_fleet_peak_resident_bytes",
              help="High-water mark of the byte accounting").set_fn(
        lambda: fleet.peak_resident_bytes)
    reg.gauge("lgbm_fleet_resident_models",
              help="Tenants with device-resident ensembles").set_fn(
        lambda: fleet.state_counts()[RESIDENT])
    reg.gauge("lgbm_fleet_spilled_models",
              help="Tenants serving from the host tier").set_fn(
        lambda: fleet.state_counts()[SPILLED])
    reg.counter("lgbm_fleet_promotions_total",
                help="Spilled tenants promoted to device").set_fn(
        lambda: fleet.promotions)
    reg.counter("lgbm_fleet_promote_retries_total",
                help="Promotion attempts retried after a fault").set_fn(
        lambda: fleet.promote_retries)
    reg.counter("lgbm_fleet_promote_failures_total",
                help="Promotions that exhausted the retry budget "
                     "(tenant degraded to the host walk)").set_fn(
        lambda: fleet.promote_failures)
    reg.counter("lgbm_fleet_evictions_total",
                help="Resident ensembles spilled under pressure").set_fn(
        lambda: fleet.evictions)
    reg.counter("lgbm_fleet_spill_corruptions_total",
                help="Spilled snapshots failing their manifest hash "
                     "(healed from the in-memory trees)").set_fn(
        lambda: fleet.spill_corruptions)
    reg.counter("lgbm_fleet_host_serves_total",
                help="Batches served on the host walk because the "
                     "tenant was not resident").set_fn(
        lambda: fleet.host_serves)
    reg.counter("lgbm_fleet_compile_cache_hits_total",
                help="Warmups skipped: a sibling tenant already "
                     "launched at the (signature, bucket)").set_fn(
        lambda: fleet.compile_cache.hits)
    reg.counter("lgbm_fleet_compile_cache_misses_total",
                help="(signature, bucket) warmups launched "
                     "first-hand").set_fn(
        lambda: fleet.compile_cache.misses)
