# Copied from lightgbm_tpu/serving/registry.py, but for the device every
# booster takes (the registry's), the replica sets (ROADMAP item 13b) and
# checkpoint loads (item 14), which raise NotImplementedError.
"""Versioned model registry for the serving subsystem.

TF-Serving-style model lifecycle on top of Booster: load a model from
text (file or string) onto the registry's device, warm KP1 up at every
power-of-two batch bucket the batcher can emit (the first launch builds
the kernels; after the warmup the first real request waits on nothing),
then install it atomically as the CURRENT version of its name.
Re-loading the same name hot-swaps: the version counter increments,
in-flight batches finish on the old entry (plain references keep it
alive), and the next dispatch sees the new one.  Bounded capacity with
least-recently-used eviction keeps a many-model box from accumulating
dead ensembles in device memory.

Every model is device-eligible: the port's walk tables never refuse an
ensemble (ops/predict.ensemble_layout), where the JAX package's signature
tensor could.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..basic import Booster
from ..device import resolve_device
from ..obs import default_registry
from ..ops import predict as predict_ops
from ..utils import log
from ..utils.profiling import Profiler

# the JAX package's serve_min_device_work default
# (lightgbm_tpu/ops/predict.py MIN_DEVICE_WORK, held by the config's
# serve_min_device_work)
MIN_DEVICE_WORK = 1 << 22


class ModelNotFoundError(KeyError):
    """No model registered under this name — map to HTTP 404."""


class ModelEntry:
    """One immutable (name, version) pair: a loaded Booster plus the
    per-batch device/host dispatch decision."""

    def __init__(self, name: str, version: int, booster: Booster,
                 min_device_work: int, max_bucket: int, fleet=None):
        self.name = name
        self.version = version
        self.booster = booster
        self.min_device_work = int(min_device_work)
        self.max_bucket = int(max_bucket)
        # HbmResidencyManager when the registry is fleet-managed: the
        # per-batch device/host decision then also asks "is this tenant
        # device-RESIDENT right now?" (serving/fleet.py)
        self.fleet = fleet
        self.loaded_at = time.time()
        self.warmed_buckets: List[int] = []
        g = booster._gbdt
        self.num_features = g.max_feature_idx + 1
        self.num_trees = len(g.models)
        self.num_class = max(g.num_tree_per_iteration, 1)

    def use_device(self, n_rows: int) -> bool:
        """Per-BATCH dispatch decision: the device path only once rows x
        trees clears the work floor; below it the host walk answers."""
        return n_rows * max(self.num_trees, 1) >= self.min_device_work

    def predict(self, X: np.ndarray, raw_score: bool = False):
        """Batch predict with the per-batch device/host choice: (output,
        whether the device walked it).  Device batches ride KP1 with rows
        padded to the power-of-two bucket; host batches walk the trees —
        both bit for bit the corresponding Booster.predict path.

        Fleet-managed entries add a residency gate: a SPILLED tenant is
        served IMMEDIATELY on the host walk (checkout schedules an async
        promotion), and a resident dispatch rides the checked-out
        ensemble explicitly so a concurrent eviction can never trigger a
        silent unaccounted rebuild through the gbdt cache."""
        g = self.booster._gbdt
        if self.use_device(X.shape[0]):
            if self.fleet is None:
                return self.predict_device(X, raw_score=raw_score), True
            ens = self.fleet.checkout(self.name, self)
            if ens is not None:
                return g.predict_bucketed(X, raw_score=raw_score,
                                          max_bucket=self.max_bucket,
                                          ensemble=ens), True
        return g.predict(X, raw_score=raw_score, device=False), False

    def predict_device(self, X: np.ndarray, raw_score: bool = False):
        return self.booster._gbdt.predict_bucketed(
            X, raw_score=raw_score, max_bucket=self.max_bucket)

    def warmup(self, buckets) -> List[int]:
        """Launch KP1 once at each bucket this entry can be dispatched at
        (only those clearing the device-work floor): the first launch
        builds the kernels, a build or launch failure raises."""
        g = self.booster._gbdt
        device_buckets = [b for b in buckets if self.use_device(b)]
        if device_buckets:
            self.warmed_buckets = g._device_ensemble().warmup_buckets(
                self.num_features, device_buckets, len(g.models)
                // max(g.num_tree_per_iteration, 1))
        return self.warmed_buckets

    def info(self) -> Dict:
        out = {
            "name": self.name,
            "version": self.version,
            "num_trees": self.num_trees,
            "num_features": self.num_features,
            "num_class": self.num_class,
            "loaded_at": self.loaded_at,
            "warmed_buckets": list(self.warmed_buckets),
            "device_eligible": True,
        }
        if self.fleet is not None:
            out["residency"] = self.fleet.residency(self.name)
        return out


class ModelRegistry:
    """name -> current ModelEntry, with versioned hot-swap and LRU
    eviction past `max_models` names, every model on `device` (the card
    unless the caller passes device="cpu")."""

    def __init__(self, max_models: int = 4,
                 min_device_work: int = MIN_DEVICE_WORK,
                 max_batch_rows: int = 256,
                 warmup_buckets: Optional[List[int]] = None,
                 profiler: Optional[Profiler] = None,
                 fleet=None, replica_count: int = 1, device=None):
        if int(replica_count) > 1:
            raise NotImplementedError(
                "tpu_replica_count > 1: replica sets across cards are "
                "ROADMAP item 13b of the port")
        self.device = resolve_device(device)
        self.max_models = max(int(max_models), 1)
        # HbmResidencyManager (serving/fleet.py) when device residency is
        # byte-budgeted; None keeps every loaded model resident
        self.fleet = fleet
        self.min_device_work = int(min_device_work)
        self.max_batch_rows = int(max_batch_rows)
        # [] / None -> every pow2 bucket the batcher can emit
        self.warmup_bucket_list = (list(warmup_buckets) if warmup_buckets
                                   else predict_ops.pow2_buckets(
                                       self.max_batch_rows))
        self.profiler = profiler or Profiler(enabled=True)
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}
        self._versions: Dict[str, int] = {}
        self._last_used: Dict[str, float] = {}
        # the entry each hot-swap DEMOTED, kept warm for rollback()
        self._prior: Dict[str, ModelEntry] = {}

    # -- lifecycle ----------------------------------------------------- #
    def load(self, name: str, model_str: Optional[str] = None,
             model_file: Optional[str] = None,
             params: Optional[Dict] = None, warmup: bool = True,
             checkpoint_dir: Optional[str] = None) -> ModelEntry:
        """Load + warm a model and install it as the current version of
        `name` (hot-swap when the name exists).  The expensive parts —
        parse, table build, warmup launches — happen OUTSIDE the registry
        lock, so serving traffic on other models never stalls behind a
        load."""
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "load(checkpoint_dir=...): training checkpoints are ROADMAP "
                "item 14 of the port")
        if (model_str is None) == (model_file is None):
            raise ValueError("load() needs exactly one of model_str / "
                             "model_file")
        with self.profiler.phase("serve/model_load"):
            booster = (Booster(model_file=model_file, params=params,
                               device=self.device)
                       if model_file is not None
                       else Booster(model_str=model_str, params=params,
                                    device=self.device))
        with self._lock:
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
        entry = ModelEntry(name, version, booster,
                           self.min_device_work, self.max_batch_rows,
                           fleet=self.fleet)
        if warmup and self.fleet is None:
            # fleet-managed entries warm via admit() AFTER install, so
            # residency accounting only ever tracks the live version
            with self.profiler.phase("serve/model_warmup"):
                entry.warmup(self.warmup_bucket_list)
        evicted: List[ModelEntry] = []
        with self._lock:
            current = self._versions.get(name, 0)
            if version < current:
                # a newer load for the same name raced past us while we
                # warmed; the freshest version stays installed
                log.warning("stale load of %s v%d discarded (v%d is live)",
                            name, version, current)
                return self._entries[name]
            demoted = self._entries.get(name)
            if demoted is not None:
                self._prior[name] = demoted
            self._entries[name] = entry
            self._last_used[name] = time.time()
            while len(self._entries) > self.max_models:
                lru = min((n for n in self._entries if n != name),
                          key=lambda n: self._last_used.get(n, 0.0))
                evicted.append(self._entries.pop(lru))
                self._last_used.pop(lru, None)
                self._prior.pop(lru, None)
        for dropped in evicted:
            log.warning("registry over capacity (%d): evicted %s",
                        self.max_models, dropped.name)
            if self.fleet is not None:
                self.fleet.release(dropped.name)
        if self.fleet is not None:
            with self.profiler.phase("serve/model_warmup"):
                self.fleet.admit(entry, promote=warmup)
        log.info("registry: %s v%d live (%d trees, %d features, "
                 "buckets %s)", name, entry.version, entry.num_trees,
                 entry.num_features, entry.warmed_buckets or "host-only")
        default_registry().counter(
            "lgbm_serve_model_loads_total",
            help="Models loaded into the serving registry",
            model=name).inc()
        return entry

    def rollback(self, name: str) -> ModelEntry:
        """Reinstall the version the last hot-swap demoted, under a NEW
        monotonic version — versions never reuse, so clients watching
        `info()` observe v_n -> v_{n+1} rather than time running
        backwards.  When the demoted booster's walk tables are still on
        the device, rollback is install-only: the swap itself is one dict
        assignment under the lock — concurrent predictions either see the
        whole old entry or the whole new one, never a torn mix.  When the
        prior's tables were RELEASED in the meantime (fleet spill, cache
        drop), the new entry must not inherit the stale warmed-bucket
        list: it installs host-serving and is re-promoted — the fleet
        admits it for asynchronous promotion under its byte ledger, or
        (no fleet) it is re-warmed right after install, outside the lock.
        Current and prior swap places, so a bad rollback can itself be
        rolled back.  Raises ModelNotFoundError when there is no prior
        version to return to."""
        with self._lock:
            current = self._entries.get(name)
            prior = self._prior.get(name)
            if current is None or prior is None:
                raise ModelNotFoundError(name)
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
            entry = ModelEntry(name, version, prior.booster,
                               self.min_device_work, self.max_batch_rows,
                               fleet=self.fleet)
            g = prior.booster._gbdt
            cache = g._dev_ens_cache
            cache_key = (len(g.models), g._model_gen)
            still_warm = (self.fleet is None and cache is not None
                          and cache[0] == cache_key)
            entry.warmed_buckets = (list(prior.warmed_buckets)
                                    if still_warm else [])
            self._entries[name] = entry
            self._prior[name] = current
            self._last_used[name] = time.time()
        if self.fleet is not None:
            # async re-promotion: the rollback stays O(dict assignment),
            # requests ride the host walk until the build commits
            self.fleet.admit(entry, promote=False)
        elif not still_warm and prior.warmed_buckets:
            # the prior's tables were dropped while demoted: re-warm now
            # (outside the lock) instead of serving a torn entry that
            # claims warm buckets it does not have
            entry.warmup(self.warmup_bucket_list)
        log.warning("registry: %s rolled back to v%d (the v%d booster)",
                    name, version, prior.version)
        default_registry().counter(
            "lgbm_serve_rollbacks_total",
            help="Registry rollbacks to the prior model version",
            model=name).inc()
        return entry

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise ModelNotFoundError(name)
            self._last_used[name] = time.time()
            return entry

    def prior_entry(self, name: str) -> Optional[ModelEntry]:
        """The entry the last hot-swap demoted (rollback's target), or
        None."""
        with self._lock:
            return self._prior.get(name)

    def evict(self, name: str) -> bool:
        with self._lock:
            dropped = self._entries.pop(name, None)
            self._last_used.pop(name, None)
            self._prior.pop(name, None)
            # keep the version counter: a re-load of the same name must
            # not reuse a version clients may have already seen
        if dropped is not None:
            if self.fleet is not None:
                self.fleet.release(name)
            log.info("registry: evicted %s", name)
        return dropped is not None

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def info(self) -> Dict:
        with self._lock:
            entries = list(self._entries.values())
        return {e.name: e.info() for e in entries}
