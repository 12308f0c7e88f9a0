"""The port's fleet residency (lightgbm_tpu_torch/serving/fleet.py) on the
CPU, held to the JAX package's where the two compute the same thing.

- the layout estimate equals the built ensemble's device bytes, and the
  byte ledger equals the resident ensembles' `device_bytes()` exactly;
- a budget of two and a half tenants spills the least recently used
  before it builds the third, and never exceeds the budget;
- a spilled tenant answers at once on the host walk, bit for bit, then is
  promoted and answers on KP1's plain version, bit for bit;
- the spill snapshot's manifest, and its corruption healed from the trees;
- promotion faults (FleetFaultInjector): retry with backoff, degrade to
  the host walk, the cool-down, heal; a kernel that fails to build or to
  launch, at a load or in a background promotion (a spilled tenant's, a
  rollback's), degrades the tenant and raises from then on to every
  request, none of which rides the host walk, until a load anew;
- equal signatures skip their warmup launch (the warmup cache), unequal
  ones do not;
- TenantQuota's token bucket against the JAX package's on an injected
  clock;
- the fleet's telemetry lines against the JAX package's for the same
  sequence (the byte counts are each package's own layout's);
- a mini tenant storm with promotion faults mid-storm and zero failures;
- the server's fleet, quota and metrics, and `tpu_policy` raising.

The JAX side trains nothing: every model is the fixture ref50.txt, cut to
other depths for other shapes.  Every wait has its own timeout.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.serving import HbmResidencyManager as JFleet
from lightgbm_tpu.serving import ModelRegistry as JRegistry
from lightgbm_tpu.serving import TenantQuota as JQuota
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs import default_registry
from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.resilience.comm import RetryPolicy
from lightgbm_tpu_torch.serving import (FleetFaultInjector,
                                        HbmResidencyManager, ModelRegistry,
                                        Server, ShapeBucketCache, ShedError,
                                        TenantQuota)
from lightgbm_tpu_torch.serving.fleet import RESIDENT, SPILLED

INTEROP = os.path.join(os.path.dirname(__file__), "fixtures", "interop")
WAIT_S = 20.0


def _wait_for(cond, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture(scope="module")
def texts():
    """Three tenants' texts of one shape (ref50 at 20 iterations, the
    same trees under three names) and a differently shaped one (ref50 at
    10 iterations)."""
    with open(os.path.join(INTEROP, "ref50.txt")) as f:
        ref = f.read()
    b = tlgb.Booster(model_str=ref, device="cpu")
    return {"tenant": b.model_to_string(num_iteration=20),
            "small": b.model_to_string(num_iteration=10)}


@pytest.fixture(scope="module")
def est(texts):
    g = tlgb.Booster(model_str=texts["tenant"], device="cpu")._gbdt
    return tpredict.estimate_device_bytes(g.models, 1)


X16 = np.random.RandomState(3).rand(16, 28)
X64 = np.random.RandomState(4).rand(64, 28)


def _fleet(budget, **kw):
    kw.setdefault("warmup_buckets", [16])
    fleet = HbmResidencyManager(int(budget), **kw)
    reg = ModelRegistry(max_models=16, min_device_work=1, fleet=fleet,
                        device="cpu")
    return fleet, reg


def _broken(self, *a, **kw):
    raise _cuda.KernelError("nvcc failed for predict_ensemble")


def _ledger(fleet):
    snap = fleet.snapshot()
    return sum(r.ens.device_bytes() for r in fleet._records.values()
               if r.state == RESIDENT), snap["resident_bytes"]


def test_estimate_is_the_built_bytes_and_the_ledger(texts, est):
    g = tlgb.Booster(model_str=texts["tenant"], device="cpu")._gbdt
    assert est == g._device_ensemble().device_bytes() > 0
    fleet, reg = _fleet(est * 4)
    try:
        reg.load("m", model_str=texts["tenant"])
        built, ledger = _ledger(fleet)
        assert ledger == built == est
        reg.evict("m")
        assert fleet.residency("m") is None and fleet.resident_bytes == 0
    finally:
        fleet.stop()


def test_budget_evicts_lru_before_allocation(texts, est):
    budget = int(est * 2.5)            # room for two residents
    fleet, reg = _fleet(budget)
    try:
        reg.load("a", model_str=texts["tenant"])
        reg.load("b", model_str=texts["tenant"])
        assert fleet.state_counts()[RESIDENT] == 2
        reg.get("b").predict(X64)      # refresh b: a becomes LRU
        reg.load("c", model_str=texts["tenant"])
        counts = fleet.state_counts()
        assert counts[RESIDENT] == 2 and counts[SPILLED] == 1
        assert fleet.residency("a") == SPILLED
        assert fleet.residency("c") == RESIDENT
        assert reg.get("a").booster._gbdt._dev_ens_cache is None
        built, ledger = _ledger(fleet)
        assert ledger == built == 2 * est
        assert fleet.peak_resident_bytes <= budget
    finally:
        fleet.stop()


def test_oversize_model_serves_host_only(texts, est):
    fleet, reg = _fleet(est // 2)
    try:
        entry = reg.load("big", model_str=texts["tenant"])
        assert fleet.snapshot()["tenants"]["big"]["host_only"]
        out, dev = entry.predict(X64)
        assert dev is False and fleet.resident_bytes == 0
        np.testing.assert_array_equal(
            out, entry.booster.predict(X64, device=False))
    finally:
        fleet.stop()


def test_spilled_tenant_serves_at_once_then_promotes(texts, est):
    budget = int(est * 1.4)            # one resident
    fleet, reg = _fleet(budget)
    try:
        reg.load("a", model_str=texts["tenant"])
        reg.load("b", model_str=texts["tenant"])     # spills a
        assert fleet.residency("a") == SPILLED
        entry = reg.get("a")
        out, dev = entry.predict(X64)
        assert dev is False
        np.testing.assert_array_equal(
            out, entry.booster.predict(X64, device=False))
        assert _wait_for(lambda: fleet.residency("a") == RESIDENT)
        out2, dev2 = entry.predict(X64)
        assert dev2 is True
        np.testing.assert_array_equal(out2, out)
        assert fleet.residency("b") == SPILLED
        assert fleet.peak_resident_bytes <= budget
        assert fleet.host_serves >= 1 and fleet.device_hits >= 1
    finally:
        fleet.stop()


def test_spill_snapshot_roundtrip_and_corruption_heal(texts, est):
    inj = FleetFaultInjector()
    fleet, reg = _fleet(est * 1.4, injector=inj)
    try:
        reg.load("p", model_str=texts["tenant"])
        reg.load("q", model_str=texts["tenant"])     # spills p
        assert fleet.snapshot()["tenants"]["p"]["spilled_snapshot"]
        inj.corrupt("spill_read")
        entry = reg.get("p")
        entry.predict(X64)                           # re-promote p
        assert _wait_for(lambda: fleet.residency("p") == RESIDENT)
        assert fleet.spill_corruptions == 1
        out, dev = entry.predict(X64)
        assert dev is True
        np.testing.assert_array_equal(
            out, entry.booster.predict(X64, device=False))
    finally:
        fleet.stop()


def test_promotion_faults_retry_degrade_heal(texts, est):
    inj = FleetFaultInjector()
    fleet, reg = _fleet(est * 4, injector=inj,
                        retry=RetryPolicy(retries=1, base_ms=1.0),
                        degrade_cooldown_s=0.05)
    try:
        inj.fail("promote", count=2)                 # both attempts fail
        entry = reg.load("x", model_str=texts["tenant"])   # never raises
        assert fleet.residency("x") == SPILLED
        assert fleet.promote_retries == 1 and fleet.promote_failures == 1
        assert fleet.snapshot()["tenants"]["x"]["degraded"]
        out, dev = entry.predict(X64)
        assert dev is False
        np.testing.assert_array_equal(
            out, entry.booster.predict(X64, device=False))
        for _ in range(5):                           # inside the cool-down
            entry.predict(X64)
        assert fleet.promote_failures == 1
        time.sleep(0.1)                              # past the cool-down
        entry.predict(X64)
        assert _wait_for(lambda: fleet.residency("x") == RESIDENT)
        assert not fleet.snapshot()["tenants"]["x"]["degraded"]
    finally:
        fleet.stop()


def test_kernel_failure_degrades_and_raises(texts, est, monkeypatch):
    """A kernel that does not build (here: the warmup raising the port's
    KernelError) is no transient fault: the load raises, the tenant is
    counted and degraded, the reservation is returned, and its requests
    raise instead of riding the host walk."""
    monkeypatch.setattr(tpredict.DeviceEnsemble, "warmup_buckets", _broken)
    fleet, reg = _fleet(est * 4)
    try:
        with pytest.raises(_cuda.KernelError):
            reg.load("k", model_str=texts["tenant"])
        assert fleet.promote_failures == 1 and fleet.promote_retries == 0
        assert fleet.resident_bytes == 0
        assert fleet.snapshot()["tenants"]["k"]["degraded"]
        with pytest.raises(_cuda.KernelError, match="nvcc failed"):
            reg.get("k").predict(X64)
        assert fleet.host_serves == 0
    finally:
        fleet.stop()


@pytest.mark.parametrize("path", ["spill", "rollback"])
def test_kernel_failure_in_a_background_promotion_raises(texts, est,
                                                         monkeypatch, path):
    """The promotion worker's kernel failure is not swallowed: a spilled
    tenant's promotion (scheduled by its first request, which rides the
    host walk at once) or a rollback's, failing at the warmup launch,
    leaves the tenant raising KernelError on every later request, none of
    them on the host walk, with no retry after the cool-down; a load anew
    clears it."""
    fleet, reg = _fleet(est * 1.4, degrade_cooldown_s=0.0)
    try:
        reg.load("a", model_str=texts["tenant"])
        if path == "spill":
            reg.load("b", model_str=texts["tenant"])     # spills a
        else:
            reg.load("a", model_str=texts["small"])      # v2 demotes v1
        # a cold warmup cache, as in a new process: the promotion launches
        fleet.compile_cache = ShapeBucketCache()
        monkeypatch.setattr(tpredict.DeviceEnsemble, "warmup_buckets",
                            _broken)
        if path == "spill":
            entry = reg.get("a")
            out, dev = entry.predict(X64)
            assert dev is False
            np.testing.assert_array_equal(
                out, entry.booster.predict(X64, device=False))
        else:
            entry = reg.rollback("a")                    # async promotion
        assert _wait_for(
            lambda: fleet.snapshot()["tenants"]["a"]["kernel_error"])
        host = fleet.host_serves
        for _ in range(3):
            with pytest.raises(_cuda.KernelError, match="nvcc failed"):
                entry.predict(X64)
        time.sleep(0.05)
        assert fleet.host_serves == host
        assert fleet.promote_failures == 1 and fleet.promote_retries == 0
        assert fleet.residency("a") == SPILLED
        monkeypatch.undo()
        entry = reg.load("a", model_str=texts["tenant"])
        assert fleet.residency("a") == RESIDENT
        out, dev = entry.predict(X64)
        assert dev is True
        np.testing.assert_array_equal(
            out, entry.booster.predict(X64, device=False))
    finally:
        fleet.stop()


def test_equal_signatures_skip_their_warmup(texts, est, monkeypatch):
    calls = []
    real = tpredict.DeviceEnsemble.warmup_buckets

    def counted(self, num_features, buckets, num_iteration):
        calls.append(tuple(buckets))
        return real(self, num_features, buckets, num_iteration)
    monkeypatch.setattr(tpredict.DeviceEnsemble, "warmup_buckets", counted)
    cache = ShapeBucketCache()
    fleet, reg = _fleet(est * 16, warmup_buckets=[16, 64],
                        compile_cache=cache)
    try:
        reg.load("a", model_str=texts["tenant"])
        assert calls == [(16,), (64,)] and cache.misses == 2
        reg.load("b", model_str=texts["tenant"])     # same signature
        assert fleet.residency("b") == RESIDENT
        assert calls == [(16,), (64,)] and cache.hits == 2
        assert reg.get("b").warmed_buckets == [16, 64]
        reg.load("s", model_str=texts["small"])      # another signature
        assert calls[2:] == [(16,), (64,)] and cache.misses == 4
        out, dev = reg.get("s").predict(X64)
        assert dev is True
        np.testing.assert_array_equal(
            out, reg.get("s").booster.predict(X64, device=False))
    finally:
        fleet.stop()


def test_shape_bucket_cache_counts():
    c = ShapeBucketCache()
    sig = (1, 8, 14, 16, 0, 0, 28)
    assert c.check(sig, 16) is False and c.misses == 1
    c.mark(sig, 16)
    assert c.check(sig, 16) is True and c.hits == 1
    assert c.check(sig, 32) is False
    assert c.check((2,) + sig[1:], 16) is False
    assert len(c) == 1
    assert c.snapshot() == {"entries": 1, "hits": 1, "misses": 3}


def test_tenant_quota_matches_jax():
    """The same admissions on an injected clock give the JAX package's
    answers (None or the Retry-After seconds) and shed counts."""
    rng = np.random.RandomState(6)
    steps = [(str(rng.choice(["a", "b", "c"])), float(rng.exponential(0.01)))
             for _ in range(300)]
    for qps, burst in ((10.0, 2.0), (3.0, 0.0), (0.1, 0.0), (50.0, 5.0)):
        answers = []
        for Quota in (TenantQuota, JQuota):
            clock = [0.0]
            q = Quota(qps=qps, burst=burst, clock=lambda: clock[0])
            got = []
            for tenant, dt in steps:
                clock[0] += dt
                got.append(q.try_admit(tenant))
            answers.append((got, q.snapshot(), q.burst))
        assert answers[0] == answers[1]
        assert any(a is not None for a in answers[0][0])


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fleet_events_match_jax(texts, est, tmp_path):
    """One sequence (load a; load b, which spills a; load a again, a hot
    swap that spills b; evict b; evict a) on each package's fleet with room
    for one tenant by its own estimate and no warmup buckets (the JAX side
    compiles nothing): the
    same event lines, in the same order, but for the byte counts, which
    are each package's own layout's (the port's equal to its tables')."""
    jb = jlgb.Booster(model_str=texts["tenant"])
    jest = jpredict.estimate_device_bytes(jb._gbdt.models, 1)
    got = {}
    for pkg in ("port", "jax"):
        path = str(tmp_path / ("%s.jsonl" % pkg))
        if pkg == "port":
            cfg = Config({"tpu_telemetry_path": path, "verbosity": -1})
            fleet = HbmResidencyManager(int(est * 1.4), warmup_buckets=[],
                                        config=cfg)
            reg = ModelRegistry(max_models=8, min_device_work=1,
                                fleet=fleet, device="cpu")
        else:
            cfg = JConfig({"tpu_telemetry_path": path, "verbosity": -1})
            fleet = JFleet(int(jest * 1.4), warmup_buckets=[], config=cfg)
            reg = JRegistry(max_models=8, min_device_work=1, fleet=fleet)
        try:
            reg.load("a", model_str=texts["tenant"])
            reg.load("b", model_str=texts["tenant"])      # spills a
            reg.load("a", model_str=texts["tenant"])      # hot swap
            reg.evict("b")
            reg.evict("a")
        finally:
            fleet.stop()
        got[pkg] = _events(path)
    strip = ("est_bytes", "bytes")
    port = [{k: v for k, v in e.items() if k not in strip}
            for e in got["port"]]
    jax_ = [{k: v for k, v in e.items() if k not in strip}
            for e in got["jax"]]
    assert port == jax_
    whats = [e["what"] for e in port]
    for expected in ("admit", "promote", "spill", "demote", "release"):
        assert expected in whats, (expected, whats)
    for e in got["port"]:
        if "est_bytes" in e:
            assert e["est_bytes"] == est
        if e["what"] == "promote":
            assert e["bytes"] == est


def test_mini_tenant_storm_zero_failures(texts, est):
    budget = est * 3
    srv = Server({"verbosity": -1, "serve_min_device_work": 1,
                  "serve_max_models": 16, "serve_max_batch_rows": 64,
                  "serve_warmup_buckets": [16],
                  "tpu_fleet_hbm_budget_mb": budget / float(1 << 20)},
                 device="cpu")
    inj = FleetFaultInjector()
    srv.fleet.injector = inj
    srv.fleet.degrade_cooldown_s = 0.2
    names = ["t%d" % i for i in range(8)]
    for n in names:
        srv.load_model(n, model_str=texts["tenant"])
    failures, preds = [0], [0]
    lock = threading.Lock()
    stop = threading.Event()
    want = tlgb.Booster(model_str=texts["tenant"], device="cpu").predict(
        X16, device=False)

    def hammer(targets):
        i = 0
        while not stop.is_set():
            try:
                out = srv.predict(X16, model=targets[i % len(targets)])
                ok = np.array_equal(out, want)
                with lock:
                    preds[0] += ok
                    failures[0] += not ok
            except Exception:   # noqa: BLE001 — the storm counts ANY failure
                with lock:
                    failures[0] += 1
            i += 1

    threads = [threading.Thread(target=hammer, args=(names[k::3],),
                                daemon=True) for k in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
        inj.fail("promote", count=2)        # promotions fail mid-storm
        time.sleep(0.8)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert failures[0] == 0 and preds[0] > 0
        assert srv.fleet.peak_resident_bytes <= budget
        assert srv.fleet.evictions > 0
    finally:
        stop.set()
        srv.shutdown()
        for n in names:
            default_registry().remove(model=n)


def test_server_fleet_quota_and_metrics(texts, est):
    srv = Server({"verbosity": -1, "serve_min_device_work": 1,
                  "serve_max_models": 8, "serve_max_batch_rows": 64,
                  "serve_warmup_buckets": [16, 64],
                  "tpu_fleet_hbm_budget_mb": (est * 1.4) / float(1 << 20),
                  "tpu_fleet_tenant_qps": 0.5,
                  "tpu_fleet_tenant_burst": 2.0}, device="cpu")
    try:
        srv.load_model("a", model_str=texts["tenant"])
        srv.load_model("b", model_str=texts["tenant"])     # spills a
        want = tlgb.Booster(model_str=texts["tenant"], device="cpu").predict(
            X16, device=False)
        np.testing.assert_array_equal(srv.predict(X16, model="b"), want)
        with pytest.raises(ShedError) as exc:
            srv.predict(X16, model="b")
            srv.predict(X16, model="b")
        assert exc.value.retry_after_s > 0
        np.testing.assert_array_equal(srv.predict(X16, model="a"), want)
        snap = srv.stats_snapshot()
        assert snap["fleet"]["budget_bytes"] == int(est * 1.4)
        assert snap["quota"]["sheds"].get("b", 0) >= 1
        assert "residency" in snap["registry"]["a"]
        text = srv.metrics_text()
        for fam in ("lgbm_fleet_budget_bytes", "lgbm_fleet_resident_bytes",
                    "lgbm_fleet_promotions_total",
                    "lgbm_fleet_evictions_total",
                    "lgbm_fleet_compile_cache_hits_total",
                    "lgbm_serve_quota_shed_total",
                    "lgbm_serve_breaker_state",
                    "lgbm_serve_breaker_open_total"):
            assert fam in text, fam
    finally:
        srv.shutdown()
        default_registry().remove(model="a")
        default_registry().remove(model="b")


def test_fleet_policy_lever_raises():
    cfg = Config({"tpu_policy": True, "verbosity": -1})
    with pytest.raises(NotImplementedError, match="item 14"):
        HbmResidencyManager(1 << 20, config=cfg)
