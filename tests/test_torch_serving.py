"""The port's serving (lightgbm_tpu_torch/serving) against the JAX package's
on the CPU: the micro-batcher, the metrics, the registry and the server.

- the MicroBatcher scenarios of tests/test_serving.py on a fake predictor:
  coalescing, the max-wait deadline, full batches before it, the bounded
  queue, request deadlines, an oversize request alone, a predictor's error;
- Histogram percentiles and the ModelStats snapshot equal to the JAX
  package's on the same observations;
- the registry on device="cpu" (KP1's plain version): hot swap, LRU
  eviction, version order, rollback (also under concurrent load and after
  its ensemble was dropped), every booster on the registry's device;
- the port's Server against the JAX package's Server on the fixture models
  (the JAX side trains nothing: ref50 binary, mc50 with 5 classes, reg50
  regression), the JAX server on its host walk (serve_min_device_work
  above every batch), the port's on KP1's plain version: raw scores bit
  for bit; served outputs bit for bit for the regression model and within
  3 ulp for the others (the objectives' links: numpy's exp against XLA's,
  ROADMAP.md queue 3); every served output bit for bit the port's own
  `predict(device=False)`;
- the queue-full host fallback, the HTTP endpoints on port 0 through
  ServingClient, the drain;
- a kernel that fails to launch raises to every request (500 over HTTP)
  and never opens the circuit breaker: no batch rides the host walk;
- `tpu_replica_count > 1`, `tpu_policy`, `tpu_alert` and `tpu_trend` raise
  NotImplementedError naming their ROADMAP items, and a Server without a
  device raises where there is no CUDA.

Every thread join, future and HTTP call has its own timeout.
"""
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.serving import Server as JServer
from lightgbm_tpu.serving.metrics import Histogram as JHistogram
from lightgbm_tpu.serving.metrics import ModelStats as JModelStats
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.obs import default_registry
from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.serving import (
    BatcherStoppedError, DrainingError, Histogram, MicroBatcher,
    ModelNotFoundError, ModelRegistry, ModelStats, QueueFullError,
    RequestTimeoutError, Server, ServingClient, ServingError)

INTEROP = os.path.join(os.path.dirname(__file__), "fixtures", "interop")
MODELS = {"ref50": "binary.test", "mc50": "multiclass.test",
          "reg50": "regression.test"}
WAIT_S = 30.0
# the objectives' links: numpy's exp in the port, XLA's in the JAX package
LINK_ULP = 3


def _text(name):
    with open(os.path.join(INTEROP, name + ".txt")) as f:
        return f.read()


def _rows(name, n, seed=0):
    X = np.loadtxt(os.path.join(INTEROP, MODELS[name]))[:, 1:]
    return X[np.random.RandomState(seed).permutation(len(X))[:n]]


@pytest.fixture(scope="module")
def texts():
    ref = _text("ref50")
    return {"v1": ref,
            "v2": tlgb.Booster(model_str=ref, device="cpu").model_to_string(
                num_iteration=20)}


def _host(text, X, raw_score=False):
    return tlgb.Booster(model_str=text, device="cpu").predict(
        X, raw_score=raw_score, device=False)


# --------------------------------------------------------------------- #
# MicroBatcher on a fake predictor (tests/test_serving.py:43-160)
# --------------------------------------------------------------------- #
class _FakePredictor:
    def __init__(self, delay_s=0.0):
        self.batch_sizes = []
        self.delay_s = delay_s
        self.lock = threading.Lock()

    def __call__(self, X):
        with self.lock:
            self.batch_sizes.append(X.shape[0])
        if self.delay_s:
            time.sleep(self.delay_s)
        return X[:, 0] * 10.0


def test_batcher_coalesces_concurrent_requests():
    fake = _FakePredictor(delay_s=0.005)
    b = MicroBatcher(fake, max_batch_rows=64, max_wait_ms=50.0,
                     timeout_ms=5000.0).start()
    rows = [np.array([[float(i), 1.0]]) for i in range(32)]
    try:
        with ThreadPoolExecutor(32) as pool:
            futs = [pool.submit(b.submit, r) for r in rows]
            outs = [f.result(timeout=WAIT_S) for f in futs]
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(out, [10.0 * i])
        assert sum(fake.batch_sizes) == 32
        assert len(fake.batch_sizes) < 32 and max(fake.batch_sizes) > 1
    finally:
        b.stop()


def test_batcher_deadline_flushes_partial_batch():
    fake = _FakePredictor()
    b = MicroBatcher(fake, max_batch_rows=1024, max_wait_ms=20.0,
                     timeout_ms=5000.0).start()
    try:
        t0 = time.perf_counter()
        out = b.submit(np.ones((1, 2)))
        assert time.perf_counter() - t0 < 2.0
        np.testing.assert_array_equal(out, [10.0])
        assert fake.batch_sizes == [1]
    finally:
        b.stop()


def test_batcher_full_batch_dispatches_before_deadline():
    fake = _FakePredictor(delay_s=0.01)
    b = MicroBatcher(fake, max_batch_rows=8, max_wait_ms=10_000.0,
                     timeout_ms=5000.0).start()
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(b.submit, np.full((1, 2), float(i)))
                    for i in range(16)]
            for f in futs:
                f.result(timeout=WAIT_S)
        assert time.perf_counter() - t0 < 5.0
        assert max(fake.batch_sizes) <= 8
    finally:
        b.stop()


def test_batcher_backpressure_queue_full():
    fake = _FakePredictor(delay_s=0.2)
    b = MicroBatcher(fake, max_batch_rows=4, max_wait_ms=0.0,
                     max_queue_rows=4, timeout_ms=10_000.0).start()
    try:
        rejected = 0
        with ThreadPoolExecutor(12) as pool:
            futs = [pool.submit(b.submit, np.ones((1, 2))) for _ in range(12)]
            for f in futs:
                try:
                    f.result(timeout=WAIT_S)
                except QueueFullError:
                    rejected += 1
        assert rejected > 0 and b.stats.rejected_queue_full == rejected
    finally:
        b.stop()


def test_batcher_request_timeout():
    fake = _FakePredictor(delay_s=0.5)
    b = MicroBatcher(fake, max_batch_rows=4, max_wait_ms=0.0,
                     timeout_ms=60.0).start()
    try:
        with ThreadPoolExecutor(2) as pool:
            f1 = pool.submit(b.submit, np.ones((1, 2)), 5000.0)
            time.sleep(0.05)
            f2 = pool.submit(b.submit, np.ones((1, 2)), 60.0)
            with pytest.raises(RequestTimeoutError):
                f2.result(timeout=WAIT_S)
            f1.result(timeout=WAIT_S)
        assert b.stats.timeouts >= 1
    finally:
        b.stop()


def test_batcher_oversize_request_goes_alone():
    fake = _FakePredictor()
    b = MicroBatcher(fake, max_batch_rows=8, max_wait_ms=1.0,
                     max_queue_rows=64, timeout_ms=5000.0).start()
    try:
        assert b.submit(np.ones((20, 2))).shape[0] == 20
        assert 20 in fake.batch_sizes
    finally:
        b.stop()


def test_batcher_predictor_error_propagates_and_stop():
    def boom(X):
        raise RuntimeError("kaboom")
    b = MicroBatcher(boom, max_batch_rows=4, max_wait_ms=0.0,
                     timeout_ms=5000.0).start()
    with pytest.raises(RuntimeError, match="kaboom"):
        b.submit(np.ones((1, 2)))
    assert b.stats.errors == 1
    b.stop()
    with pytest.raises(BatcherStoppedError):
        b.submit(np.ones((1, 2)))


# --------------------------------------------------------------------- #
# metrics against the JAX package's
# --------------------------------------------------------------------- #
def test_histogram_percentiles_match_jax():
    values = np.random.RandomState(4).lognormal(1.0, 1.5, 500)
    for bounds in ([1, 2, 5, 10], [0.5, 1, 2, 5, 10, 20, 50, 100]):
        ours, theirs = Histogram(bounds), JHistogram(bounds)
        for v in values:
            ours.observe(v)
            theirs.observe(v)
        assert ours.snapshot() == theirs.snapshot()
        for q in (0, 1, 50, 90, 99, 100):
            assert ours.percentile(q) == theirs.percentile(q)
        assert ours.cumulative_buckets() == theirs.cumulative_buckets()
    assert Histogram([1]).percentile(50) is None


def test_model_stats_snapshot_matches_jax():
    ours, theirs = ModelStats(), JModelStats()
    for s in (ours, theirs):
        r = np.random.RandomState(5)
        for _ in range(50):
            n = int(r.randint(1, 300))
            s.record_request(n)
            s.record_batch(n, device=bool(r.rand() < 0.7))
            s.record_latency(float(r.lognormal(0.0, 1.0)))
            s.record_wait(float(r.rand()))
        s.record_reject()
        s.record_shed()
        s.record_breaker_batch()
        s.record_timeout()
        s.record_error()
        s.record_fallback()
        s.set_queue_depth(17)
    assert ours.snapshot() == theirs.snapshot()


# --------------------------------------------------------------------- #
# registry on the CPU
# --------------------------------------------------------------------- #
def _registry(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("warmup_buckets", [1, 8])
    return ModelRegistry(**kw)


def test_registry_hot_swap_and_device(texts):
    reg = _registry(min_device_work=0, max_batch_rows=64)
    X = _rows("ref50", 9, seed=3)
    e1 = reg.load("m", model_str=texts["v1"])
    assert e1.booster.device.type == "cpu" and e1.warmed_buckets == [1, 8]
    out1, dev1 = e1.predict(X)
    assert dev1 is True
    np.testing.assert_array_equal(out1, _host(texts["v1"], X))
    e2 = reg.load("m", model_str=texts["v2"])
    assert e2.version == e1.version + 1
    out2, _ = reg.get("m").predict(X)
    np.testing.assert_array_equal(out2, _host(texts["v2"], X))
    assert not np.array_equal(out1, out2)
    np.testing.assert_array_equal(e1.predict(X)[0], out1)   # in flight
    raw, _ = e2.predict(X, raw_score=True)
    np.testing.assert_array_equal(raw, _host(texts["v2"], X, True))
    assert reg.info()["m"]["device_eligible"] is True


def test_registry_lru_and_versions(texts):
    reg = _registry(max_models=2, min_device_work=1 << 62, warmup_buckets=[1])
    s = texts["v2"]
    reg.load("a", model_str=s)
    reg.load("b", model_str=s)
    reg.get("a")                        # refresh a: b becomes LRU
    reg.load("c", model_str=s)
    assert reg.names() == ["a", "c"]
    with pytest.raises(ModelNotFoundError):
        reg.get("b")
    v1 = reg.get("a").version
    assert reg.evict("a") and not reg.evict("a")
    assert reg.load("a", model_str=s).version > v1


def test_registry_rollback_semantics(texts):
    reg = _registry(warmup_buckets=[1], min_device_work=1 << 62)
    X = _rows("ref50", 6, seed=7)
    with pytest.raises(ModelNotFoundError):
        reg.rollback("m")
    reg.load("m", model_str=texts["v1"])
    with pytest.raises(ModelNotFoundError):
        reg.rollback("m")
    reg.load("m", model_str=texts["v2"])
    assert reg.prior_entry("m").version == 1
    assert reg.rollback("m").version == 3
    np.testing.assert_array_equal(reg.get("m").predict(X)[0],
                                  _host(texts["v1"], X))
    assert reg.rollback("m").version == 4
    np.testing.assert_array_equal(reg.get("m").predict(X)[0],
                                  _host(texts["v2"], X))
    reg.evict("m")
    reg.load("m", model_str=texts["v1"])
    with pytest.raises(ModelNotFoundError):
        reg.rollback("m")


def test_registry_rollback_under_concurrent_load(texts):
    """Rollback churn races threaded prediction on KP1's plain version:
    every result is exactly one model's output and versions never go
    backwards on a thread; concurrent loads of one name keep the newest."""
    reg = _registry(min_device_work=0, max_batch_rows=8, warmup_buckets=[8])
    X = _rows("ref50", 8, seed=9)
    outs = (_host(texts["v1"], X), _host(texts["v2"], X))
    reg.load("m", model_str=texts["v1"])
    reg.load("m", model_str=texts["v2"])
    stop = threading.Event()
    errors = []

    def client():
        last = 0
        try:
            while not stop.is_set():
                entry = reg.get("m")
                out, dev = entry.predict(X)
                if not dev or not any(np.array_equal(out, o) for o in outs):
                    errors.append("torn or host output")
                    return
                if entry.version < last:
                    errors.append("version went backwards")
                    return
                last = entry.version
        except Exception as exc:   # noqa: BLE001 — fail the test, not the thread
            errors.append(repr(exc))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(10):
            reg.rollback("m")
        with ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(reg.load, "m", model_str=texts["v1"])
                    for _ in range(3)]
            for f in futs:
                f.result(timeout=WAIT_S)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert reg.get("m").version == 15       # 2 loads, 10 rollbacks, 3 loads


def test_registry_rollback_after_its_tables_were_dropped(texts):
    reg = _registry(min_device_work=0, max_batch_rows=64)
    X = _rows("ref50", 8, seed=11)
    reg.load("m", model_str=texts["v1"])
    reg.load("m", model_str=texts["v2"])
    prior = reg.prior_entry("m")
    assert prior.warmed_buckets
    prior.booster._gbdt._dev_ens_cache = None
    entry = reg.rollback("m")
    assert entry.booster._gbdt._dev_ens_cache is not None   # re-warmed
    out, dev = entry.predict(X)
    assert dev is True
    np.testing.assert_array_equal(out, _host(texts["v1"], X))


def test_unported_options_raise(texts):
    with pytest.raises(NotImplementedError, match="13b"):
        ModelRegistry(replica_count=2, device="cpu")
    for flag, item in (("tpu_replica_count", "13b"), ("tpu_policy", "13b"),
                       ("tpu_alert", "item 14"), ("tpu_trend", "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            Server({flag: 2 if flag == "tpu_replica_count" else True},
                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        _registry().load("m", checkpoint_dir="/nonexistent")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Server({})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelRegistry()


# --------------------------------------------------------------------- #
# the port's Server against the JAX package's
# --------------------------------------------------------------------- #
def _servers(text, **over):
    params = {"serve_batch_wait_ms": 2.0, "serve_warmup_buckets": [1, 8, 32],
              "serve_request_timeout_ms": 30_000.0, "verbosity": -1}
    params.update(over)
    ours = Server(dict(params, serve_min_device_work=1), device="cpu")
    theirs = JServer(dict(params, serve_min_device_work=1 << 62))
    ours.load_model("default", model_str=text)
    theirs.load_model("default", model_str=text)
    return ours, theirs


@pytest.mark.parametrize("model", sorted(MODELS))
def test_server_matches_jax_server(model):
    text = _text(model)
    ours, theirs = _servers(text)
    X = _rows(model, 40, seed=1)
    try:
        requests = [X[:1], X[1:8], X[8:40], X[5]]
        with ThreadPoolExecutor(4) as pool:
            futs = [(pool.submit(ours.predict, r), pool.submit(theirs.predict,
                                                               r))
                    for r in requests]
            pairs = [(a.result(timeout=WAIT_S), b.result(timeout=WAIT_S))
                     for a, b in futs]
        host = tlgb.Booster(model_str=text, device="cpu")
        for r, (a, b) in zip(requests, pairs):
            r2 = np.atleast_2d(r)
            np.testing.assert_array_equal(a, host.predict(r2, device=False))
            if model == "reg50":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_max_ulp(a, np.asarray(b), LINK_ULP)
        raw_ours, dev = ours.registry.get("default").predict(X,
                                                             raw_score=True)
        raw_theirs, jdev = theirs.registry.get("default").predict(
            X, raw_score=True)
        assert dev is True and jdev is False
        np.testing.assert_array_equal(raw_ours, np.asarray(raw_theirs))
        snap = ours.stats_snapshot()["models"]["default"]
        jsnap = theirs.stats_snapshot()["models"]["default"]
        assert snap["requests"] == jsnap["requests"] == 4
        assert snap["rows"] == jsnap["rows"] == 41
        assert snap["host_batches"] == 0 and snap["device_batches"] >= 1
        assert ours.stats_snapshot()["device"] == "cpu"
    finally:
        ours.shutdown()
        theirs.shutdown()
        default_registry().remove(model="default")


def test_server_queue_full_host_fallback():
    text = _text("ref50")
    ours = Server({"serve_queue_rows": 1, "serve_max_batch_rows": 1,
                   "serve_batch_wait_ms": 0.0, "serve_host_fallback": True,
                   "serve_min_device_work": 1, "serve_warmup_buckets": [1],
                   "verbosity": -1}, device="cpu")
    X = _rows("ref50", 1, seed=8)
    try:
        ours.load_model("default", model_str=text)
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(ours.predict, X) for _ in range(8)]
            outs = [f.result(timeout=WAIT_S) for f in futs]
        ref = _host(text, X)
        for out in outs:
            np.testing.assert_array_equal(out, ref)
        snap = ours.stats_snapshot()["models"]["default"]
        assert snap["host_fallback"] >= 1
        assert snap["host_batches"] == snap["host_fallback"]
        assert snap["rejected_queue_full"] == snap["host_fallback"]
    finally:
        ours.shutdown()
        default_registry().remove(model="default")


def test_http_endpoints_and_drain(texts):
    srv = Server({"serve_min_device_work": 1, "serve_warmup_buckets": [1, 8],
                  "serve_batch_wait_ms": 1.0, "verbosity": -1}, device="cpu")
    srv.load_model("default", model_str=texts["v1"])
    httpd = srv.serve_http(port=0, block=False)
    try:
        client = ServingClient(port=httpd.server_address[1], timeout=WAIT_S)
        assert client.health() == {"status": "ok", "models": ["default"]}
        X = _rows("ref50", 5, seed=9)
        out = client.predict(X)
        np.testing.assert_array_equal(out, _host(texts["v1"], X))
        np.testing.assert_array_equal(client.predict(X[0]), out[:1])
        stats = client.stats()
        m = stats["models"]["default"]
        assert m["requests"] == 2 and m["device_batches"] >= 1
        assert m["latency_ms"]["p50"] is not None
        assert "serve/batch_predict" in stats["phases"]
        assert client.models()["default"]["warmed_buckets"] == [1, 8]
        assert client.load_model("default", model_str=texts["v2"]) == 2
        np.testing.assert_array_equal(client.predict(X),
                                      _host(texts["v2"], X))
        with pytest.raises(ServingError) as ei:
            client.predict(X, model="nope")
        assert ei.value.status == 404
        for path in ("/alerts", "/trends", "/supervisor", "/cluster"):
            with pytest.raises(ServingError) as ei:
                client._call(path)
            assert ei.value.status == 404
        text = srv.metrics_text()
        for fam in ('lgbm_serve_requests_total{model="default"} 3',
                    "lgbm_device_live_bytes", "lgbm_serve_latency_ms_bucket",
                    "lgbm_serve_breaker_state", "lgbm_comm_retries_total"):
            assert fam in text, fam
        client.evict_model("default")
        with pytest.raises(ServingError) as ei:
            client.predict(X)
        assert ei.value.status == 404
        srv.load_model("default", model_str=texts["v1"])
        assert srv.drain_and_shutdown(timeout_s=WAIT_S) is True
        with pytest.raises(DrainingError):
            srv.predict(X)
    finally:
        srv.shutdown()
        default_registry().remove(model="default")


def test_kernel_error_never_opens_the_breaker(texts, monkeypatch):
    """KP1 failing to launch on every batch (here: the bucketed walk
    raising the port's KernelError) past the breaker's threshold: every
    request raises it, in process and as a 500 over HTTP; the breaker
    counts none of them and never opens, so no batch rides the host
    walk."""
    srv = Server({"serve_min_device_work": 1, "serve_warmup_buckets": [1],
                  "serve_batch_wait_ms": 0.0, "tpu_serve_breaker_failures": 2,
                  "verbosity": -1}, device="cpu")
    srv.load_model("default", model_str=texts["v1"])

    def broken(self, *a, **kw):
        raise _cuda.KernelError("CUDA kernel predict_ensemble_small failed "
                                "to launch: cudaError 98")
    monkeypatch.setattr(GBDT, "predict_bucketed", broken)
    httpd = srv.serve_http(port=0, block=False)
    try:
        X = _rows("ref50", 3, seed=10)
        for _ in range(5):
            with pytest.raises(_cuda.KernelError):
                srv.predict(X, timeout_ms=WAIT_S * 1e3)
        client = ServingClient(port=httpd.server_address[1], timeout=WAIT_S)
        with pytest.raises(ServingError) as ei:
            client.predict(X)
        assert ei.value.status == 500 and "cudaError 98" in str(ei.value)
        snap = srv.stats_snapshot()["models"]["default"]
        assert snap["errors"] == 6
        assert snap["host_batches"] == 0 and snap["breaker_batches"] == 0
        assert snap["device_batches"] == 0 and snap["host_fallback"] == 0
        assert snap["breaker"]["consecutive_failures"] == 0
        assert snap["breaker"]["open_count"] == 0
    finally:
        srv.shutdown()
        default_registry().remove(model="default")
