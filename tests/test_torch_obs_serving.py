"""The port's telemetry and robustness pieces that serving imports
(lightgbm_tpu_torch/obs, utils/profiling.py, resilience/comm.py) against
the JAX package's, on the CPU.

- MetricsRegistry: the Prometheus exposition and `collect()` equal to the
  JAX package's for the same operations (counters, gauges, pulled values,
  histograms, attach, label escaping, removal);
- SpanTracer: the spans of one served request (request, enqueue,
  micro-batch, the batch-predict phase), nested on their threads, written
  as Chrome trace-event JSON; tracing off costs nothing;
- Profiler: the phases' calls and the snapshot's keys equal the JAX
  package's for the same phases;
- RetryPolicy backoffs and FaultInjector schedules equal to the JAX
  package's under the same seed and the same arming;
- the card's device metrics (obs/device.py): the JAX package's names where
  the quantity exists on the card, none of the XLA-only ones; zeros on the
  CPU; the build counts read from the kernels' build log;
- the modules copied from the JAX package keep its code: their syntax
  trees equal the JAX modules' but for docstrings.
"""
import ast
import json
import os

import numpy as np
import pytest

from lightgbm_tpu.obs import registry as jregistry
from lightgbm_tpu.resilience import comm as jcomm
from lightgbm_tpu.utils import profiling as jprofiling
from lightgbm_tpu_torch.obs import adapters, device as obs_device
from lightgbm_tpu_torch.obs import default_registry, get_tracer
from lightgbm_tpu_torch.obs import registry as tregistry
from lightgbm_tpu_torch.obs import tracing
from lightgbm_tpu_torch.ops import _cuda
from lightgbm_tpu_torch.resilience import comm as tcomm
from lightgbm_tpu_torch.serving import Server
from lightgbm_tpu_torch.utils import profiling as tprofiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTEROP = os.path.join(REPO, "tests", "fixtures", "interop")


def _exercise(mod):
    reg = mod.MetricsRegistry()
    reg.counter("lgbm_x_total", help="X", model="a").inc(3)
    reg.counter("lgbm_x_total", model='b"q\\n').inc(0.5)
    reg.gauge("lgbm_depth", help="depth").set(7.25)
    reg.gauge("lgbm_pulled", help="pulled", model="a").set_fn(lambda: 42)
    reg.gauge("lgbm_broken", help="raises").set_fn(lambda: 1 / 0)
    reg.counter("lgbm_pull_total").set_fn(lambda: 1e16)
    h = reg.histogram("lgbm_ms", bounds=(1, 2, 5), help="ms", model="a")
    for v in (0.5, 1.5, 1.5, 3.0, 8.0, 20.0):
        h.observe(v)
    pre = mod.Histogram([10, 100])
    for v in (5, 50, 500):
        pre.observe(v)
    reg.attach("lgbm_pre", pre, help="pre-built", model="b")
    with pytest.raises(ValueError):
        reg.gauge("lgbm_x_total")
    removed = reg.remove(model="zzz")
    text1 = reg.render_prometheus()
    removed += reg.remove("lgbm_x_total", model="a")
    return (text1, reg.render_prometheus(), removed, reg.collect(),
            reg.family_sum("lgbm_x_total"), reg.family_sum("lgbm_ms"))


def test_registry_exposition_matches_jax():
    ours, theirs = _exercise(tregistry), _exercise(jregistry)
    assert ours == theirs
    assert 'lgbm_ms_bucket{model="a",le="+Inf"} 6' in ours[0]
    assert 'model="b\\"q\\\\n"' in ours[0]


def test_spans_of_a_served_request(tmp_path):
    path = str(tmp_path / "trace.json")
    with open(os.path.join(INTEROP, "ref50.txt")) as f:
        text = f.read()
    X = np.loadtxt(os.path.join(INTEROP, "binary.test"))[:3, 1:]
    assert not get_tracer().enabled
    assert tracing.span("off") is tracing.span("off too")   # shared null
    srv = Server({"tpu_trace_path": path, "serve_min_device_work": 1,
                  "serve_warmup_buckets": [4], "verbosity": -1},
                 device="cpu")
    try:
        srv.load_model("default", model_str=text)
        srv.predict(X)
    finally:
        srv.shutdown()
        get_tracer().close()
        default_registry().remove(model="default")
    assert not get_tracer().enabled
    with open(path) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    by_name = {e["name"]: e for e in spans}
    for name in ("serve/model_load", "serve/model_warmup", "serve/request",
                 "serve/enqueue", "serve/micro_batch",
                 "serve/batch_predict"):
        assert name in by_name, name
    request, enqueue = by_name["serve/request"], by_name["serve/enqueue"]
    batch, phase = by_name["serve/micro_batch"], by_name["serve/batch_predict"]
    assert enqueue["args"]["parent_id"] == request["args"]["span_id"]
    assert phase["args"]["parent_id"] == batch["args"]["span_id"]
    assert batch["tid"] != request["tid"]          # the batcher's thread
    assert batch["args"]["rows"] == 3 and request["args"]["model"] == "default"
    assert request["ts"] <= batch["ts"]
    assert batch["ts"] + batch["dur"] <= request["ts"] + request["dur"]
    assert trace["metadata"]["dropped_events"] == 0
    assert set(trace["metadata"]["compile_counts"]) == {"backend_compiles",
                                                        "cache_hits"}
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"}
    assert any(n.startswith("lgbm-serve-batcher") for n in names)


def test_profiler_phases_match_jax():
    snaps = []
    for mod in (tprofiling, jprofiling):
        p = mod.Profiler(enabled=True)
        for name in ("serve/model_load", "serve/batch_predict",
                     "serve/batch_predict", "serve/host_fallback"):
            with p.phase(name):
                pass
        with pytest.raises(KeyError):
            with p.phase("serve/boom"):
                raise KeyError("x")
        snap = p.snapshot()
        snaps.append({k: (v["calls"], sorted(v)) for k, v in snap.items()})
        off = mod.Profiler(enabled=False)
        with off.phase("x"):
            pass
        assert off.snapshot() == {} and off.report() is None
        p.reset()
        assert p.snapshot() == {}
    assert snaps[0] == snaps[1]
    assert snaps[0]["serve/batch_predict"][0] == 2


def test_retry_and_fault_schedules_match_jax():
    for kw in (dict(retries=4, base_ms=50.0, seed=7),
               dict(retries=2, base_ms=1.0, max_ms=3.0, jitter=0.0, seed=1),
               dict(retries=6, base_ms=10.0, max_ms=100.0, jitter=1.0,
                    seed=3)):
        ours, theirs = tcomm.RetryPolicy(**kw), jcomm.RetryPolicy(**kw)
        assert ours.retries == theirs.retries
        assert ([ours.backoff_s(a) for a in range(1, 9)]
                == [theirs.backoff_s(a) for a in range(1, 9)])
    results = []
    for mod in (tcomm, jcomm):
        inj = mod.FaultInjector()
        inj.fail("promote", count=2)
        inj.delay("promote", count=1, seconds=0.0)
        inj.drop("send", count=2)
        inj.partition("recv")
        inj.fail("allgather", exc_factory=lambda: TimeoutError("t"))
        got = []
        for op in ("promote", "promote", "promote", "promote", "send",
                   "send", "send", "recv", "recv", "allgather", "allgather",
                   "other"):
            try:
                got.append(inj.check(op))
            except (ConnectionError, TimeoutError) as exc:
                got.append(type(exc).__name__)
        results.append((got, inj.injected, inj.armed("recv"),
                        inj.armed("promote"), inj.armed()))
        inj.reset()
        assert not inj.armed()
    assert results[0] == results[1]
    assert results[0][0][:4] == ["ConnectionError", "ConnectionError", "ok",
                                 "ok"]
    failure = tcomm.CommFailure("send", 2, 3, OSError("x"))
    assert str(failure) == str(jcomm.CommFailure("send", 2, 3, OSError("x")))


def test_device_metrics_names_and_cpu_zeros(monkeypatch):
    assert obs_device.device_stats("cpu") == {
        "live_buffers": 0, "live_bytes": 0, "peak_bytes": 0}
    monkeypatch.setattr(_cuda, "BUILD_LOG", {"compiled": ["a", "b"],
                                             "cached": ["c"]})
    assert obs_device.compile_counts() == {"backend_compiles": 2,
                                           "cache_hits": 1}
    reg = tregistry.MetricsRegistry()
    adapters.ensure_device_metrics(reg, "cpu")
    text = reg.render_prometheus()
    for name in ("lgbm_device_live_buffers 0", "lgbm_device_live_bytes 0",
                 "lgbm_xla_peak_hbm_bytes 0",
                 "lgbm_xla_backend_compiles_total 2",
                 "lgbm_xla_cache_hits_total 1"):
        assert name in text, name
    for xla_only in ("lgbm_jit_cache_entries", "lgbm_xla_traces_total",
                     "lgbm_xla_cost_analyses_total"):
        assert xla_only not in text


def _code(path):
    """The module's syntax tree without its docstrings."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("path", ["obs/registry.py", "serving/admission.py",
                                  "serving/metrics.py", "serving/client.py",
                                  "serving/batcher.py", "serving/shadow.py"])
def test_copied_modules_keep_the_code(path):
    with open(os.path.join(REPO, "lightgbm_tpu_torch", path)) as f:
        first = f.readline()
    assert first.startswith("# Copied from lightgbm_tpu/%s;" % path)
    assert _code("lightgbm_tpu_torch/" + path) == _code("lightgbm_tpu/" + path)
