# Copied from lightgbm_tpu/serving/server.py, but for the device the
# server resolves (the card unless the caller passes device="cpu"), a
# kernel that fails to build or launch (raised to the request, 500 over
# HTTP, never counted by the circuit breaker), and what waits for later items of ROADMAP.md: the replica lever and sets
# (item 13b: tpu_replica_count > 1 and tpu_policy raise
# NotImplementedError), the alert engine, the trend store, the
# supervisor and the cluster view (item 14: tpu_alert and tpu_trend raise
# NotImplementedError; /alerts, /trends, /supervisor, /ingest and /cluster
# answer 404).
"""Inference server on the card: in-process API + stdlib HTTP frontend.

Composition of the serving subsystem:

    HTTP POST /predict ─┐
                        ├─> Server.predict() ─> MicroBatcher (per model)
    in-process callers ─┘           │                  │ coalesce
                                    │                  v
                                    │        ModelRegistry.get(name)
                                    │                  │
                                    │        ModelEntry.predict(batch)
                                    │          KP1 at the bucket OR
                                    │          host walk (small batch)
                                    └─ backpressure: queue full ->
                                       host fallback (small) / 429

Everything is stdlib (http.server + json) — the box serving the model
needs no web framework.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..config import Config
from ..device import resolve_device
from ..obs import adapters as obs_adapters
from ..obs import default_registry
from ..obs import tracing as obs_tracing
from ..ops._cuda import KernelError
from ..utils import log
from ..utils.profiling import Profiler
from .admission import CircuitBreaker, DrainingError, ShedError, TenantQuota
from .batcher import (BatcherStoppedError, MicroBatcher, QueueFullError,
                      RequestTimeoutError)
from .fleet import HbmResidencyManager, publish_fleet_metrics
from .metrics import ModelStats
from .registry import ModelEntry, ModelNotFoundError, ModelRegistry
from .shadow import ShadowMirror


class Server:
    """In-process serving frontend; one MicroBatcher + ModelStats per
    registered model name, all models sharing one registry/profiler, on
    one device: the card unless `device` says otherwise (tests pass
    device="cpu"); with no device and no CUDA it raises."""

    def __init__(self, config: Optional[Config] = None, device=None,
                 **overrides):
        self.device = resolve_device(device)
        if isinstance(config, Config) and not overrides:
            cfg = config
        elif isinstance(config, Config):
            cfg = Config(dict(config.raw_params, **overrides))
        else:
            cfg = Config(dict(config or {}, **overrides))
        self.config = cfg
        for flag, what in (
                ("tpu_alert", "the alert engine is ROADMAP item 14"),
                ("tpu_trend", "the trend store is ROADMAP item 14"),
                ("tpu_policy", "the set_replica_count lever needs the "
                 "replica sets, ROADMAP item 13b")):
            if getattr(cfg, flag, False):
                raise NotImplementedError("%s: %s of the port" % (flag, what))
        self.profiler = Profiler(enabled=True)
        # fleet residency: with a byte budget set, device memory becomes
        # an LRU-managed cache over the registry's models (serving/fleet)
        self.fleet = (HbmResidencyManager.from_config(cfg)
                      if cfg.tpu_fleet_hbm_budget_mb > 0 else None)
        self._quota = (TenantQuota(cfg.tpu_fleet_tenant_qps,
                                   cfg.tpu_fleet_tenant_burst)
                       if cfg.tpu_fleet_tenant_qps > 0 else None)
        self.registry = ModelRegistry(
            max_models=cfg.serve_max_models,
            min_device_work=cfg.serve_min_device_work,
            max_batch_rows=cfg.serve_max_batch_rows,
            warmup_buckets=cfg.serve_warmup_buckets or None,
            profiler=self.profiler,
            fleet=self.fleet,
            replica_count=cfg.tpu_replica_count,
            device=self.device)
        self._batchers: Dict[str, MicroBatcher] = {}
        self._stats: Dict[str, ModelStats] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._shadows: Dict[str, ShadowMirror] = {}
        self._draining = False
        # GET /metrics renders the process-wide registry: per-model
        # request counters published below, plus the device gauges of the
        # server's card and the comm counter families (rank-0 defaults so
        # the exposition always covers every group even single-machine)
        self.metrics = default_registry()
        obs_adapters.ensure_device_metrics(self.metrics, self.device)
        obs_adapters.ensure_comm_metrics(self.metrics)
        if self.fleet is not None:
            publish_fleet_metrics(self.metrics, self.fleet)
        # span timeline for the request lifecycle (enqueue -> micro-batch
        # -> device -> respond) when tpu_trace_path is set; flushed on
        # shutdown and harmless to leave armed
        self._tracing = obs_tracing.configure_from_config(cfg) is not None
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._start_t = time.time()

    # -- model lifecycle ---------------------------------------------- #
    def load_model(self, name: Optional[str] = None,
                   model_str: Optional[str] = None,
                   model_file: Optional[str] = None,
                   params: Optional[Dict] = None,
                   checkpoint_dir: Optional[str] = None) -> ModelEntry:
        """Load/hot-swap a model under `name` onto the server's device and
        make it servable (its warmup launches KP1 at every bucket the
        device path can take; a build or launch failure raises)."""
        name = name or self.config.serve_model_name
        entry = self.registry.load(name, model_str=model_str,
                                   model_file=model_file, params=params,
                                   checkpoint_dir=checkpoint_dir)
        with self._lock:
            if name not in self._batchers:
                stats = ModelStats()
                self._stats[name] = stats
                cfg = self.config
                self._batchers[name] = MicroBatcher(
                    lambda X, _n=name: self._batch_predict(_n, X),
                    max_batch_rows=cfg.serve_max_batch_rows,
                    max_wait_ms=cfg.serve_batch_wait_ms,
                    max_queue_rows=cfg.serve_queue_rows,
                    timeout_ms=cfg.serve_request_timeout_ms,
                    stats=stats, name=name).start()
                self._breakers[name] = CircuitBreaker(
                    failure_threshold=cfg.tpu_serve_breaker_failures,
                    reset_s=cfg.tpu_serve_breaker_reset_s)
                obs_adapters.publish_model_stats(
                    self.metrics, name, stats,
                    queue_depth_fn=self._batchers[name].queue_depth_rows)
                obs_adapters.publish_breaker_metrics(
                    self.metrics, name, self._breakers[name])
                if self._quota is not None:
                    obs_adapters.publish_quota_metrics(
                        self.metrics, name, self._quota)
        return entry

    def evict_model(self, name: str) -> bool:
        existed = self.registry.evict(name)
        with self._lock:
            batcher = self._batchers.pop(name, None)
            self._stats.pop(name, None)
            self._breakers.pop(name, None)
        if batcher is not None:
            batcher.stop()
        self.detach_shadow(name)
        obs_adapters.unpublish_model_stats(self.metrics, name)
        return existed

    # -- shadow traffic ------------------------------------------------ #
    def attach_shadow(self, name: str, mirror: ShadowMirror) -> None:
        """Mirror `name`'s served batches onto a candidate (replacing
        any previous mirror).  The swap is one dict assignment — traffic
        already in `_batch_predict` finishes on whichever mirror it
        resolved."""
        with self._lock:
            old = self._shadows.get(name)
            self._shadows[name] = mirror
        if old is not None:
            old.stop()

    def detach_shadow(self, name: str):
        with self._lock:
            mirror = self._shadows.pop(name, None)
        if mirror is not None:
            mirror.stop()
        return mirror

    # -- predict path -------------------------------------------------- #
    def _batch_predict(self, name: str, X: np.ndarray) -> np.ndarray:
        """The batcher's dispatch fn: resolve the CURRENT version at
        batch time (hot-swaps apply to the very next batch) and record
        which path the batch rode.  The circuit breaker guards the
        dispatch: while OPEN, batches ride the host walk — plain NumPy,
        no kernel, always available — so a sick device path turns
        into slower answers instead of an error storm; both the breaker's
        batches and the failures are counted.  A kernel that fails to build
        or launch (KernelError) is no device fault the breaker may hide:
        it raises to the batch's callers, uncounted, and never opens the
        breaker."""
        entry = self.registry.get(name)
        stats = self._stats.get(name)
        breaker = self._breakers.get(name)
        if breaker is not None and not breaker.allow():
            with self.profiler.phase("serve/breaker_host"):
                out = entry.booster._gbdt.predict(X, device=False)
            if stats is not None:
                stats.record_breaker_batch()
                stats.record_batch(X.shape[0], device=False)
            out = np.asarray(out)
            self._mirror(name, X, out)
            return out
        try:
            with self.profiler.phase("serve/batch_predict"):
                out, device = entry.predict(X)
        except KernelError:
            raise
        except Exception:
            if breaker is not None:
                breaker.record_failure()
                if breaker.state == CircuitBreaker.OPEN:
                    log.warning("serving: circuit breaker for %s OPENED "
                                "(%d consecutive failures); batches ride "
                                "the host path for %.1fs", name,
                                breaker.failure_threshold, breaker.reset_s)
            raise
        if breaker is not None:
            breaker.record_success()
        if stats is not None:
            stats.record_batch(X.shape[0], device)
        out = np.asarray(out)
        self._mirror(name, X, out)
        return out

    def _mirror(self, name: str, X: np.ndarray, out: np.ndarray) -> None:
        """Offer a finished batch to the shadow mirror.  The live `out`
        is already final — observe() copies, never blocks and never
        raises, so the served response is bitwise mirror-independent."""
        shadow = self._shadows.get(name)
        if shadow is None:
            return
        try:
            shadow.observe(X, out)
        except Exception as exc:  # noqa: BLE001 — shadow never hurts serving
            log.debug("shadow observe failed for %s: %s", name, exc)

    def predict(self, rows, model: Optional[str] = None,
                timeout_ms: Optional[float] = None) -> np.ndarray:
        """Blocking predict through the coalescing queue.  `rows` is
        [n, features] (a single 1-D row is auto-wrapped).  Returns the
        per-row outputs ([n] scores or [n, k] multiclass).  Thread-safe."""
        name = model or self.config.serve_model_name
        X = np.ascontiguousarray(np.asarray(rows, np.float64))
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError("rows must be [n, features] with n >= 1")
        if self._draining:
            # whole-server state, checked before the model lookup: a
            # drained server answers 503 even for evicted models
            raise DrainingError("server is draining for shutdown")
        with self._lock:
            batcher = self._batchers.get(name)
            stats = self._stats.get(name)
        if batcher is None:
            raise ModelNotFoundError(name)
        if self._quota is not None:
            # per-tenant quota BEFORE the global queue shed: a noisy
            # tenant sheds against its own token bucket instead of
            # filling the shared queue until everyone sheds
            retry_after = self._quota.try_admit(name)
            if retry_after is not None:
                stats.record_shed()
                raise ShedError(
                    "tenant %s over its %.1f qps admission quota" % (
                        name, self._quota.qps),
                    retry_after_s=retry_after)
        shed_rows = self.config.tpu_serve_shed_queue_rows
        if shed_rows > 0 and (batcher.queue_depth_rows() + X.shape[0]
                              > shed_rows):
            # shed at the door: the queue never grows past the watermark
            # and the client gets an explicit come-back-later hint
            stats.record_shed()
            raise ShedError(
                "shedding load: %d rows queued (+%d over the %d watermark)"
                % (batcher.queue_depth_rows(), X.shape[0], shed_rows),
                retry_after_s=self.config.tpu_serve_shed_retry_after_s)
        stats.record_request(X.shape[0])
        t0 = time.perf_counter()
        with obs_tracing.span("serve/request", "serve", rows=X.shape[0],
                              model=name):
            try:
                out = batcher.submit(X, timeout_ms=timeout_ms)
            except QueueFullError:
                # graceful degradation: saturated queue + small request ->
                # serve it on the host walk RIGHT NOW on this thread, so
                # overflow traffic degrades to host speed instead of
                # erroring (counted: host_fallback)
                if not (self.config.serve_host_fallback
                        and X.shape[0] <= self.config.serve_fallback_max_rows):
                    raise
                entry = self.registry.get(name)
                with self.profiler.phase("serve/host_fallback"):
                    out = entry.booster._gbdt.predict(X, device=False)
                stats.record_fallback()
                stats.record_batch(X.shape[0], device=False)
        stats.record_latency((time.perf_counter() - t0) * 1e3)
        return np.asarray(out)

    # -- observability ------------------------------------------------- #
    def stats_snapshot(self) -> Dict:
        with self._lock:
            stats = dict(self._stats)
            batchers = dict(self._batchers)
            breakers = {n: b.snapshot() for n, b in self._breakers.items()}
        return {
            "uptime_s": round(time.time() - self._start_t, 3),
            "draining": self._draining,
            "device": str(self.device),
            "models": {name: dict(s.snapshot(),
                                  queue_depth=batchers[name]
                                  .queue_depth_rows()
                                  if name in batchers else 0,
                                  breaker=breakers.get(name))
                       for name, s in stats.items()},
            "registry": self.registry.info(),
            "fleet": (self.fleet.snapshot()
                      if self.fleet is not None else None),
            "quota": (self._quota.snapshot()
                      if self._quota is not None else None),
            "phases": self.profiler.snapshot(),
        }

    def metrics_text(self) -> str:
        """The registry in Prometheus text exposition format 0.0.4
        (GET /metrics)."""
        return self.metrics.render_prometheus()

    # -- HTTP frontend ------------------------------------------------- #
    def serve_http(self, host: Optional[str] = None,
                   port: Optional[int] = None,
                   block: bool = True) -> ThreadingHTTPServer:
        host = host if host is not None else self.config.serve_host
        port = port if port is not None else self.config.serve_port
        httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        httpd.daemon_threads = True
        with self._lock:
            self._httpd = httpd
        bound = httpd.server_address
        log.info("serving on http://%s:%d (POST /predict, GET /stats, "
                 "GET /metrics)", bound[0], bound[1])
        if block:
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                log.info("interrupt: shutting down server")
            finally:
                self.shutdown()
        else:
            thread = threading.Thread(
                target=httpd.serve_forever, daemon=True,
                name="lgbm-serve-http")
            with self._lock:
                self._http_thread = thread
            thread.start()
        return httpd

    @property
    def http_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    # -- readiness + graceful drain ------------------------------------ #
    def is_ready(self) -> bool:
        """Readiness (GET /readyz): serving traffic is welcome — not
        draining and at least one model loaded.  Liveness (/livez) is
        unconditional: a draining server is alive, just not ready."""
        return not self._draining and bool(self.registry.names())

    def begin_drain(self) -> None:
        """Flip to draining: /readyz goes 503 (so load balancers stop
        sending), new predicts get DrainingError, queued + in-flight
        requests keep going."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            batchers = list(self._batchers.values())
        for b in batchers:
            b.begin_drain()
        log.info("serving: draining — no new work admitted, %d batcher(s) "
                 "finishing in-flight requests", len(batchers))

    def drain_and_shutdown(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful termination: drain every batcher within `timeout_s`
        (Config.tpu_serve_drain_timeout_s by default), then shut the
        HTTP frontend and workers down.  Returns True when every
        admitted request completed before the deadline."""
        if timeout_s is None:
            timeout_s = self.config.tpu_serve_drain_timeout_s
        self.begin_drain()
        deadline = time.perf_counter() + max(float(timeout_s), 0.0)
        with self._lock:
            batchers = list(self._batchers.values())
        clean = True
        for b in batchers:
            clean &= b.drain(max(deadline - time.perf_counter(), 0.0))
        if not clean:
            log.warning("serving: drain timed out after %.1fs; remaining "
                        "requests get BatcherStoppedError", timeout_s)
        self.shutdown()
        return clean

    def install_signal_handlers(self) -> bool:
        """SIGTERM -> drain_and_shutdown in a background thread (the
        handler itself must return immediately so serve_forever's accept
        loop keeps answering in-flight connections).  Returns False when
        not on the main thread (signals unavailable)."""
        import signal as signal_mod

        def on_term(signum, _frame):
            log.warning("serving: signal %d — starting graceful drain "
                        "(timeout %.1fs)", signum,
                        self.config.tpu_serve_drain_timeout_s)
            threading.Thread(target=self.drain_and_shutdown,
                             name="lgbm-serve-drain", daemon=True).start()

        try:
            signal_mod.signal(signal_mod.SIGTERM, on_term)
        except ValueError:
            return False
        return True

    def shutdown(self) -> None:
        with self._lock:
            httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        with self._lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
            shadows = list(self._shadows.values())
            self._shadows.clear()
        for b in batchers:
            b.stop()
        for s in shadows:
            s.stop()
        if self.fleet is not None:
            self.fleet.stop()
        with self._lock:
            tracing, self._tracing = self._tracing, False
        if tracing:
            try:
                path = obs_tracing.get_tracer().flush()
                if path:
                    log.info("trace: span timeline written to %s", path)
            except Exception as exc:  # noqa: BLE001 — teardown never raises
                log.warning("trace flush failed: %s", exc)


def _make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            log.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: Dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Dict:
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                return {}
            return json.loads(self.rfile.read(length).decode() or "{}")

        def _reply_text(self, code: int, body: str, content_type: str) -> None:
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._reply_text(200, server.metrics_text(),
                                 "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/stats":
                self._reply(200, server.stats_snapshot())
            elif path == "/models":
                self._reply(200, {"models": server.registry.info()})
            elif path in ("/healthz", "/health", "/livez"):
                # liveness: the process is up and answering — even while
                # draining (kill a live-but-draining pod and you abandon
                # its in-flight requests)
                self._reply(200, {"status": "ok",
                                  "models": server.registry.names()})
            elif path == "/fleet":
                if server.fleet is None:
                    self._reply(404, {"error": "no fleet residency manager "
                                      "(set tpu_fleet_hbm_budget_mb)"})
                else:
                    self._reply(200, server.fleet.snapshot())
            elif path == "/readyz":
                # readiness: route traffic here?  503 while draining or
                # model-less so load balancers rotate this replica out
                if server.is_ready():
                    self._reply(200, {"status": "ready",
                                      "models": server.registry.names()})
                else:
                    self._reply(503, {
                        "status": ("draining" if server._draining
                                   else "no models loaded")})
            else:
                self._reply(404, {"error": "unknown path %s" % path})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            try:
                payload = self._read_json()
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": "bad JSON: %s" % e})
                return
            try:
                if path == "/predict":
                    self._predict(payload)
                elif path == "/models/load":
                    self._load(payload)
                elif path == "/models/evict":
                    name = payload.get("name") or ""
                    self._reply(200 if server.evict_model(name) else 404,
                                {"name": name})
                else:
                    self._reply(404, {"error": "unknown path %s" % path})
            except ModelNotFoundError as e:
                self._reply(404, {"error": "unknown model %s" % e})
            except ShedError as e:
                self._reply(429, {"error": str(e)},
                            headers={"Retry-After": "%d" % max(
                                1, int(round(e.retry_after_s)))})
            except QueueFullError as e:
                self._reply(429, {"error": str(e)},
                            headers={"Retry-After": "%d" % max(1, int(round(
                                server.config.tpu_serve_shed_retry_after_s)))})
            except RequestTimeoutError as e:
                self._reply(504, {"error": str(e)})
            except KernelError as e:
                self._reply(500, {"error": str(e)})
            except (BatcherStoppedError, DrainingError) as e:
                self._reply(503, {"error": str(e)})
            except (ValueError, TypeError, log.LightGBMError) as e:
                self._reply(400, {"error": str(e)})

        def _predict(self, payload: Dict) -> None:
            rows = payload.get("rows")
            if rows is None and "row" in payload:
                rows = [payload["row"]]
            if rows is None:
                raise ValueError('payload needs "rows" ([[...], ...]) '
                                 'or "row" ([...])')
            name = payload.get("model") or server.config.serve_model_name
            out = server.predict(rows, model=name,
                                 timeout_ms=payload.get("timeout_ms"))
            version = server.registry.get(name).version
            self._reply(200, {"model": name, "version": version,
                              "predictions": np.asarray(out).tolist()})

        def _load(self, payload: Dict) -> None:
            name = payload.get("name") or server.config.serve_model_name
            entry = server.load_model(
                name, model_str=payload.get("model_str"),
                model_file=payload.get("model_file"))
            self._reply(200, {"model": name, "version": entry.version,
                              "info": entry.info()})

    return Handler
