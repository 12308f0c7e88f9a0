# Copied from lightgbm_tpu/obs/adapters.py (COMM_COUNTERS,
# ensure_comm_metrics, publish_model_stats, publish_breaker_metrics,
# publish_quota_metrics, unpublish_model_stats); ensure_device_metrics is
# the card's.  publish_replica_metrics waits with the replica sets (ROADMAP
# item 13b), the elastic and hybrid gauges with items 12 and 14.
"""Glue between the metrics registry and the subsystems that feed it.

Each publisher registers set_fn-backed children, so a /metrics scrape
pulls LIVE values from the owning object (ModelStats, the circuit
breaker, the quota, the caching allocator) — no refresh thread, no double
accounting, and eviction removes exactly the evicted model's children.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from . import device as device_mod
from .registry import MetricsRegistry

COMM_COUNTERS = (
    ("lgbm_comm_bytes_sent_total", "Bytes written to comm sockets"),
    ("lgbm_comm_bytes_received_total", "Bytes read from comm sockets"),
    ("lgbm_comm_allgather_total", "Allgather rounds completed"),
    ("lgbm_comm_sync_wait_seconds_total",
     "Seconds blocked waiting on comm peers"),
    ("lgbm_comm_retries_total",
     "Comm operations retried after a transient failure"),
    ("lgbm_comm_failures_total",
     "Comm operations aborted after exhausting the retry budget"),
)


def ensure_device_metrics(reg: MetricsRegistry, device=None) -> None:
    """Device gauges and build counters of `device`, pulled live at scrape
    time, under the JAX package's names where the quantity exists on the
    card (obs/device.py).  XLA's jaxpr traces, pjit cache entries and cost
    analyses (lgbm_xla_traces_total, lgbm_jit_cache_entries,
    lgbm_xla_cost_analyses_total) have no counterpart and are not
    registered."""
    reg.gauge("lgbm_device_live_buffers",
              help="Live device allocations").set_fn(
        lambda: device_mod.device_stats(device)["live_buffers"])
    reg.gauge("lgbm_device_live_bytes",
              help="Bytes held by live device allocations").set_fn(
        lambda: device_mod.device_stats(device)["live_bytes"])
    reg.gauge("lgbm_xla_peak_hbm_bytes",
              help="High-water mark of the device bytes allocated "
                   "(the caching allocator's)").set_fn(
        lambda: device_mod.device_stats(device)["peak_bytes"])
    reg.counter("lgbm_xla_backend_compiles_total",
                help="Kernel sources compiled (nvcc runs)").set_fn(
        lambda: device_mod.compile_counts()["backend_compiles"])
    reg.counter("lgbm_xla_cache_hits_total",
                help="Kernel sources found already built").set_fn(
        lambda: device_mod.compile_counts()["cache_hits"])


def ensure_comm_metrics(reg: MetricsRegistry, rank: int = 0,
                        world: int = 1,
                        backend: str = "socket") -> Dict[str, object]:
    """Create the comm counter families for (rank, world) — SocketComm
    calls this with its real coordinates; MeshCollective calls it with
    backend="mesh" so in-process collective traffic stays separable from
    wire traffic; the serving server calls it with the (0, 1) defaults
    so /metrics always exposes the families.  comm_totals() sums across
    backends (family_sum is label-agnostic)."""
    labels = dict(rank=str(rank), world=str(world), backend=str(backend))
    # names audited in the COMM_COUNTERS table above
    return {name: reg.counter(name, help=help_text, **labels)  # tpulint: ok=metrics-dynamic-name
            for name, help_text in COMM_COUNTERS}


def publish_model_stats(reg: MetricsRegistry, name: str, stats,
                        queue_depth_fn: Optional[Callable[[], int]] = None
                        ) -> None:
    """Expose one serving ModelStats through the registry, labeled
    model=<name>.  Counters pull the live attribute; histograms attach
    the stats' own instances so observations render without copying."""
    def pull(attr: str) -> Callable[[], float]:
        return lambda: getattr(stats, attr)

    reg.counter("lgbm_serve_requests_total",
                help="Requests admitted", model=name).set_fn(pull("requests"))
    reg.counter("lgbm_serve_rows_total",
                help="Rows predicted", model=name).set_fn(pull("rows"))
    reg.counter("lgbm_serve_batches_total",
                help="Coalesced batch dispatches", model=name,
                path="device").set_fn(pull("device_batches"))
    reg.counter("lgbm_serve_batches_total", model=name,
                path="host").set_fn(pull("host_batches"))
    reg.counter("lgbm_serve_host_fallback_total",
                help="Overflow requests served on the host walk",
                model=name).set_fn(pull("host_fallback"))
    reg.counter("lgbm_serve_rejected_total",
                help="Queue-full rejections",
                model=name).set_fn(pull("rejected_queue_full"))
    reg.counter("lgbm_serve_shed_total",
                help="Requests shed by admission control (429+Retry-After)",
                model=name).set_fn(pull("shed"))
    reg.counter("lgbm_serve_breaker_batches_total",
                help="Batches forced host-side by an open circuit breaker",
                model=name).set_fn(pull("breaker_batches"))
    reg.counter("lgbm_serve_timeouts_total",
                help="Requests that missed their deadline",
                model=name).set_fn(pull("timeouts"))
    reg.counter("lgbm_serve_errors_total",
                help="Predict-path exceptions", model=name).set_fn(
        pull("errors"))
    reg.gauge("lgbm_serve_queue_depth_rows",
              help="Rows waiting in the batcher queue", model=name).set_fn(
        queue_depth_fn if queue_depth_fn is not None else pull("queue_depth"))
    reg.attach("lgbm_serve_latency_ms", stats.latency_ms,
               help="End-to-end request latency (ms)", model=name)
    reg.attach("lgbm_serve_batch_size", stats.batch_size,
               help="Rows per coalesced dispatch", model=name)
    reg.attach("lgbm_serve_wait_ms", stats.wait_ms,
               help="Queue wait before dispatch (ms)", model=name)


_BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


def publish_breaker_metrics(reg: MetricsRegistry, name: str,
                            breaker) -> None:
    """Per-tenant circuit-breaker exposition, labeled model=<name>: a
    state gauge (0 closed / 1 half-open / 2 open) and a trip counter.
    Before this, a circuit-broken tenant was only visible in the /stats
    JSON snapshot — /metrics scrapers could not attribute which tenant
    was riding the host walk without grepping logs."""
    reg.gauge("lgbm_serve_breaker_state",
              help="Circuit breaker state: 0 closed, 1 half-open, 2 open",
              model=name).set_fn(
        lambda: _BREAKER_STATE_CODE.get(breaker.state, -1))
    reg.counter("lgbm_serve_breaker_open_total",
                help="Times the circuit breaker tripped open",
                model=name).set_fn(lambda: breaker.open_count)


def publish_quota_metrics(reg: MetricsRegistry, name: str, quota) -> None:
    """Per-tenant admission-quota shed counter, labeled model=<name> —
    a quota-shed tenant is attributable in /metrics, separately from
    queue-depth sheds (lgbm_serve_shed_total counts both)."""
    reg.counter("lgbm_serve_quota_shed_total",
                help="Requests shed by the per-tenant admission quota "
                     "(429 + Retry-After)",
                model=name).set_fn(lambda: quota.shed_count(name))


def unpublish_model_stats(reg: MetricsRegistry, name: str) -> int:
    """Drop every child labeled model=<name> (model eviction) — serving
    stats, breaker and quota children alike."""
    return reg.remove(model=name)
