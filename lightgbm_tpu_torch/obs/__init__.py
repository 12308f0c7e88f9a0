"""lightgbm_tpu_torch.obs — the port's telemetry layer, as far as serving
reads it (lightgbm_tpu/obs/__init__.py is the whole layer):

- registry:  thread-safe MetricsRegistry of counters / gauges /
             histograms with Prometheus text exposition;
- tracing:   SpanTracer — nested-span timeline emitted as Chrome
             trace-event JSON (Config.tpu_trace_path);
- device:    the caching allocator's live state and the kernels' build
             log on the card;
- adapters:  publishers wiring ModelStats, the circuit breakers, the
             quotas and the device probe into the registry;
- recorder:  the fleet's residency events (Config.tpu_telemetry_path).

The TrainingRecorder, the time series, alerts, federation and the cost
models are ROADMAP item 14.  The process-wide default registry is what
`GET /metrics` on the serving server renders.
"""
from __future__ import annotations

from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import SpanTracer, get_tracer

_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem publishes into."""
    return _default_registry


def reset_default_registry() -> MetricsRegistry:
    """Clear the default registry (test isolation); the instance is kept
    so handles held by long-lived objects keep pointing at it."""
    _default_registry.reset()
    return _default_registry


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
           "default_registry", "get_tracer", "reset_default_registry"]
