"""lightgbm_tpu_torch.serving — inference serving on the card.

A model registry with versioned hot-swap (registry.py), an adaptive
micro-batcher coalescing concurrent requests into one KP1 launch
(batcher.py), an in-process + stdlib-HTTP frontend (server.py), a
byte-accounted device-memory residency manager for multi-tenant fleets
(fleet.py), a shadow mirror for candidate models (shadow.py),
request-path observability (metrics.py) and a small client (client.py);
the port of lightgbm_tpu/serving, but for its replica sets (ROADMAP item
13b).
"""
from .admission import (CircuitBreaker, DrainingError,  # noqa: F401
                        ShedError, TenantQuota)
from .batcher import (BatcherStoppedError, MicroBatcher,  # noqa: F401
                      QueueFullError, RequestTimeoutError)
from .client import ServingClient, ServingError  # noqa: F401
from .fleet import (FleetFaultInjector,  # noqa: F401
                    HbmResidencyManager, ShapeBucketCache,
                    publish_fleet_metrics)
from .metrics import Histogram, ModelStats  # noqa: F401
from .registry import (ModelEntry, ModelNotFoundError,  # noqa: F401
                       ModelRegistry)
from .server import Server  # noqa: F401
from .shadow import ShadowMirror  # noqa: F401

__all__ = [
    "Server", "ServingClient", "ServingError",
    "ModelRegistry", "ModelEntry", "ModelNotFoundError",
    "MicroBatcher", "QueueFullError", "RequestTimeoutError",
    "BatcherStoppedError", "ModelStats", "Histogram",
    "CircuitBreaker", "DrainingError", "ShedError", "ShadowMirror",
    "TenantQuota", "HbmResidencyManager", "ShapeBucketCache",
    "FleetFaultInjector", "publish_fleet_metrics",
]
