"""lightgbm_tpu_torch.resilience — the retry and fault-injection pieces the
serving fleet uses (resilience/comm.py); checkpoints, the supervisor and
the elastic world are ROADMAP item 14."""
from .comm import CommFailure, FaultInjector, RetryPolicy  # noqa: F401

__all__ = ["CommFailure", "FaultInjector", "RetryPolicy"]
