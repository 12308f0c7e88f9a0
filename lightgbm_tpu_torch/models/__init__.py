"""Boosting model factory (lightgbm_tpu/models/__init__.py:9-22,
src/boosting/boosting.cpp:30-63).  Model text loads into a plain GBDT, as
in the JAX package (:25-31)."""
from __future__ import annotations

from ..utils import log
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF

_BOOSTING = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}


def create_boosting(config, train_set, objective, device):
    cls = _BOOSTING.get(config.boosting)
    if cls is None:
        log.fatal("Unknown boosting type %s" % config.boosting)
    return cls(config, train_set, objective, device)
