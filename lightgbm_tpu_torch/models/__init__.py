"""Boosting model factory (lightgbm_tpu/models/__init__.py:9-31,
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


def load_boosting_from_string(text: str, config, device):
    """A plain GBDT of model text on `device` (models/__init__.py:25-31):
    the text's first line names the submodel."""
    first = text.strip().split("\n", 1)[0].strip()
    gbdt = GBDT(config, None, None, device)
    if first not in ("tree",):
        log.warning("Unknown submodel type %s when loading model", first)
    gbdt.load_model_from_string(text)
    return gbdt
