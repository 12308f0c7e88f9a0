"""Training entry point (port of lightgbm_tpu/engine.py `train`, :29)."""
from __future__ import annotations

from typing import Any, Dict

from .basic import Booster, Dataset, LightGBMError
from .config import ALIAS_TABLE


def _pop_param(params: Dict[str, Any], canonical: str, default):
    """Pop a parameter under any of its config-table aliases."""
    out = default
    for name in [canonical] + [a for a, c in ALIAS_TABLE.items()
                               if c == canonical]:
        if name in params:
            out = params.pop(name)
    return out


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, device=None) -> Booster:
    """Train a booster for num_boost_round rounds (fewer when no leaf can
    split any more) on `device`: the CUDA card unless device="cpu"."""
    params = dict(params) if params else {}
    num_boost_round = int(_pop_param(params, "num_iterations", num_boost_round))
    if num_boost_round <= 0:
        raise LightGBMError("num_boost_round should be greater than zero.")
    booster = Booster(params=params, train_set=train_set, device=device)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
