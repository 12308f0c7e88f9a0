# Copied from lightgbm_tpu/obs/recorder.py (fleet_event and its JSON
# encoder); the TrainingRecorder and the other events wait for ROADMAP
# item 14.
"""Structured JSONL telemetry: the serving fleet's residency events."""
from __future__ import annotations

import json

from ..utils import log


def _json_default(o):
    if hasattr(o, "item") and not hasattr(o, "__len__"):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


def fleet_event(config, what: str, **fields) -> None:
    """Append one fleet-residency event ({"event": "fleet", "what":
    "admit"|"spill"|"promote"|"demote"|"degrade"|"spill_corrupt"|
    "oversize"|"release", "model": ..., ...}) to
    Config.tpu_telemetry_path.  The residency manager spans every tenant
    of a serving process (a spill is caused by one model and suffered by
    another), so it appends directly — one JSON object a line,
    best-effort."""
    path = getattr(config, "tpu_telemetry_path", "")
    if not path:
        return
    event = {"event": "fleet", "what": str(what)}
    event.update(fields)
    try:
        with open(path, "a") as f:
            f.write(json.dumps(event, default=_json_default,
                               separators=(",", ":")) + "\n")
    except Exception as exc:  # noqa: BLE001 — telemetry never raises
        log.warning("telemetry: fleet event write to %s failed: %s",
                    path, exc)
