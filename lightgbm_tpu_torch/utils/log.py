# Copied from lightgbm_tpu/utils/log.py; kept in step with it by tests/test_torch_train.py.
"""Logging utilities.

TPU-native analogue of the reference logger (include/LightGBM/utils/log.h:20-103):
four levels (Fatal/Warning/Info/Debug), a registerable callback so host
applications (Python bindings, CLI) can reroute output, and CHECK helpers.

Routing: Info/Debug go to stdout, Warning/Fatal to stderr — a piped CLI
run (`task=predict ... > preds.tsv`) must not have warnings corrupting
its output stream.  An opt-in structured mode (set_json_mode) emits one
JSON object per line with bound context fields (bind_context: rank,
model, iteration, ...) for log aggregators; the registered callback, when
set, receives the formatted line for either mode.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Dict, Optional

FATAL = -1
WARNING = 0
INFO = 1
DEBUG = 2

_LEVELS_BY_NAME = {
    "fatal": FATAL,
    "warning": WARNING, "warn": WARNING,
    "info": INFO,
    "debug": DEBUG,
}

_level = INFO
_callback: Optional[Callable[[str], None]] = None
_json_mode = False
_context: Dict[str, Any] = {}


class LightGBMError(RuntimeError):
    """Raised where the reference calls Log::Fatal (utils/log.h:70)."""


def set_level(level: int) -> None:
    global _level
    _level = level


def get_level() -> int:
    return _level


def set_level_by_name(name: str) -> None:
    """Set the level from its name ("debug" | "info" | "warning" |
    "fatal", case-insensitive; "warn" accepted)."""
    level = _LEVELS_BY_NAME.get(str(name).strip().lower())
    if level is None:
        fatal("Unknown log level %r (expected one of %s)"
              % (name, ", ".join(sorted(set(_LEVELS_BY_NAME)))))
    set_level(level)


def set_callback(cb: Optional[Callable[[str], None]]) -> None:
    global _callback
    _callback = cb


def set_json_mode(enabled: bool = True) -> None:
    """Structured mode: every line becomes one JSON object with ts /
    level / msg plus any bound context fields."""
    global _json_mode
    _json_mode = bool(enabled)


def get_json_mode() -> bool:
    return _json_mode


def bind_context(**fields) -> None:
    """Attach fields (rank, model, iteration, ...) to every subsequent
    JSON-mode line; a None value unbinds that field."""
    for k, v in fields.items():
        if v is None:
            _context.pop(k, None)
        else:
            _context[k] = v


def clear_context() -> None:
    _context.clear()


def _write(level_str: str, msg: str) -> None:
    if _json_mode:
        rec: Dict[str, Any] = {"ts": round(time.time(), 3),
                               "level": level_str.lower(), "msg": msg}
        rec.update(_context)
        line = json.dumps(rec, default=str) + "\n"
    else:
        line = "[LightGBM-TPU] [%s] %s\n" % (level_str, msg)
    if _callback is not None:
        _callback(line)
    else:
        stream = sys.stderr if level_str in ("Warning", "Fatal") else sys.stdout
        stream.write(line)
        stream.flush()


def debug(msg: str, *args) -> None:
    if _level >= DEBUG:
        _write("Debug", msg % args if args else msg)


def info(msg: str, *args) -> None:
    if _level >= INFO:
        _write("Info", msg % args if args else msg)


def warning(msg: str, *args) -> None:
    if _level >= WARNING:
        _write("Warning", msg % args if args else msg)


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    _write("Fatal", text)
    raise LightGBMError(text)


def check(condition: bool, msg: str = "Check failed") -> None:
    if not condition:
        fatal(msg)
