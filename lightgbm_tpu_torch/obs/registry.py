# Copied from lightgbm_tpu/obs/registry.py; its code kept in step with it (docstrings
# and comments aside) by tests/test_torch_obs_serving.py.
"""Unified metrics registry: counters / gauges / histograms + Prometheus text.

One thread-safe home for every number the framework emits — the training
driver, the serving request path, the distributed comm layer and the
device probe all report through the same API, so `GET /metrics` and the
end-of-training dump render ONE coherent snapshot instead of three
disconnected half-measures (utils/profiling, serving/metrics, nothing
for comm).  The reference has no analogue; the closest prior art is the
TIMETAG timers (serial_tree_learner.cpp:15-42), which stay as the
per-phase half (utils/profiling.Profiler) and feed this layer.

Design notes:
- a metric FAMILY is (name, kind, help); CHILDREN are label-sets within
  the family.  Asking for the same (name, labels) twice returns the
  same handle, so instrumentation sites never coordinate.
- gauges and counters accept `set_fn(fn)`: the value is pulled at
  collect/render time, which lets /metrics scrape live state (queue
  depth, live device buffers) without a refresh thread.
- histograms can be pre-built and `attach`ed, so serving's per-model
  latency/batch-size histograms render live without double accounting.
- rendering is the Prometheus text format 0.0.4: # HELP / # TYPE,
  cumulative `_bucket{le=...}` + `_sum` + `_count` for histograms,
  deterministic (sorted) output so golden tests can diff it.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class Histogram:
    """Fixed-boundary histogram with percentile estimation.

    observe() is O(log buckets); percentile() linearly interpolates
    inside the winning bucket (Prometheus histogram_quantile style), so
    p50/p99 come out of bounded memory without storing samples.  The
    interpolated estimate is clamped into [min, max] of the observed
    values: with a single occupied bucket (or a single sample) the raw
    interpolation would invent values between the observation and a
    far-away bucket edge.
    """

    kind = "histogram"

    def __init__(self, bounds: Sequence[float]):
        self.bounds: List[float] = sorted(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.counts[bisect.bisect_left(self.bounds, v)] += 1
            self.n += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.n = 0
            self.total = 0.0
            self.min = None
            self.max = None

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (q in [0, 100]); None when empty."""
        with self._lock:
            if self.n == 0:
                return None
            rank = q / 100.0 * self.n
            seen = 0
            est = self.max
            for i, c in enumerate(self.counts):
                if seen + c >= rank and c > 0:
                    lo = self.bounds[i - 1] if i > 0 else (self.min or 0.0)
                    hi = self.bounds[i] if i < len(self.bounds) else \
                        (self.max if self.max is not None else lo)
                    frac = (rank - seen) / c
                    est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                    break
                seen += c
            # clamp into the observed range: a single-bucket histogram
            # must report the bucket's real content, not the bucket edge
            if est is not None:
                if self.min is not None:
                    est = max(est, self.min)
                if self.max is not None:
                    est = min(est, self.max)
            return est

    def snapshot(self) -> Dict:
        return {
            "count": self.n,
            "sum": round(self.total, 6),
            "mean": round(self.total / self.n, 6) if self.n else None,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "buckets": {
                ("le_%g" % self.bounds[i]) if i < len(self.bounds)
                else "inf": c
                for i, c in enumerate(self.counts) if c
            },
        }

    def cumulative_buckets(self) -> List[Tuple[str, int]]:
        """[(le_label, cumulative_count)] ending with '+Inf' — the
        Prometheus bucket wire form."""
        with self._lock:
            out: List[Tuple[str, int]] = []
            acc = 0
            for i, b in enumerate(self.bounds):
                acc += self.counts[i]
                out.append(("%g" % b, acc))
            acc += self.counts[-1]
            out.append(("+Inf", acc))
            return out


class Counter:
    """Monotonically increasing value; name SHOULD end in `_total`."""

    kind = "counter"

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set_fn(self, fn: Optional[Callable[[], float]]) -> "Counter":
        """Pull the value from `fn` at collect time instead of inc()."""
        with self._lock:
            self._fn = fn
        return self

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a probe must not kill a scrape
                return 0.0
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value, settable or pulled via set_fn."""

    kind = "gauge"

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_fn(self, fn: Optional[Callable[[], float]]) -> "Gauge":
        with self._lock:
            self._fn = fn
        return self

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001
                return 0.0
        with self._lock:
            return self._value


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        # sorted (k, v) label tuple -> Counter | Gauge | Histogram
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return "%d" % int(v)
    return repr(float(v))


class MetricsRegistry:
    """Thread-safe name -> family -> labeled children store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- creation ------------------------------------------------------ #
    def _child(self, name: str, kind: str, help_text: str,
               labels: Dict[str, object], factory):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_text)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    "metric %s already registered as %s, asked for %s"
                    % (name, fam.kind, kind))
            elif help_text and not fam.help:
                fam.help = help_text
            key = _label_key(labels)
            child = fam.children.get(key)
            if child is None:
                child = factory()
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, bounds: Sequence[float] = (),
                  help: str = "", **labels) -> Histogram:
        return self._child(name, "histogram", help, labels,
                           lambda: Histogram(bounds))

    def attach(self, name: str, metric, help: str = "", **labels):
        """Register a pre-built Counter/Gauge/Histogram under (name,
        labels), replacing any existing child — serving attaches its
        live per-model histograms this way."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, metric.kind, help)
                self._families[name] = fam
            elif fam.kind != metric.kind:
                raise ValueError(
                    "metric %s already registered as %s, asked for %s"
                    % (name, fam.kind, metric.kind))
            fam.children[_label_key(labels)] = metric
            return metric

    # -- removal / reset ----------------------------------------------- #
    def remove(self, name: Optional[str] = None, **labels) -> int:
        """Remove children matching `labels` (subset match) from the
        named family, or from every family when name is None.  Empty
        families are dropped.  Returns the number of children removed."""
        removed = 0
        match = {k: str(v) for k, v in labels.items()}
        with self._lock:
            names = [name] if name is not None else list(self._families)
            for n in names:
                fam = self._families.get(n)
                if fam is None:
                    continue
                for key in list(fam.children):
                    kv = dict(key)
                    if all(kv.get(k) == v for k, v in match.items()):
                        del fam.children[key]
                        removed += 1
                if not fam.children:
                    del self._families[n]
        return removed

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- read side ----------------------------------------------------- #
    def get(self, name: str, **labels):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.children.get(_label_key(labels))

    def family_sum(self, name: str) -> Optional[float]:
        """Sum of every child's value in a counter/gauge family — the
        cheap cumulative read the per-iteration recorder wants (collect()
        would compute histogram percentiles it doesn't need)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind == "histogram":
                return None
            children = list(fam.children.values())
        return sum(c.value for c in children)

    def collect(self) -> Dict[str, Dict]:
        """Machine-readable snapshot: {name: {kind, help, values:
        [(labels_dict, value-or-histogram-snapshot), ...]}}."""
        with self._lock:
            fams = [(f.name, f.kind, f.help, list(f.children.items()))
                    for f in self._families.values()]
        out: Dict[str, Dict] = {}
        for name, kind, help_text, children in sorted(fams):
            vals = []
            for key, child in sorted(children):
                labels = dict(key)
                if kind == "histogram":
                    vals.append((labels, child.snapshot()))
                else:
                    vals.append((labels, child.value))
            out[name] = {"kind": kind, "help": help_text, "values": vals}
        return out

    def render_prometheus(self) -> str:
        """The full registry in Prometheus text exposition format 0.0.4."""
        with self._lock:
            fams = [(f.name, f.kind, f.help, list(f.children.items()))
                    for f in self._families.values()]
        lines: List[str] = []
        for name, kind, help_text, children in sorted(fams):
            if help_text:
                lines.append("# HELP %s %s" % (name, help_text))
            lines.append("# TYPE %s %s" % (name, kind))
            for key, child in sorted(children):
                base = _render_labels(key)
                if kind == "histogram":
                    for le, acc in child.cumulative_buckets():
                        bl = _render_labels(key + (("le", le),))
                        lines.append("%s_bucket%s %d" % (name, bl, acc))
                    lines.append("%s_sum%s %s"
                                 % (name, base, _fmt_value(child.total)))
                    lines.append("%s_count%s %d" % (name, base, child.n))
                else:
                    lines.append("%s%s %s"
                                 % (name, base, _fmt_value(child.value)))
        return "\n".join(lines) + ("\n" if lines else "")


def _render_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape_label(v))
                             for k, v in key)
