"""Process-wide metrics registry: counters, gauges, histograms.

A copy of the JAX package's ``telemetry/registry.py`` (which imports no
jax). The serving path increments named metrics; the ``/metrics`` endpoint
reads one deterministic snapshot. Collectors — callbacks registered with
``register_collector`` — inject point-in-time gauges (queue depth) only
when a snapshot/scrape actually happens.

Thread safety: metric creation is lock-guarded, and each metric guards
its own read-modify-write updates with a per-metric lock — the serving
path increments counters/histograms from many concurrent HTTP handler
and dispatcher threads, so GIL-interleavable ``value += n`` is not
enough. Histograms keep a bounded window of recent observations for
percentiles plus exact count/sum totals.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Tuple


def nearest_rank(sorted_vals, q: float):
    """Nearest-rank percentile (q in [0, 1]) over a sorted list — the one
    quantile definition shared by histograms and request tracing."""
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    rank = max(1, -(-int(q * 1000 * n) // 1000))  # ceil(q*n), int math
    return sorted_vals[min(n, rank) - 1]


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Prometheus exposition-format label escaping: backslash, quote,
    newline (label values are an open API — device names come from
    ``str(device)`` of an external library)."""
    return (v.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _format_labels(label_items) -> str:
    if not label_items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in label_items)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter (steps, examples, bytes)."""

    kind = "counter"

    def __init__(self, name: str, labels, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot_value(self):
        return self.value


class Gauge:
    """Point-in-time value (memory watermark, bubble fraction)."""

    kind = "gauge"

    def __init__(self, name: str, labels, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot_value(self):
        return self.value


class Histogram:
    """count/sum totals + a bounded window of recent observations for
    p50/p95/p99 (summary-style quantiles on scrape)."""

    kind = "histogram"

    def __init__(self, name: str, labels, help: str = "",
                 window: int = 2048):
        self.name = name
        self.labels = labels
        self.help = help
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window = collections.deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._window.append(v)

    def quantile(self, q: float) -> float:
        return nearest_rank(sorted(self._window), q)

    def snapshot_value(self):
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": self.total / self.count,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[tuple, object] = {}
        self._collectors: List[Callable] = []

    # -- creation (get-or-create; name+labels identify the series) ----------
    def _get(self, cls, name: str, labels: dict, help: str, **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, _label_key(labels), help=help, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "", window: int = 2048,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, help, window=window)

    # -- collectors ----------------------------------------------------------
    def register_collector(self, fn: Callable) -> Callable:
        """``fn(registry)`` runs before every snapshot/render (best-effort:
        a failing collector is skipped, never raises into a scrape).
        Idempotent by function identity."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def collect(self) -> None:
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:
                pass  # a probe must never break a scrape

    # -- export --------------------------------------------------------------
    def snapshot(self, run_collectors: bool = True) -> dict:
        """Deterministic ``{name{labels}: value}`` dict — sorted keys,
        plain-JSON values — identical for identical recorded data."""
        if run_collectors:
            self.collect()
        with self._lock:  # a scrape must not race a first-seen metric
            items = sorted(self._metrics.items())
        out = {}
        for (name, labels), m in items:
            out[name + _format_labels(labels)] = m.snapshot_value()
        return out

    def render_prometheus(self, run_collectors: bool = True) -> str:
        """Prometheus text exposition (counters/gauges natively;
        histograms as summary quantiles + _sum/_count)."""
        if run_collectors:
            self.collect()
        with self._lock:  # see snapshot(): scrape vs first-seen insert
            items = sorted(self._metrics.items())
        by_name: Dict[str, list] = {}
        for (name, _labels), m in items:
            by_name.setdefault(name, []).append(m)
        lines = []
        for name, metrics in by_name.items():
            kind = metrics[0].kind
            if metrics[0].help:
                lines.append(f"# HELP {name} {metrics[0].help}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for m in metrics:
                lbl = _format_labels(m.labels)
                if kind == "histogram":
                    base = dict(m.labels)
                    for q in (0.5, 0.95, 0.99):
                        ql = _format_labels(
                            _label_key(dict(base, quantile=q)))
                        lines.append(f"{name}{ql} {m.quantile(q):.9g}")
                    lines.append(f"{name}_sum{lbl} {m.total:.9g}")
                    lines.append(f"{name}_count{lbl} {m.count}")
                else:
                    lines.append(f"{name}{lbl} {m.snapshot_value():.9g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (collectors stay registered)."""
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()
