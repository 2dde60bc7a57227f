"""Counters, gauges and histograms with the Prometheus text exporter —
the port's own copy of the registry half of ``corrosion_tpu/metrics.py``
(`Registry` and its families, the process-wide `REGISTRY`).

The flight recorder exports a finished run onto a registry
(`sim.telemetry.trace_to_registry`), and ``render()`` gives the text a
scrape would see, byte for byte as the JAX package renders it.  The HTTP
``MetricsServer`` there serves the host agent tier, which the port does
not carry.

Plain Python: nothing here touches a tensor or a device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: the default latency ladder, 1 ms … 60 s (seconds)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.010, 0.025, 0.050, 0.100, 0.250, 0.500,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: the serving-latency ladder, 100 µs … 10 s (seconds)
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.010, 0.025,
    0.050, 0.100, 0.250, 0.500, 1.0, 2.5, 5.0, 10.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class Counter:
    kind = "counter"

    def __init__(self):
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        return self._values.get(_labelkey(labels), 0.0)

    def samples(self, name: str) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            f"{name}{_fmt_labels(k)} {_fmt_value(v)}" for k, v in items
        ] or [f"{name} 0"]


class Gauge:
    kind = "gauge"

    def __init__(self):
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels):
        with self._lock:
            self._values[_labelkey(labels)] = value

    def add(self, amount: float, **labels):
        key = _labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        return self._values.get(_labelkey(labels), 0.0)

    def samples(self, name: str) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            f"{name}{_fmt_labels(k)} {_fmt_value(v)}" for k, v in items
        ] or [f"{name} 0"]


class Histogram:
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels):
        key = _labelkey(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def samples(self, name: str) -> List[str]:
        with self._lock:
            snap = {
                k: (list(c), self._sums[k], self._totals[k])
                for k, c in self._counts.items()
            }
        out = []
        for key in sorted(snap):
            counts, total_sum, total = snap[key]
            for i, ub in enumerate(self.buckets):
                lk = key + (("le", _fmt_value(float(ub))),)
                out.append(f"{name}_bucket{_fmt_labels(lk)} {counts[i]}")
            lk = key + (("le", "+Inf"),)
            out.append(f"{name}_bucket{_fmt_labels(lk)} {total}")
            out.append(f"{name}_sum{_fmt_labels(key)} {_fmt_value(total_sum)}")
            out.append(f"{name}_count{_fmt_labels(key)} {total}")
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        return self._get(name, Histogram, lambda: Histogram(buckets))

    def _get(self, name: str, cls, factory=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory() if factory else cls()
                self._metrics[name] = m
            if not isinstance(m, cls):
                raise TypeError(f"metric {name} is {type(m).__name__}, not {cls.__name__}")
            return m

    def render(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.samples(name))
        return "\n".join(lines) + "\n"


#: the process-wide registry
REGISTRY = Registry()
