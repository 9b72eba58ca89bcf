"""Prometheus-style metrics for the port: counters, gauges, histograms.

A trimmed copy of ``kubeflow_tpu/utils/metrics.py``: the registry, the
three metric kinds the engine and server use, and the classic 0.0.4
text exposition (the port records no trace exemplars yet). Series
names, help strings and label keys are the JAX package's, so the edge
poller scrapes a GPU replica unchanged.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

_Label = Tuple[Tuple[str, str], ...]


def escape_label_value(value: str) -> str:
    """Text-format label-value escaping: backslash, quote, line feed."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(key: _Label) -> str:
    return ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key)


class Metric:
    def __init__(self, name: str, help_: str, kind: str) -> None:
        self.name = name
        self.help = help_
        self.kind = kind
        self._values: Dict[_Label, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Optional[Mapping[str, str]]) -> _Label:
        return tuple(sorted((labels or {}).items()))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        with self._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def get(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key, val in sorted(self._values.items()):
                if key:
                    lines.append(f"{self.name}{{{format_labels(key)}}} {val}")
                else:
                    lines.append(f"{self.name} {val}")
        return "\n".join(lines)


DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt_bound(b: float) -> str:
    return format(b, "g")


class Histogram(Metric):
    """Cumulative histogram with ``_bucket{le=...}``/``_sum``/``_count``
    exposition."""

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help_, "histogram")
        bounds = sorted(set(float(b) for b in buckets))
        if bounds and bounds[-1] == float("inf"):
            bounds.pop()
        if not bounds:
            raise ValueError("histogram needs a finite bucket bound")
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self._counts: Dict[_Label, List[int]] = {}
        self._sums: Dict[_Label, float] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.bounds) + 1)
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        raise TypeError(f"histogram {self.name!r}: use observe(), not inc()")

    def set(self, value: float, **labels: str) -> None:
        raise TypeError(f"histogram {self.name!r}: use observe(), not set()")

    def get(self, **labels: str) -> float:
        """Observation count for the label set (the ``_count`` series)."""
        with self._lock:
            return float(sum(self._counts.get(self._key(labels), ())))

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted((k, list(v), self._sums.get(k, 0.0))
                           for k, v in self._counts.items())
        for key, counts, total in items:
            base = format_labels(key)
            acc = 0
            les = [_fmt_bound(b) for b in self.bounds] + ["+Inf"]
            for le, n in zip(les, counts):
                acc += n
                lbl = (base + "," if base else "") + f'le="{le}"'
                lines.append(f"{self.name}_bucket{{{lbl}}} {acc}")
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {total}")
            lines.append(f"{self.name}_count{suffix} {acc}")
        return "\n".join(lines)


class Registry:
    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Metric:
        return self._register(name, help_, "counter")

    def gauge(self, name: str, help_: str = "") -> Metric:
        return self._register(name, help_, "gauge")

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(  # type: ignore[return-value]
            name, help_, "histogram",
            factory=lambda: Histogram(name, help_,
                                      buckets if buckets is not None
                                      else DEFAULT_BUCKETS))

    def _register(self, name: str, help_: str, kind: str,
                  factory=None) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {kind}")
                return existing
            self._metrics[name] = (factory() if factory is not None
                                   else Metric(name, help_, kind))
            return self._metrics[name]

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.expose() for m in metrics) + "\n"


DEFAULT_REGISTRY = Registry()

EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4"
