"""Prometheus-style metrics for the port: counters, gauges, histograms.

A trimmed copy of ``kubeflow_tpu/utils/metrics.py``: the registry, the
three metric kinds the engine, the server, the request ledger and the
step telemetry use, ``STEP_TIME_BUCKETS``, histogram exemplars (the
latest ``(trace id, value)`` per bucket, as OpenMetrics-style ``#
{trace_id="..."} v`` suffixes on the bucket lines) and the 0.0.4 text
exposition. Series names, help strings and label keys are the JAX
package's, so the edge poller scrapes a GPU replica unchanged.
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

    def expose(self, exemplars: bool = True) -> str:
        del exemplars  # histograms only; accepted for a uniform call
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

# train-step wall times: sub-10 ms steps through minutes-long stalls,
# which DEFAULT_BUCKETS would fold into +Inf
STEP_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


def _fmt_bound(b: float) -> str:
    return format(b, "g")


class Histogram(Metric):
    """Cumulative histogram with ``_bucket{le=...}``/``_sum``/``_count``
    exposition. ``observe(..., exemplar_trace_id=)`` keeps the latest
    observed ``(trace_id, value)`` per bucket, and the exposition
    suffixes that bucket's line with ``# {trace_id="..."} v``."""

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
        # per label set: bucket index -> latest (trace_id, value)
        self._exemplars: Dict[_Label, Dict[int, Tuple[str, float]]] = {}

    def observe(self, value: float,
                exemplar_trace_id: Optional[str] = None,
                **labels: str) -> None:
        key = self._key(labels)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.bounds) + 1)
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            if exemplar_trace_id:
                self._exemplars.setdefault(key, {})[idx] = (
                    str(exemplar_trace_id), float(value))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        raise TypeError(f"histogram {self.name!r}: use observe(), not inc()")

    def set(self, value: float, **labels: str) -> None:
        raise TypeError(f"histogram {self.name!r}: use observe(), not set()")

    def get(self, **labels: str) -> float:
        """Observation count for the label set (the ``_count`` series)."""
        with self._lock:
            return float(sum(self._counts.get(self._key(labels), ())))

    def expose(self, exemplars: bool = True) -> str:
        """``exemplars=False`` omits the exemplar suffixes, which the
        classic 0.0.4 text parser rejects."""
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted((k, list(v), self._sums.get(k, 0.0),
                            dict(self._exemplars.get(k, {})))
                           for k, v in self._counts.items())
        for key, counts, total, bucket_exemplars in items:
            base = format_labels(key)
            acc = 0
            les = [_fmt_bound(b) for b in self.bounds] + ["+Inf"]
            for i, (le, n) in enumerate(zip(les, counts)):
                acc += n
                lbl = (base + "," if base else "") + f'le="{le}"'
                line = f"{self.name}_bucket{{{lbl}}} {acc}"
                ex = bucket_exemplars.get(i) if exemplars else None
                if ex is not None:
                    line += (f' # {{trace_id="'
                             f'{escape_label_value(ex[0])}"}} {ex[1]}')
                lines.append(line)
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

    def expose(self, exemplars: bool = True) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.expose(exemplars=exemplars)
                         for m in metrics) + "\n"


DEFAULT_REGISTRY = Registry()

EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4"

# exemplar suffixes are valid in neither the classic 0.0.4 text format
# nor strict OpenMetrics: an HTTP endpoint sends them only to a scraper
# that asks for them with this header (the reference's policy)
EXEMPLARS_HEADER = "X-Kftpu-Exemplars"


def wants_exemplars(headers: Mapping[str, str]) -> bool:
    """True when the request opts into the exemplar extension."""
    for k, v in headers.items():
        if str(k).lower() == EXEMPLARS_HEADER.lower():
            return str(v).strip().lower() in ("1", "true", "yes")
    return False


def exposition(registry: Registry,
               headers: Optional[Mapping[str, str]] = None
               ) -> Tuple[bytes, str]:
    """(body, content type) of an HTTP ``/metrics`` response: classic
    0.0.4 unless the scraper requested the exemplar extension."""
    body = registry.expose(
        exemplars=wants_exemplars(headers or {})).encode()
    return body, EXPOSITION_CONTENT_TYPE
