"""Distributed tracing core: spans, W3C propagation, in-process collection.

A copy of ``kubeflow_tpu/obs/trace.py`` (the port imports nothing of the
JAX package): ``Span``/``SpanContext``, W3C ``traceparent`` parsing and
formatting, a bounded :class:`SpanCollector`, and :class:`Tracer` on an
injectable clock (``kubeflow_tpu_torch/utils/clock.py``). Span and trace
ids are random hex of the reference's widths, so a span recorded here and
one recorded by the JAX package read alike.

The profiler bridge (:func:`profiler_annotator`) mirrors live spans onto
the ``torch.profiler`` host timeline through
:func:`kubeflow_tpu_torch.utils.profiler.annotate`
(``torch.profiler.record_function``) instead of the XLA one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

from kubeflow_tpu_torch.utils.clock import Clock

TRACEPARENT_HEADER = "traceparent"
TRACESTATE_HEADER = "tracestate"
REQUEST_ID_HEADER = "X-Request-Id"

_HEXDIGITS = frozenset("0123456789abcdef")


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The propagated identity of a span: what crosses process/thread
    boundaries (everything else about a span stays local)."""

    trace_id: str   # 32 lowercase hex chars
    span_id: str    # 16 lowercase hex chars


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float
    end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "OK"

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_s": round(self.duration, 9),
            "attrs": dict(self.attrs),
            "status": self.status,
        }


# -- W3C traceparent propagation ---------------------------------------------


def format_traceparent(ctx: SpanContext, sampled: bool = True) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if sampled else '00'}"


def _hexfield(s: str, width: int) -> bool:
    return len(s) == width and set(s) <= _HEXDIGITS


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """``00-<32 hex>-<16 hex>-<2 hex>`` → context, else None.

    Strict on what the W3C spec makes strict: lowercase hex only,
    version ``ff`` invalid, all-zero trace/span ids invalid. Garbage and
    truncation degrade to None (the request simply starts a new trace)
    rather than raising — propagation must never fail a request.
    """
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if not _hexfield(version, 2) or version == "ff":
        return None
    # a version we don't know may append fields; version 00 must not
    if version == "00" and len(parts) != 4:
        return None
    if not _hexfield(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _hexfield(span_id, 16) or span_id == "0" * 16:
        return None
    if not _hexfield(flags, 2):
        return None
    return SpanContext(trace_id, span_id)


Carrier = Union[Mapping[str, str], Iterable[Tuple[str, str]]]


def extract(carrier: Optional[Carrier]) -> Optional[SpanContext]:
    """Remote parent from an HTTP header mapping (any key casing) or an
    iterable of (key, value) pairs (gRPC invocation metadata)."""
    if carrier is None:
        return None
    items = carrier.items() if hasattr(carrier, "items") else carrier
    for key, value in items:
        if str(key).lower() == TRACEPARENT_HEADER:
            return parse_traceparent(value)
    return None


def inject(headers: Dict[str, str], ctx: SpanContext) -> Dict[str, str]:
    """Stamp ``traceparent`` into an outgoing HTTP header dict."""
    headers[TRACEPARENT_HEADER] = format_traceparent(ctx)
    return headers


def grpc_metadata(ctx: Optional[SpanContext] = None
                  ) -> Tuple[Tuple[str, str], ...]:
    """Outgoing gRPC metadata carrying the given (or current) span
    context; empty when there is nothing to propagate."""
    ctx = ctx if ctx is not None else current_context()
    if ctx is None:
        return ()
    return ((TRACEPARENT_HEADER, format_traceparent(ctx)),)


# -- collection --------------------------------------------------------------


class SpanCollector:
    """Thread-safe bounded ring buffer of finished spans.

    ``capacity`` bounds memory hard: a serving pod under sustained load
    keeps the most recent window and silently evicts the oldest — the
    incident-debugging window, not an archive (exporters snapshot)."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._spans: List[Span] = []
        self._next = 0          # ring write cursor
        self._seq = 0           # total records ever (eviction accounting)
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(span)
            else:
                self._spans[self._next] = span
                self._next = (self._next + 1) % self.capacity
            self._seq += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._seq

    def spans(self) -> List[Span]:
        """Snapshot, oldest first."""
        with self._lock:
            return self._spans[self._next:] + self._spans[:self._next]

    def trace(self, trace_id: str) -> List[Span]:
        """Every retained span of one trace, sorted by (start, record
        order) so parents precede the children they enclose."""
        return sorted((s for s in self.spans() if s.trace_id == trace_id),
                      key=lambda s: (s.start, s.end if s.end is not None
                                     else s.start))

    def roots(self, limit: int = 50) -> List[Span]:
        """Most recent local root spans (no parent), newest first."""
        roots = [s for s in self.spans() if s.parent_id is None]
        return list(reversed(roots))[:limit]

    def summary(self, limit: int = 50) -> List[Dict[str, Any]]:
        """The dashboard's trace list: recent roots + per-trace span
        counts, newest first."""
        spans = self.spans()
        counts: Dict[str, int] = {}
        for s in spans:
            counts[s.trace_id] = counts.get(s.trace_id, 0) + 1
        out = []
        for root in reversed([s for s in spans if s.parent_id is None]):
            if len(out) >= limit:
                break
            d = root.to_dict()
            d["spans"] = counts.get(root.trace_id, 1)
            out.append(d)
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self._next = 0


DEFAULT_COLLECTOR = SpanCollector()

# the active span of this execution context (copied across
# threads/tasks by contextvars semantics only when explicitly carried)
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("kftpu_current_span", default=None)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_context() -> Optional[SpanContext]:
    sp = _CURRENT.get()
    return sp.context() if sp is not None else None


def profiler_annotator():
    """An annotator bridging live spans onto the ``torch.profiler`` host
    timeline via :func:`kubeflow_tpu_torch.utils.profiler.annotate`,
    resolved lazily on the first span."""
    state: Dict[str, Any] = {}

    def annotate(name: str):
        fn = state.get("fn")
        if fn is None:
            from kubeflow_tpu_torch.utils.profiler import annotate as fn
            state["fn"] = fn
        return fn(name)

    return annotate


class Tracer:
    """Produces spans into a collector on an injectable clock.

    One module-level :data:`TRACER` (shared collector, real clock)
    serves the common case; components with their own injected clock
    (decode engine, workflow controller) construct a private tracer over
    the same collector so their span timestamps stay deterministic
    under a fake clock.
    """

    def __init__(self, collector: Optional[SpanCollector] = None,
                 clock: Optional[Clock] = None,
                 annotator=None) -> None:
        # None = the module DEFAULT_COLLECTOR, resolved at record time
        # (dynamically, so every default-constructed tracer in the
        # process — proxy, server, engines — shares one buffer, and
        # tests can swap it in one place)
        self._collector = collector
        self.clock: Clock = clock if clock is not None else time.monotonic
        # annotator(name) -> context manager entered for each LIVE span
        # (the profiler bridge); None = spans only
        self.annotator = annotator

    @property
    def collector(self) -> SpanCollector:
        return (self._collector if self._collector is not None
                else DEFAULT_COLLECTOR)

    @collector.setter
    def collector(self, value: Optional[SpanCollector]) -> None:
        self._collector = value

    # -- span lifecycle ----------------------------------------------------

    def start_span(self, name: str, *,
                   attrs: Optional[Dict[str, Any]] = None,
                   parent: Optional[Union[Span, SpanContext]] = None,
                   remote: Optional[SpanContext] = None) -> Span:
        """``remote`` (an extracted wire context) wins over ``parent``
        wins over the context-local current span; no parent anywhere
        starts a new trace."""
        if remote is not None:
            trace_id, parent_id = remote.trace_id, remote.span_id
        elif parent is not None:
            ctx = parent.context() if isinstance(parent, Span) else parent
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        else:
            cur = current_span()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _rand_hex(16), None
        return Span(trace_id=trace_id, span_id=_rand_hex(8),
                    parent_id=parent_id, name=name, start=self.clock(),
                    attrs=dict(attrs or {}))

    def end_span(self, span: Span, status: Optional[str] = None) -> None:
        if span.end is None:
            span.end = self.clock()
        if status is not None:
            span.status = status
        self.collector.record(span)

    @contextlib.contextmanager
    def span(self, name: str, *,
             attrs: Optional[Dict[str, Any]] = None,
             parent: Optional[Union[Span, SpanContext]] = None,
             remote: Optional[SpanContext] = None):
        """Context-managed span: activates itself (children parent onto
        it), mirrors to the profiler timeline when bridged, marks
        status ERROR on exception, records on exit."""
        sp = self.start_span(name, attrs=attrs, parent=parent,
                             remote=remote)
        token = _CURRENT.set(sp)
        ann = (self.annotator(name) if self.annotator is not None
               else contextlib.nullcontext())
        try:
            with ann:
                yield sp
        except BaseException as e:
            sp.status = f"ERROR: {type(e).__name__}"
            raise
        finally:
            _CURRENT.reset(token)
            self.end_span(sp)

    def record(self, name: str, *, start: float, end: float,
               parent: Optional[Union[Span, SpanContext]] = None,
               attrs: Optional[Dict[str, Any]] = None,
               status: str = "OK",
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None) -> Span:
        """Record an already-completed span with explicit timestamps —
        the deterministic path for work whose boundaries the caller
        observed itself (engine queue wait, workflow step start/finish
        parsed from CR status). Explicit ``trace_id``/``span_id`` let a
        controller derive stable ids from object identity so spans from
        different reconcile passes land in one trace."""
        if parent is not None:
            ctx = parent.context() if isinstance(parent, Span) else parent
            tid, pid = ctx.trace_id, ctx.span_id
        else:
            tid, pid = trace_id if trace_id else _rand_hex(16), None
        if trace_id:
            tid = trace_id
        sp = Span(trace_id=tid,
                  span_id=span_id if span_id else _rand_hex(8),
                  parent_id=pid, name=name, start=start, end=end,
                  attrs=dict(attrs or {}), status=status)
        self.collector.record(sp)
        return sp


TRACER = Tracer()
