"""Request-lifecycle ledger: every serving request's wall clock, attributed.

A copy of ``kubeflow_tpu/obs/requests.py`` (the port imports nothing of
the JAX package). :class:`RequestLedger` carves each request's wall
clock, from edge admission (or engine submit, when no edge is in front)
to last token, into an exclusive, exhaustive phase set, and keeps the
last N folded records per model in a bounded ring.

**Phases** (:data:`PHASES`):

- ``queue_wait``   — submitted, waiting for an engine slot
- ``admission``    — edge classify/gate work, slot placement, page
  reservation, batch assembly (everything between queue and prefill)
- ``prefill``      — prompt prefill (chunk count recorded for the
  paged engine's chunked-prefill scheduler)
- ``decode``       — first token to last token; per-token emit
  timestamps are recorded, so inter-token latency is derivable
- ``kv_fault``     — paged-pool page-growth stalls carved out of decode
- ``weight_fault`` — multiplex cold-start (weight paging) stalls
- ``stream_stall`` — the client not draining the stream (carved out of
  decode by the streaming writer)
- ``shed``         — the edge's 503 path (the request's whole life is
  admission + shed; it never reaches an engine)

**Measurement discipline**: a finished record's phase intervals tile
``[t_start, t_end]`` EXACTLY — no gaps, no overlaps, seconds sum to the
wall clock. Base phases come from transition marks the serving hot
paths already take timestamps for; ``kv_fault``/``weight_fault``/
``stream_stall`` are *carve-outs*: recorded as stall windows and
subtracted from whatever base phase they overlap at fold time.

**Hot-path contract**: :meth:`RequestLedger.emit` is called once per
token from ``DecodeEngine._emit`` and takes the timestamp the engine
already read for the decode step — the ledger itself never reads a
clock on the emit path (one dict lookup + one list append under the
lock). Folding, histogram observation, and ring insertion all happen
once, at :meth:`finish`.

**Exports** (all labeled ``{model, slo_class}``; registered exactly
once here, under the reference's names):

- ``kftpu_request_ttft_ms``            — time to first token
- ``kftpu_request_itl_ms``             — inter-token latency (one
  observation per token gap)
- ``kftpu_request_phase_seconds{phase}`` — per-phase wall seconds
- ``kftpu_request_finished_total``     — finished records
- ``kftpu_request_ttft_breach_total``  — finished with TTFT over the
  class target (or no first token at all — shed and failed requests
  burn the budget too)

Records join across tiers by trace id: the engine's ``submit`` keys its
record by the trace id of the context it captures (the serving
handler's span, which continues the caller's ``traceparent``), so one
request is one record and one trace tree. Across process boundaries
each tier's ledger holds its own partial record; the trace tree still
joins in the collector.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY

# -- phase taxonomy ----------------------------------------------------------

QUEUE_WAIT = "queue_wait"
ADMISSION = "admission"
PREFILL = "prefill"
DECODE = "decode"
KV_FAULT = "kv_fault"
WEIGHT_FAULT = "weight_fault"
STREAM_STALL = "stream_stall"
SHED = "shed"

#: base phases — set by transition marks, in whatever order the tiers
#: visit them (an edge-fronted request goes admission -> queue_wait ->
#: admission -> prefill -> decode; phases may repeat and their seconds
#: accumulate)
BASE_PHASES = (QUEUE_WAIT, ADMISSION, PREFILL, DECODE, SHED)

#: carve-out phases — recorded as stall windows, subtracted from the
#: base phase they overlap at fold time
STALL_PHASES = (KV_FAULT, WEIGHT_FAULT, STREAM_STALL)

#: the exclusive, exhaustive phase set every record's seconds map over
PHASES = BASE_PHASES + STALL_PHASES

#: unlabeled traffic (an engine driven without an edge in front)
NO_SLO_CLASS = "none"

#: per-class TTFT targets (ms) the ``ttft-slo-burn`` rules and the
#: breach counter price against; keys match the edge's
#: ``DEFAULT_SLO_CLASSES`` (defined here, not imported — obs must not
#: depend on the edge tier)
TTFT_TARGETS_MS: Dict[str, float] = {
    "interactive": 500.0,
    "standard": 2000.0,
    "batch": 10000.0,
}
DEFAULT_TTFT_TARGET_MS = 2000.0

#: bounded per-model ring capacity (the FlightRecorder stance: recent
#: evidence, bounded memory)
DEFAULT_RING_CAPACITY = 256

#: live (unfinished) record bound — an edge whose backend hop crosses a
#: process boundary starts records its own process never finishes;
#: oldest-first eviction keeps the map from growing forever
DEFAULT_MAX_LIVE = 4096

# ms-scale buckets: TTFT spans "one prefill" (tens of ms on-chip) to
# "queued behind a burst" (tens of seconds); ITL is per decode step
TTFT_MS_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                   500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0)
ITL_MS_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                  500.0, 1000.0)
PHASE_SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                         10.0, 30.0, 60.0, 300.0)

_ttft_h = DEFAULT_REGISTRY.histogram(
    "kftpu_request_ttft_ms",
    "Time to first token per request (ms)", buckets=TTFT_MS_BUCKETS)
_itl_h = DEFAULT_REGISTRY.histogram(
    "kftpu_request_itl_ms",
    "Inter-token latency per decode-token gap (ms)",
    buckets=ITL_MS_BUCKETS)
_phase_h = DEFAULT_REGISTRY.histogram(
    "kftpu_request_phase_seconds",
    "Per-request wall seconds attributed to one lifecycle phase",
    buckets=PHASE_SECONDS_BUCKETS)
_finished_c = DEFAULT_REGISTRY.counter(
    "kftpu_request_finished_total",
    "Requests whose lifecycle record folded (served, shed, or failed)")
_breach_c = DEFAULT_REGISTRY.counter(
    "kftpu_request_ttft_breach_total",
    "Requests finishing over their SLO class's TTFT target (or "
    "without a first token at all)")


# -- records -----------------------------------------------------------------


@dataclasses.dataclass
class _LiveRequest:
    """One in-flight request's raw evidence (pre-fold)."""

    rid: str
    model: str
    slo_class: str
    t_start: float
    # transition marks, monotone by construction (mark() clamps): the
    # interval [marks[i].t, marks[i+1].t) carries marks[i]'s phase
    marks: List[Tuple[float, str]]
    stalls: List[Tuple[float, float, str]] = dataclasses.field(
        default_factory=list)
    emits: List[float] = dataclasses.field(default_factory=list)
    chunks: int = 0

    @property
    def last_t(self) -> float:
        return self.marks[-1][0]


@dataclasses.dataclass
class RequestRecord:
    """One finished request, folded: intervals tile [t_start, t_end]."""

    rid: str
    model: str
    slo_class: str
    t_start: float
    t_end: float
    intervals: List[Tuple[float, float, str]]
    seconds: Dict[str, float]
    emits: List[float]
    chunks: int
    ttft_ms: Optional[float]
    itl_ms: List[float]
    shed: bool
    breach: bool

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def tokens(self) -> int:
        return len(self.emits)

    @property
    def t_first_token(self) -> Optional[float]:
        return self.emits[0] if self.emits else None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rid": self.rid,
            "model": self.model,
            "sloClass": self.slo_class,
            "start": self.t_start,
            "end": self.t_end,
            "wallSeconds": round(self.wall_s, 9),
            "seconds": {p: round(s, 9) for p, s in
                        sorted(self.seconds.items())},
            "intervals": [
                {"phase": p, "start": a, "end": b,
                 "seconds": round(b - a, 9)}
                for a, b, p in self.intervals],
            "tokens": self.tokens,
            "chunks": self.chunks,
            "ttftMs": self.ttft_ms,
            "itlMs": [round(v, 6) for v in self.itl_ms],
            "shed": self.shed,
            "breach": self.breach,
        }


def _clip_merge_stalls(stalls: List[Tuple[float, float, str]],
                       t0: float, t1: float
                       ) -> List[Tuple[float, float, str]]:
    """Clip stall windows to [t0, t1], order them, and resolve overlaps
    (earlier-started stall wins the contested span) so the carve set is
    itself disjoint — a precondition for exact tiling."""
    out: List[Tuple[float, float, str]] = []
    for a, b, phase in sorted(stalls):
        a, b = max(a, t0), min(b, t1)
        if out:
            a = max(a, out[-1][1])  # truncate against the previous stall
        if b > a:
            out.append((a, b, phase))
    return out


def fold_record(live: _LiveRequest, t_end: float) -> RequestRecord:
    """Fold raw marks + stalls + emits into a tiling interval set.

    Base intervals come from consecutive transition marks (the last
    mark's phase runs to ``t_end``); each disjoint stall window splits
    whatever base interval(s) it overlaps. The result tiles
    ``[t_start, t_end]`` exactly: interval bounds are reused verbatim
    (never re-derived through arithmetic), so there are no gaps, no
    overlaps, and seconds sum to the wall clock to float precision.
    """
    t0 = live.t_start
    t_end = max(t_end, live.last_t, live.emits[-1] if live.emits else t0)
    # base edges: mark times + the terminal edge, zero-length runs kept
    # out (a mark at the same instant as its predecessor replaces
    # nothing — the later phase simply starts there)
    base: List[Tuple[float, float, str]] = []
    for i, (t, phase) in enumerate(live.marks):
        nxt = (live.marks[i + 1][0] if i + 1 < len(live.marks)
               else t_end)
        if nxt > t:
            base.append((t, nxt, phase))
    stalls = _clip_merge_stalls(live.stalls, t0, t_end)
    intervals: List[Tuple[float, float, str]] = []
    si = 0
    for a, b, phase in base:
        cur = a
        while si < len(stalls) and stalls[si][0] < b:
            sa, sb, sphase = stalls[si]
            if sb <= cur:
                si += 1
                continue
            sa = max(sa, cur)
            if sa > cur:
                intervals.append((cur, sa, phase))
            cut = min(sb, b)
            intervals.append((sa, cut, sphase))
            cur = cut
            if sb <= b:
                si += 1
            else:
                # the stall outlives this base interval: keep it for
                # the next one (its consumed head is tracked by cur)
                stalls[si] = (cut, sb, sphase)
                break
        if cur < b:
            intervals.append((cur, b, phase))
    # merge adjacent same-phase pieces (contiguity preserved: the merge
    # only ever joins intervals sharing an edge)
    merged: List[Tuple[float, float, str]] = []
    for iv in intervals:
        if merged and merged[-1][2] == iv[2] and merged[-1][1] == iv[0]:
            merged[-1] = (merged[-1][0], iv[1], iv[2])
        else:
            merged.append(iv)
    intervals = merged
    seconds: Dict[str, float] = {}
    for a, b, phase in intervals:
        seconds[phase] = seconds.get(phase, 0.0) + (b - a)
    ttft_ms = ((live.emits[0] - t0) * 1000.0 if live.emits else None)
    itl_ms = [(b - a) * 1000.0
              for a, b in zip(live.emits, live.emits[1:])]
    shed = any(p == SHED for _t, p in live.marks)
    target = TTFT_TARGETS_MS.get(live.slo_class, DEFAULT_TTFT_TARGET_MS)
    breach = ttft_ms is None or ttft_ms > target
    return RequestRecord(
        rid=live.rid, model=live.model, slo_class=live.slo_class,
        t_start=t0, t_end=t_end, intervals=intervals, seconds=seconds,
        emits=list(live.emits), chunks=live.chunks, ttft_ms=ttft_ms,
        itl_ms=itl_ms, shed=shed, breach=breach)


# -- the ledger --------------------------------------------------------------


class RequestLedger:
    """Thread-safe request-lifecycle recorder + bounded flight rings.

    One module-level :data:`DEFAULT_LEDGER` serves the common case
    (the server and its engines in one process join records by trace
    id through it, as spans do through ``obs/trace.py``'s
    ``DEFAULT_COLLECTOR``); components take an injectable instance for
    fake-clock tests.

    Unknown/finished rids are DROPPED silently by every mutator except
    :meth:`start` — a late stall from a stream writer, or an emit
    replayed after cache recovery closed the record, must never corrupt
    another request's evidence or raise on a hot path.
    """

    def __init__(self, *, capacity: int = DEFAULT_RING_CAPACITY,
                 max_live: int = DEFAULT_MAX_LIVE) -> None:
        self.capacity = int(capacity)
        self.max_live = int(max_live)
        self._live: "Dict[str, _LiveRequest]" = {}
        # per-model bounded rings of folded records (FlightRecorder
        # twin): dict-ordered oldest-first, trimmed on append
        self._done: Dict[str, List[RequestRecord]] = {}
        self._lock = threading.Lock()
        self.started_total = 0
        self.finished_total = 0
        self.dropped_live = 0  # live evictions (records nobody finished)

    # -- write path --------------------------------------------------------

    def start(self, rid: Optional[str], *, t: float, model: str = "",
              slo_class: str = "", phase: str = QUEUE_WAIT) -> None:
        """Open (or join) the record for ``rid`` at ``t``.

        Idempotent by design: the edge starts the record, then the
        engine's ``submit`` calls start() again for the same trace —
        the second call only back-fills ``model``/``slo_class`` it
        didn't know. ``rid=None`` (no trace context and no synthetic
        id) is a no-op."""
        if not rid:
            return
        with self._lock:
            live = self._live.get(rid)
            if live is not None:
                if model and not live.model:
                    live.model = model
                if slo_class and not live.slo_class:
                    live.slo_class = slo_class
                return
            self.started_total += 1
            self._live[rid] = _LiveRequest(
                rid=rid, model=model, slo_class=slo_class, t_start=t,
                marks=[(t, phase)])
            while len(self._live) > self.max_live:
                # oldest-first eviction: insertion-ordered dict
                self._live.pop(next(iter(self._live)))
                self.dropped_live += 1

    def annotate(self, rid: Optional[str], *, model: str = "",
                 slo_class: str = "") -> None:
        """Back-fill labels on a live record (drop if unknown)."""
        if not rid:
            return
        with self._lock:
            live = self._live.get(rid)
            if live is None:
                return
            if model:
                live.model = model
            if slo_class:
                live.slo_class = slo_class

    def mark(self, rid: Optional[str], phase: str, t: float) -> None:
        """Transition the record's base phase at ``t`` (clamped to be
        monotone against earlier marks)."""
        if not rid:
            return
        with self._lock:
            live = self._live.get(rid)
            if live is None:
                return
            live.marks.append((max(t, live.last_t), phase))

    def stall(self, rid: Optional[str], phase: str, t0: float,
              t1: float) -> None:
        """Record a carve-out window (kv_fault / weight_fault /
        stream_stall); clipped to the record's life at fold time."""
        if not rid or t1 <= t0:
            return
        with self._lock:
            live = self._live.get(rid)
            if live is None:
                return
            live.stalls.append((t0, t1, phase))

    def emit(self, rid: Optional[str], t: float) -> None:
        """One token emitted at ``t`` — the engine-emit hot path.

        ``t`` is the timestamp the engine ALREADY read for the decode
        step (run_once reads the clock once per step, not per token);
        the ledger never reads a clock here. The first emit is the
        first token: it also transitions the base phase to ``decode``,
        so TTFT and the decode interval share one timestamp."""
        if not rid:
            return
        with self._lock:
            live = self._live.get(rid)
            if live is None:
                return
            if not live.emits:
                live.marks.append((max(t, live.last_t), DECODE))
            elif t < live.emits[-1]:
                t = live.emits[-1]
            live.emits.append(max(t, live.t_start))

    def note_chunk(self, rid: Optional[str]) -> None:
        """Count one prefill chunk (the chunked-prefill scheduler)."""
        if not rid:
            return
        with self._lock:
            live = self._live.get(rid)
            if live is not None:
                live.chunks += 1

    def finish(self, rid: Optional[str],
               t: float) -> Optional[RequestRecord]:
        """Close the record at ``t``: fold, observe the histograms +
        counters (exemplared by the request's trace), and push the
        folded record into the model's bounded ring. Idempotent —
        finishing an unknown/already-finished rid returns None."""
        if not rid:
            return None
        with self._lock:
            live = self._live.pop(rid, None)
        if live is None:
            return None
        rec = fold_record(live, t)
        model = rec.model or "unknown"
        slo = rec.slo_class or NO_SLO_CLASS
        if rec.ttft_ms is not None:
            _ttft_h.observe(rec.ttft_ms, exemplar_trace_id=rec.rid,
                            model=model, slo_class=slo)
        for gap in rec.itl_ms:
            _itl_h.observe(gap, exemplar_trace_id=rec.rid, model=model,
                           slo_class=slo)
        for phase, s in rec.seconds.items():
            _phase_h.observe(s, exemplar_trace_id=rec.rid, model=model,
                             slo_class=slo, phase=phase)
        _finished_c.inc(model=model, slo_class=slo)
        if rec.breach:
            _breach_c.inc(model=model, slo_class=slo)
        with self._lock:
            self.finished_total += 1
            ring = self._done.setdefault(model, [])
            ring.append(rec)
            if len(ring) > self.capacity:
                del ring[:len(ring) - self.capacity]
        return rec

    def shed(self, rid: Optional[str], *, t_start: float, t_shed: float,
             t_end: float, model: str = "",
             slo_class: str = "") -> Optional[RequestRecord]:
        """Convenience for the edge's 503 path: one call records the
        whole (short) life of a shed request — admission from
        ``t_start``, shed from ``t_shed``, closed at ``t_end``."""
        self.start(rid, t=t_start, model=model, slo_class=slo_class,
                   phase=ADMISSION)
        self.mark(rid, SHED, t_shed)
        return self.finish(rid, t_end)

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._done.clear()

    # -- read path ---------------------------------------------------------

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def ttft_ms(self, rid: Optional[str]) -> Optional[float]:
        """TTFT for a live OR finished record (bench reads the wave's
        TTFT before the streams drain)."""
        if not rid:
            return None
        with self._lock:
            live = self._live.get(rid)
            if live is not None:
                return ((live.emits[0] - live.t_start) * 1000.0
                        if live.emits else None)
            for ring in self._done.values():
                for rec in reversed(ring):
                    if rec.rid == rid:
                        return rec.ttft_ms
        return None

    def records(self, model: Optional[str] = None
                ) -> List[RequestRecord]:
        """Finished records oldest-first (one model, or all)."""
        with self._lock:
            if model is not None:
                return list(self._done.get(model, ()))
            return [rec for m in sorted(self._done)
                    for rec in self._done[m]]

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._done)

    def worst_ttft(self, model: Optional[str] = None
                   ) -> Optional[RequestRecord]:
        """The finished record with the worst TTFT (requests that never
        produced a token rank worst of all, by wall; ties earliest) —
        the dashboard's tail exemplar."""
        recs = self.records(model)
        worst: Optional[RequestRecord] = None

        def key(r: RequestRecord) -> Tuple[int, float]:
            if r.ttft_ms is None:
                return (1, r.wall_s * 1000.0)
            return (0, r.ttft_ms)

        for rec in recs:
            if worst is None or key(rec) > key(worst):
                worst = rec
        return worst

    def view(self, model: str) -> Dict[str, Any]:
        """One model's phase-breakdown percentiles — the dashboard's
        ``GET /api/models/<model>/requests`` payload body."""
        recs = self.records(model)
        ttfts = [r.ttft_ms for r in recs if r.ttft_ms is not None]
        itls = [g for r in recs for g in r.itl_ms]
        phases: Dict[str, List[float]] = {}
        for r in recs:
            for p, s in r.seconds.items():
                phases.setdefault(p, []).append(s)
        return {
            "model": model,
            "count": len(recs),
            "shed": sum(1 for r in recs if r.shed),
            "breaches": sum(1 for r in recs if r.breach),
            "tokens": sum(r.tokens for r in recs),
            "ttftMs": _percentiles(ttfts),
            "itlMs": _percentiles(itls),
            "phaseSeconds": {p: _percentiles(v, total=True)
                             for p, v in sorted(phases.items())},
        }

    def rollup(self) -> Dict[str, Any]:
        """Fleet rollup across models (``GET /api/metrics/requests``)."""
        models = self.models()
        rows = {m: self.view(m) for m in models}
        all_recs = self.records()
        fleet_phases: Dict[str, float] = {}
        for r in all_recs:
            for p, s in r.seconds.items():
                fleet_phases[p] = fleet_phases.get(p, 0.0) + s
        total = sum(fleet_phases.values())
        return {
            "models": rows,
            "fleet": {
                "count": len(all_recs),
                "shed": sum(1 for r in all_recs if r.shed),
                "breaches": sum(1 for r in all_recs if r.breach),
                "tokens": sum(r.tokens for r in all_recs),
                "phaseSeconds": {p: round(s, 9) for p, s in
                                 sorted(fleet_phases.items())},
                "phaseFractions": {
                    p: round(s / total, 6) for p, s in
                    sorted(fleet_phases.items())} if total > 0 else {},
                "ttftMs": _percentiles(
                    [r.ttft_ms for r in all_recs
                     if r.ttft_ms is not None]),
            },
            "liveRequests": self.live_count(),
            "droppedLive": self.dropped_live,
        }

    def bench_block(self, model: Optional[str] = None) -> Dict[str, Any]:
        """The bench artifact's ``requests`` block: the run's request
        distribution, from the same ledger production reads."""
        recs = self.records(model)
        ttfts = [r.ttft_ms for r in recs if r.ttft_ms is not None]
        itls = [g for r in recs for g in r.itl_ms]
        phases: Dict[str, float] = {}
        for r in recs:
            for p, s in r.seconds.items():
                phases[p] = phases.get(p, 0.0) + s
        return {
            "count": len(recs),
            "tokens": sum(r.tokens for r in recs),
            "chunks": sum(r.chunks for r in recs),
            "ttft_ms": _percentiles(ttfts),
            "itl_ms": _percentiles(itls),
            "phase_seconds": {p: round(s, 6) for p, s in
                              sorted(phases.items())},
        }


def _percentiles(values: Iterable[float], *,
                 total: bool = False) -> Dict[str, float]:
    vals = sorted(values)
    if not vals:
        return {}
    def q(p: float) -> float:
        # nearest-rank on the sorted sample — stable for tiny n
        i = min(len(vals) - 1, max(0, round(p * (len(vals) - 1))))
        return round(vals[int(i)], 6)
    out = {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
           "max": round(vals[-1], 6), "count": len(vals)}
    if total:
        out["total"] = round(sum(vals), 6)
    return out


def synthetic_rid() -> str:
    """A 32-hex request id for requests with no propagated trace (the
    bench driver, direct engine callers) — same shape as a trace id so
    ledger keys stay uniform; not derived from any clock."""
    return os.urandom(16).hex()


def check_tiling(rec: RequestRecord, *, tol: float = 1e-9) -> None:
    """Assert the goodput invariant at request granularity: intervals
    tile [t_start, t_end] exactly (no gaps, no overlaps) and seconds
    sum to the wall clock. Raises AssertionError — test/smoke helper."""
    ivs = rec.intervals
    if rec.t_end == rec.t_start:
        assert not ivs or sum(b - a for a, b, _ in ivs) == 0.0
        return
    assert ivs, f"no intervals for wall {rec.wall_s}"
    assert ivs[0][0] == rec.t_start, (ivs[0], rec.t_start)
    assert ivs[-1][1] == rec.t_end, (ivs[-1], rec.t_end)
    for (a0, b0, _p0), (a1, _b1, _p1) in zip(ivs, ivs[1:]):
        assert b0 == a1, f"gap/overlap at {b0} vs {a1}"
        assert b0 > a0
    assert abs(sum(rec.seconds.values()) - rec.wall_s) <= tol, (
        rec.seconds, rec.wall_s)
    assert set(rec.seconds) <= set(PHASES), rec.seconds


#: process-wide ledger: edge, engines, and the multiplexer in one
#: process join per-request records through it (the DEFAULT_COLLECTOR
#: pattern); tests inject fresh instances
DEFAULT_LEDGER = RequestLedger()
