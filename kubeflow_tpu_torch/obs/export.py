"""Span exporters: Chrome ``trace_event`` JSON and an OTLP-ish ndjson.

A copy of ``kubeflow_tpu/obs/export.py``'s formats (the port imports
nothing of the JAX package):

- :func:`chrome_trace` renders spans as the Trace Event Format that
  ``chrome://tracing`` / Perfetto load directly, the viewer the
  ``torch.profiler`` traces open in too;
- :func:`otlp_lines` / :func:`parse_otlp_lines` round-trip spans as
  newline-delimited JSON in OTLP field names.

The flight recorder (``obs/steps.py``) dumps through both.
:func:`push_spans` ships a batch to the ``trace-collector`` service's
ingest endpoint (a JSON body of the same records; the ndjson shape is
the file format), best-effort: it logs a failure and never raises into
the caller.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request
from typing import Any, Dict, Iterable, List, Optional

from kubeflow_tpu_torch.obs.trace import Span

log = logging.getLogger(__name__)

# the trace-collector component's Service and ingest route (the
# reference's manifests/components/trace_collector.py defaults)
DEFAULT_COLLECTOR_URL = "http://trace-collector:8095/api/traces:ingest"
ENV_COLLECTOR_URL = "KFTPU_TRACE_COLLECTOR_URL"

def chrome_trace(spans: Iterable[Span]) -> Dict[str, Any]:
    """Complete-event (``ph: "X"``) trace; one tid per trace_id so
    concurrent requests stack on separate tracks."""
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        tid = tids.setdefault(s.trace_id, len(tids) + 1)
        events.append({
            "ph": "X",
            "name": s.name,
            "cat": "kftpu",
            "pid": 1,
            "tid": tid,
            "ts": round(s.start * 1e6, 3),
            "dur": round(s.duration * 1e6, 3),
            "args": {**s.attrs,
                     "trace_id": s.trace_id,
                     "span_id": s.span_id,
                     "parent_id": s.parent_id or "",
                     "status": s.status},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _span_record(s: Span) -> Dict[str, Any]:
    return {
        "traceId": s.trace_id,
        "spanId": s.span_id,
        "parentSpanId": s.parent_id or "",
        "name": s.name,
        "startTimeUnixNano": int(s.start * 1e9),
        "endTimeUnixNano": int((s.end if s.end is not None
                                else s.start) * 1e9),
        "attributes": dict(s.attrs),
        "status": s.status,
    }


def otlp_lines(spans: Iterable[Span]) -> str:
    """Newline-delimited OTLP-ish dump; one span per line."""
    return "".join(json.dumps(_span_record(s), sort_keys=True) + "\n"
                   for s in spans)


def span_from_record(rec: Dict[str, Any]) -> Span:
    return Span(
        trace_id=str(rec["traceId"]),
        span_id=str(rec["spanId"]),
        parent_id=str(rec.get("parentSpanId") or "") or None,
        name=str(rec.get("name", "")),
        start=float(rec["startTimeUnixNano"]) / 1e9,
        end=float(rec["endTimeUnixNano"]) / 1e9,
        attrs=dict(rec.get("attributes") or {}),
        status=str(rec.get("status", "OK")),
    )


def parse_otlp_lines(text: str) -> List[Span]:
    """Inverse of :func:`otlp_lines`; blank/garbage lines are skipped
    (a truncated dump must still load its intact prefix)."""
    out: List[Span] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(span_from_record(json.loads(line)))
        except (ValueError, KeyError, TypeError):
            continue
    return out


def push_spans(spans: Iterable[Span], url: Optional[str] = None,
               timeout: float = 5.0) -> bool:
    """POST a span batch to the trace-collector ingest endpoint
    (``url``, else ``KFTPU_TRACE_COLLECTOR_URL``, else the in-cluster
    default). Best-effort by contract: telemetry shipping never fails
    the workload, so a transport error is logged and returns False."""
    url = url or os.environ.get(ENV_COLLECTOR_URL) or DEFAULT_COLLECTOR_URL
    body = json.dumps(
        {"spans": [_span_record(s) for s in spans]}).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return 200 <= resp.status < 300
    except OSError as e:
        log.warning("span push to %s failed: %s", url, e)
        return False
