"""Observability of the port: spans and exporters, the serving plane's
request-lifecycle ledger, device-memory watermarks, and the training
plane's step telemetry."""

from kubeflow_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace,
    otlp_lines,
    parse_otlp_lines,
)
from kubeflow_tpu_torch.obs import requests  # noqa: F401
from kubeflow_tpu_torch.obs.requests import (  # noqa: F401
    DEFAULT_LEDGER,
    RequestLedger,
    RequestRecord,
    check_tiling,
)
from kubeflow_tpu_torch.obs.steps import (  # noqa: F401
    FlightRecorder,
    StepRecord,
    StepTelemetry,
    flag_stragglers,
    kube_beacon_sink,
    publish_beacon,
    read_beacons,
    step_span_id,
    telemetry_view,
    tpujob_trace_ids,
)
from kubeflow_tpu_torch.obs.trace import (  # noqa: F401
    DEFAULT_COLLECTOR,
    TRACER,
    Span,
    SpanCollector,
    SpanContext,
    Tracer,
    extract,
)
from kubeflow_tpu_torch.obs.xprof import HbmSampler  # noqa: F401
