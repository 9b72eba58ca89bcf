"""Observability of the port: spans and exporters, device-memory
watermarks, and the training plane's step telemetry."""

from kubeflow_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace,
    otlp_lines,
    parse_otlp_lines,
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
    Span,
    SpanCollector,
    SpanContext,
    Tracer,
)
from kubeflow_tpu_torch.obs.xprof import HbmSampler  # noqa: F401
