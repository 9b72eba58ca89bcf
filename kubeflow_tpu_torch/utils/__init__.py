"""Shared utilities of the port: metrics and the clock contract."""

from kubeflow_tpu_torch.utils.metrics import (  # noqa: F401
    DEFAULT_REGISTRY,
    Histogram,
    Metric,
    Registry,
)
