"""Ops of the port: attention helpers and the two serving kernels.

Each kernel module holds the wrapper (CUDA tensors launch the kernel),
its plain PyTorch version (CPU tensors), and a ``launches`` counter.
Kernels build from ``ops/csrc`` at first launch (``ops/_build.py``).
"""

from kubeflow_tpu_torch.ops import paged_attention, sampling  # noqa: F401
from kubeflow_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF,
    gqa_repeat,
    reference_attention,
)

KERNEL_MODULES = (paged_attention, sampling)


def reset_launches() -> None:
    """Zero every kernel's launch counter."""
    for mod in KERNEL_MODULES:
        mod.launches = 0
