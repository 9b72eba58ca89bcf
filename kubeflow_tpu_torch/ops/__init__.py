"""Ops of the port: attention cores and the CUDA kernels.

Each kernel module holds its wrappers (CUDA tensors launch the kernel),
their plain PyTorch versions (CPU tensors), and ``launches``, a count of
kernel launches by kernel name. Kernels build from ``ops/csrc`` at first
launch (``ops/_build.py``).
"""

from typing import Dict

from kubeflow_tpu_torch.ops import (  # noqa: F401
    bnconv,
    flash_attention,
    paged_attention,
    sampling,
)
from kubeflow_tpu_torch.ops.attention import (  # noqa: F401
    NEG_INF,
    gqa_repeat,
    reference_attention,
)

KERNEL_MODULES = (paged_attention, sampling, flash_attention, bnconv)


def reset_launches() -> None:
    """Zero every kernel's launch counter."""
    for mod in KERNEL_MODULES:
        for name in mod.launches:
            mod.launches[name] = 0


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: n for mod in KERNEL_MODULES
            for name, n in mod.launches.items()}
