"""MNIST CNN: the correctness-smoke workload.

PyTorch port of ``kubeflow_tpu/models/mnist.py``: ``Conv(32, 3x3)`` with
``SAME`` padding and a bias, ReLU, 2x2 average pool; ``Conv(64, 3x3)``,
ReLU, pool; flatten in NHWC order; ``Dense(128)``, ReLU, ``Dense(10)``,
all in f32. Parameters keep flax's names and layouts (``conv1.kernel``
``(3, 3, in, out)``, ``fc1.kernel`` ``(in, out)``), so a model-store
export carries across through ``models/convert.py`` unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.resnet import Dense


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3))``: ``SAME`` padding, a bias, the
    kernel stored HWIO."""

    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias,
                        padding=1)


class MnistCnn(nn.Module):
    """``forward(images (B, 28, 28, 1), train=True)`` → logits ``(B,
    num_classes)`` f32. ``train`` is accepted for the image train step's
    call and ignored: the CNN has no train-only state."""

    def __init__(self, num_classes: int = 10) -> None:
        super().__init__()
        self.conv1 = _Conv(1, 32)
        self.conv2 = _Conv(32, 64)
        self.fc1 = Dense(7 * 7 * 64, 128, torch.float32)
        self.fc2 = Dense(128, num_classes, torch.float32)

    def forward(self, images: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        del train
        x = images.float().permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = F.avg_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return self.fc2(F.relu(self.fc1(x)))
