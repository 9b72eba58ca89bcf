"""ResNet-v1.5 family: the image-classification workload.

PyTorch port of ``kubeflow_tpu/models/resnet.py``. The public layout is
the reference's: images come in as ``(B, H, W, 3)`` and logits go out as
``(B, num_classes)`` f32. Inside, activations are NCHW-shaped tensors in
``torch.channels_last`` memory (NHWC bytes), so cuDNN's convolutions run
channels-last and the fused BN + ReLU + 1x1 conv reads ``(pixels,
channels)`` rows as a view, without a copy.

Module and parameter names are the flax names (``stage0_block0.conv1.
kernel`` is ``params/stage0_block0/conv1/kernel``; the BN running
statistics are buffers, ``stage0_block0.bn1.mean`` is
``batch_stats/stage0_block0/bn1/mean``). Conv kernels are stored as torch
``(O, I, kh, kw)``; ``models/convert.py`` moves them from and to flax's
``(kh, kw, I, O)``.

The reference's numerics, where torch's own would differ:

- padding is XLA's ``SAME``: ``lo = total // 2`` (the stride-2 3x3 conv
  and the space-to-depth stem's 2x2 conv pad 0 before and 1 after);
- :class:`BatchNorm` is flax's, not ``nn.BatchNorm2d``: f32 statistics
  with ``var = max(0, E[x^2] - E[x]^2)``, output ``(x - mean) *
  (rsqrt(var + eps) * scale) + bias`` in f32 cast to ``bn_dtype``,
  running averages ``m * ra + (1 - m) * stat`` of the biased variance,
  updated only by a train-mode forward;
- :class:`FusedBnReluConv` takes its statistics as the reference's fused
  layer does: ``E[x^2] - E[x]^2`` with no clamp, folded into ``a``, ``b``;
- the global pool averages in the compute dtype (a bf16 mean is rounded
  to bf16) before the f32 head.

Under data parallelism (``train/trainer.py:make_image_train_step`` over a
mesh runs the forward inside :func:`global_batch_stats`) both BatchNorm
sites take the global batch's statistics, as the reference's do under
GSPMD: each all-reduces its rows' ``[Σx, Σx²]`` over the data axes
(differentiably: the backward sums the cotangents too) and divides by
the global count (every rank holds as many rows) before ``E[x²] -
E[x]²``. The running statistics then come out equal on every rank, and
the fused site's ``a``/``b`` feed the bnconv kernel as before.

``act_compress`` swaps each bottleneck conv (conv1-3 and the
projection) for ``ops/act_compress.py:Int8Conv``, which keeps the
``kernel`` parameter and saves its input as int8 with per-channel
scales for the backward; it refuses to combine with ``fused_bn_conv``,
as the reference does.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.transformer import torch_dtype
from kubeflow_tpu_torch.ops import collectives as col
from kubeflow_tpu_torch.ops.bnconv import fused_scale_relu_matmul
from kubeflow_tpu_torch.parallel import mesh as pmesh

# (mesh, data axes) while a data-parallel step's forward runs
_GLOBAL_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "kftpu_bn_global_stats", default=None)


@contextlib.contextmanager
def global_batch_stats(mesh, axes: Sequence[str] = ("dcn", "dp")):
    """BatchNorm statistics over the global batch split over ``axes`` of
    ``mesh`` for the forwards run inside."""
    token = _GLOBAL_STATS.set((mesh, tuple(axes)))
    try:
        yield
    finally:
        _GLOBAL_STATS.reset(token)


def _moments(xf: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E[x], E[x²])`` of f32 ``xf`` over ``dims``: this rank's rows, or
    the global batch's inside :func:`global_batch_stats`."""
    over = _GLOBAL_STATS.get()
    if over is None:
        return xf.mean(dim=dims), (xf * xf).mean(dim=dims)
    mesh, axes = over
    sums = torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
    count = xf.numel() // sums.shape[1]      # rows a channel, this rank
    sums = col.all_reduce_grad(sums, mesh, axes)
    mean, mean2 = sums / (count * pmesh.axis_size(mesh, axes))
    return mean, mean2


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """The reference's fields and defaults, one for one (dtypes may be
    torch dtypes or their names)."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    bn_dtype: Any = torch.bfloat16
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    stem: str = "space_to_depth"
    act_compress: bool = False
    fused_bn_conv: bool = False


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: input and kernel cast to ``dtype``,
    ``SAME`` padding (or explicit ``((lo, hi), (lo, hi))`` pairs)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int], strides: int = 1,
                 padding: Any = "SAME", *, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(
            features, in_features, *kernel_size, dtype=param_dtype))
        self.strides = strides
        self.padding = padding
        self.dtype = dtype

    def _pads(self, x: torch.Tensor):
        if self.padding != "SAME":
            return tuple(self.padding)
        kh, kw = self.kernel.shape[2:]
        return (same_padding(x.shape[2], kh, self.strides),
                same_padding(x.shape[3], kw, self.strides))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = self._pads(x)
        x = x.to(self.dtype)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom)).contiguous(
                memory_format=torch.channels_last)
            pad = 0
        return F.conv2d(x, self.kernel.to(self.dtype), stride=self.strides,
                        padding=pad)


_Conv = Conv


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of an NCHW tensor."""

    def __init__(self, features: int, *, momentum: float, epsilon: float,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 zero_scale: bool = False):
        super().__init__()
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, mean2 = _moments(xf, (0, 2, 3))
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            _update_running(self, mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.float()[:, None, None]).to(self.dtype)


def _update_running(bn: nn.Module, mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """flax's running averages: ``m * ra + (1 - m) * stat``."""
    m = bn.momentum
    with torch.no_grad():
        bn.mean.copy_(m * bn.mean + (1 - m) * mean.detach())
        bn.var.copy_(m * bn.var + (1 - m) * var.detach())


class FusedBnReluConv(nn.Module):
    """``relu(batchnorm(x)) @ 1x1-conv`` with the normalise pass fused
    into the GEMM's input side (:func:`~kubeflow_tpu_torch.ops.bnconv.
    fused_scale_relu_matmul`): the activation is read once instead of
    read + write + read. Owns bn2's scale, bias and running statistics
    and conv3's kernel, stored as the ``(C, features)`` matrix the GEMM
    takes (flax: ``(1, 1, C, features)``)."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 bn_dtype: torch.dtype, momentum: float, epsilon: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(in_features,
                                             dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(in_features, dtype=param_dtype))
        self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                               dtype=param_dtype))
        self.register_buffer("mean", torch.zeros(in_features))
        self.register_buffer("var", torch.ones(in_features))
        self.dtype = dtype
        self.bn_dtype = bn_dtype
        self.momentum = momentum
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        B, C, H, W = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(-1, C)   # a view if NHWC bytes
        if train:
            mean, mean2 = _moments(rows.float(), (0,))
            var = mean2 - mean * mean
            _update_running(self, mean, var)
        else:
            mean, var = self.mean, self.var
        a = self.scale.float() * torch.rsqrt(var + self.epsilon)
        b = self.bias.float() - mean * a
        out = fused_scale_relu_matmul(rows.to(self.dtype), a, b,
                                      self.kernel.to(self.dtype),
                                      self.bn_dtype)
        return out.reshape(B, H, W, -1).permute(0, 3, 1, 2)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int, *,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 bn_dtype: torch.dtype, bn_momentum: float,
                 bn_epsilon: float, fused_bn_conv: bool,
                 act_compress: bool = False):
        super().__init__()
        if act_compress:
            # local: ops/act_compress.py subclasses this module's Conv
            from kubeflow_tpu_torch.ops.act_compress import Int8Conv as Conv
        else:
            Conv = _Conv
        conv = dict(dtype=dtype, param_dtype=param_dtype)
        norm = dict(momentum=bn_momentum, epsilon=bn_epsilon,
                    dtype=bn_dtype, param_dtype=param_dtype)
        out = filters * 4
        self.fused_bn_conv = fused_bn_conv
        self.conv1 = Conv(in_features, filters, (1, 1), **conv)
        self.bn1 = BatchNorm(filters, **norm)
        self.conv2 = Conv(filters, filters, (3, 3), strides, **conv)
        if fused_bn_conv:
            self.bn2conv3 = FusedBnReluConv(
                filters, out, dtype=dtype, param_dtype=param_dtype,
                bn_dtype=bn_dtype, momentum=bn_momentum, epsilon=bn_epsilon)
        else:
            self.bn2 = BatchNorm(filters, **norm)
            self.conv3 = Conv(filters, out, (1, 1), **conv)
        self.bn3 = BatchNorm(out, zero_scale=True, **norm)
        # the reference projects when the residual's shape differs from
        # the block output's: a channel change or a stride
        self.project = in_features != out or strides != 1
        if self.project:
            self.proj_conv = Conv(in_features, out, (1, 1), strides, **conv)
            self.proj_bn = BatchNorm(out, **norm)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        residual = x
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.conv2(y)
        if self.fused_bn_conv:
            y = self.bn2conv3(y, train)
        else:
            y = self.conv3(F.relu(self.bn2(y, train)))
        y = self.bn3(y, train)
        if self.project:
            residual = self.proj_bn(self.proj_conv(residual), train)
        return F.relu(residual + y.to(residual.dtype))


class Dense(nn.Module):
    """flax ``nn.Dense`` in f32: ``x @ kernel + bias``, kernel (in, out)."""

    def __init__(self, in_features: int, features: int,
                 param_dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                               dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel.float() + self.bias.float()


class ResNet(nn.Module):
    """``forward(images (B, H, W, 3), train=True) -> logits (B, classes)``
    in f32. A train-mode forward updates the BN running statistics."""

    IN_CHANNELS = 3

    def __init__(self, config: ResNetConfig = ResNetConfig()):
        super().__init__()
        c = config
        if c.act_compress and c.fused_bn_conv:
            raise ValueError(
                "act_compress and fused_bn_conv cannot combine: conv3 "
                "would lose activation compression inside the fused op")
        if c.stem not in ("space_to_depth", "conv"):
            raise ValueError(f"unknown stem {c.stem!r}")
        self.config = c
        dtype, pdt = torch_dtype(c.dtype), torch_dtype(c.param_dtype)
        bn_dtype = torch_dtype(c.bn_dtype)
        self.dtype = dtype
        norm = dict(momentum=c.bn_momentum, epsilon=c.bn_epsilon,
                    dtype=bn_dtype, param_dtype=pdt)
        if c.stem == "space_to_depth":
            self.stem_conv_s2d = Conv(16 * self.IN_CHANNELS, c.width, (2, 2),
                                      dtype=dtype, param_dtype=pdt)
        else:
            self.stem_conv = Conv(self.IN_CHANNELS, c.width, (7, 7), 2,
                                  ((3, 3), (3, 3)), dtype=dtype,
                                  param_dtype=pdt)
        self.stem_bn = BatchNorm(c.width, **norm)
        self.block_names = []
        features = c.width
        for i, n_blocks in enumerate(c.stage_sizes):
            for j in range(n_blocks):
                name = f"stage{i}_block{j}"
                block = BottleneckBlock(
                    features, c.width * 2 ** i, 2 if j == 0 and i > 0 else 1,
                    dtype=dtype, param_dtype=pdt, bn_dtype=bn_dtype,
                    bn_momentum=c.bn_momentum, bn_epsilon=c.bn_epsilon,
                    fused_bn_conv=c.fused_bn_conv,
                    act_compress=c.act_compress)
                self.add_module(name, block)
                self.block_names.append(name)
                features = c.width * 2 ** i * 4
        self.head = Dense(features, c.num_classes, pdt)

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        x = images.to(self.dtype)
        if self.config.stem == "space_to_depth":
            # fold 4x4 pixel blocks into channels: 224^2 x 3 -> 56^2 x 48
            B, H, W, C = x.shape
            if H % 4 or W % 4:
                raise ValueError(f"space_to_depth stem needs H,W % 4 == 0, "
                                 f"got {H}x{W}")
            x = x.reshape(B, H // 4, 4, W // 4, 4, C)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 4, W // 4,
                                                    16 * C)
            x = self.stem_conv_s2d(x.permute(0, 3, 1, 2))
            x = F.relu(self.stem_bn(x, train))
        else:
            x = self.stem_conv(x.permute(0, 3, 1, 2))
            x = F.relu(self.stem_bn(x, train))
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.head(x.mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(ResNetConfig(stage_sizes=(3, 4, 6, 3),
                               num_classes=num_classes, **kw))


def resnet18_thin(num_classes: int = 10) -> ResNet:
    """Small variant for CPU tests (plain conv stem: test inputs are tiny)."""
    return ResNet(ResNetConfig(stage_sizes=(1, 1), num_classes=num_classes,
                               width=16, dtype=torch.float32,
                               bn_dtype=torch.float32, stem="conv"))
