"""Compressed-activation training: int8 forward-saved tensors.

PyTorch port of ``kubeflow_tpu/ops/act_compress.py``. A conv's weight
gradient re-reads its forward input; storing that input as int8 with a
per-channel absmax scale cuts what the backward keeps 2x against bf16
and 4x against f32, at a bounded quantization error in the gradients
(the ActNN/GACT recipe):

- forward: run the op exactly; save the INPUT as ``(int8 values,
  per-channel scales)`` instead of the tensor;
- backward: dequantize and differentiate the op at the dequantized
  point (straight-through with respect to the rounding).

The reference writes the quantizer in plain ``jnp`` (no Pallas kernel),
so plain PyTorch is its port: ``torch.round`` rounds half to even as
``jnp.round`` does, and the int8 values and scales equal the
reference's bit for bit. The reference quantizes over the last axis of
its NHWC activations; the port's activations are NCHW-shaped in
channels-last memory (``models/resnet.py``), so :class:`Int8Conv`
passes ``channel_dim=1``.

Whether it saves memory in eager PyTorch depends on what else keeps the
input alive: a ReLU or BatchNorm before the conv saves the same tensor
for its own backward, and then the int8 copy is extra (PERF.md §7).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models.resnet import Conv


def quantize_int8(x: torch.Tensor, channel_dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric absmax int8 quantization over
    ``channel_dim`` (default the last axis, the reference's).

    Returns ``(q int8, scale f32)`` with ``x ≈ q * scale``; ``scale``
    keeps every dim (size 1 but the channel's). Zero channels get scale
    0 and dequantize to exact zeros.
    """
    xf = x.float()
    cd = channel_dim % x.dim()
    dims = tuple(d for d in range(x.dim()) if d != cd)
    absmax = xf.abs().amax(dim=dims, keepdim=True) if dims else xf.abs()
    scale = absmax / 127.0
    live = scale > 0
    q = torch.where(live, xf / torch.where(live, scale,
                                           torch.ones_like(scale)), 0.0)
    q = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


Params = Union[torch.Tensor, Sequence[torch.Tensor]]


class _Int8Checkpoint(torch.autograd.Function):
    """``fn(params, x)`` with ``x`` saved as int8 + scales."""

    @staticmethod
    def forward(ctx, fn, channel_dim, n_params, x, *params):
        ctx.fn, ctx.channel_dim, ctx.n_params = fn, channel_dim, n_params
        ctx.x_dtype = x.dtype
        ctx.x_channels_last = (x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last))
        q, scale = quantize_int8(x, channel_dim)
        ctx.save_for_backward(q, scale, *params)
        with torch.no_grad():
            return fn(_unflatten(params, n_params), x)

    @staticmethod
    def backward(ctx, g):
        q, scale, *params = ctx.saved_tensors
        x = dequantize_int8(q, scale).to(ctx.x_dtype)
        if ctx.x_channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        x = x.detach().requires_grad_(ctx.needs_input_grad[3])
        params = [p.detach().requires_grad_(need) for p, need in
                  zip(params, ctx.needs_input_grad[4:])]
        with torch.enable_grad():
            y = ctx.fn(_unflatten(params, ctx.n_params), x)
        wrt = [t for t in (x, *params) if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        dx = next(grads) if x.requires_grad else None
        dparams = [next(grads) if p.requires_grad else None for p in params]
        return (None, None, None, dx, *dparams)


def _unflatten(params, n_params):
    return params[0] if n_params is None else tuple(params)


def int8_checkpoint(fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    channel_dim: int = -1) -> Callable:
    """Wrap ``fn(params, x) -> y`` (``params`` a tensor or a sequence of
    tensors) so the backward sees an int8-saved ``x`` (quantized over
    ``channel_dim``). The forward runs ``fn`` exactly; the backward
    recomputes ``fn``'s gradient at the dequantized point. ``params``
    are saved by reference (they are live in the optimizer anyway)."""

    def wrapped(params: Params, x: torch.Tensor) -> torch.Tensor:
        if isinstance(params, torch.Tensor):
            return _Int8Checkpoint.apply(fn, channel_dim, None, x, params)
        params = tuple(params)
        return _Int8Checkpoint.apply(fn, channel_dim, len(params), x,
                                     *params)

    return wrapped


class Int8Conv(Conv):
    """``models/resnet.py:Conv`` (flax ``nn.Conv`` without bias) whose
    backward reads its input from an int8 residual. The same ``kernel``
    parameter (torch ``(O, I, kh, kw)``), so checkpoints swap between
    the compressed and the plain configs. Input and kernel are cast to
    ``dtype`` inside the wrapped op, so the kernel's gradient reaches
    its f32 parameter; the input's scales run over channels (dim 1 of
    the NCHW view)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = self._pads(x)
        dtype, strides = self.dtype, self.strides
        even = top == bottom and left == right

        def conv(kernel, xx):
            # the reference pads inside the wrapped op: the saved input
            # is the unpadded one
            if even:
                return F.conv2d(xx, kernel.to(dtype), stride=strides,
                                padding=(top, left))
            xx = F.pad(xx, (left, right, top, bottom)).contiguous(
                memory_format=torch.channels_last)
            return F.conv2d(xx, kernel.to(dtype), stride=strides)

        return int8_checkpoint(conv, channel_dim=1)(self.kernel,
                                                    x.to(dtype))
