"""Fused BN-apply + ReLU + 1x1 conv: ``relu(x * a + b) @ w`` in one pass.

PyTorch port of ``kubeflow_tpu/ops/bnconv.py``. A 1x1 conv is a GEMM
over pixels, so the BN affine and the ReLU run in the GEMM's input
prologue and the normalised activation is never written to device
memory. ``a = scale * rsqrt(var + eps)`` and ``b = bias - mean * a`` are
plain tensors computed by the caller, so the gradient through the batch
statistics is ordinary autograd; the autograd function here covers the
GEMM sandwich, with the reference's VJP (``_fused_vjp_fwd``/
``_fused_vjp_bwd``, :170-220).

- :func:`fused_scale_relu_matmul` — the autograd function. Its backward
  keeps the reference's plain parts as tensor ops: ``dy = dz @ w^T``
  with an f32 result (bf16 inputs, as ``preferred_element_type``), the
  mask ``x*a + b > 0`` on the unrounded f32 ``xhat``, ``dx`` in x's
  dtype, ``da`` and ``db`` in f32; dW goes to :func:`bnconv_dw`.
- :func:`bnconv_fwd`, :func:`bnconv_dw` — the wrappers of the CUDA
  kernels in ``csrc/bnconv.cu`` (``_fwd_kernel`` and ``_dw_kernel`` of
  the reference). A CUDA tensor launches the kernel or raises; a CPU
  tensor takes the plain version. No fallback in between.
- ``*_plain`` — the plain PyTorch versions: ``y = max(x*a + b, 0)`` in
  f32 (product and sum rounded separately), rounded to ``act_dtype``
  and then to x's dtype, multiplied in f32 (exact products of bf16
  values, f32 sums) and rounded to the output dtype.

x is ``(M, K)`` (pixels, channels), a and b ``(K,)`` f32, w ``(K, N)`` in
x's dtype, the cotangent dz ``(M, N)`` in x's dtype. ``act_dtype`` is
the dtype the unfused model materialises the BN output in (its
``bn_dtype``; default x's dtype). The kernels take every M, K and N (the
reference falls back to XLA where its TPU blocks do not tile): the bf16
kernels read x, w and dz by TMA, which needs rows on 16 bytes, so the
wrappers zero-pad K and N to a multiple of 8 where they are not (a copy
on ragged shapes only; ResNet-50's are multiples of 64).

``launches`` counts kernel launches by kernel name (never plain calls).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

launches = {"bnconv_fwd": 0, "bnconv_dw": 0}

# blocks of the dW kernel to aim for per SM, over which the rows of x are
# split: bf16, one wave of the wgmma kernel (one block fits an SM); f32,
# two waves of two resident FMA blocks
_DW_BLOCKS_PER_SM = {True: 1, False: 4}


def _act(x: torch.Tensor, act_dtype: Optional[torch.dtype]) -> torch.dtype:
    return x.dtype if act_dtype is None else act_dtype


def activation(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               act_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = relu(x*a + b)`` as the kernels' prologue computes it, in
    x's dtype: f32 affine (two roundings), ReLU, rounded to
    ``act_dtype`` and then to x's dtype."""
    y = torch.clamp_min(x.float() * a.float() + b.float(), 0.0)
    return y.to(_act(x, act_dtype)).to(x.dtype)


def bnconv_fwd_plain(x, a, b, w, act_dtype=None) -> torch.Tensor:
    """Plain version of :func:`bnconv_fwd`."""
    y = activation(x, a, b, act_dtype)
    return (y.float() @ w.float()).to(x.dtype)


def bnconv_dw_plain(x, a, b, dz, act_dtype=None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`bnconv_dw`."""
    y = activation(x, a, b, act_dtype)
    return (y.float().t() @ dz.float()).to(out_dtype)


def _check(x, a, b, other, other_rows: int, name: str) -> None:
    if x.dim() != 2 or other.dim() != 2:
        raise ValueError(f"x and {name} must be 2-D, got {tuple(x.shape)} "
                         f"and {tuple(other.shape)}")
    K = x.shape[1]
    if a.shape != (K,) or b.shape != (K,):
        raise ValueError(f"a and b must be ({K},), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if other.shape[0] != other_rows:
        raise ValueError(f"{name} has {other.shape[0]} rows, expected "
                         f"{other_rows}")
    devs = {t.device for t in (x, a, b, other)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


# -- the CUDA kernels --------------------------------------------------------


def _lib():
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("bnconv")
    if lib.kftpu_bnconv_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kftpu_bnconv_fwd.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.kftpu_bnconv_dw.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.kftpu_bnconv_geometry.argtypes = [i, p, p, p]
        for fn in (lib.kftpu_bnconv_fwd, lib.kftpu_bnconv_dw,
                   lib.kftpu_bnconv_geometry):
            fn.restype = ctypes.c_int
    return lib


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` zero-padded to ``(rows, cols)``; ``t`` itself where it has
    that shape and starts on 16 bytes."""
    if tuple(t.shape) == (rows, cols) and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _cuda_args(x, a, b, other, act_dtype):
    """Check what the kernels take; returns (a, b as f32 zero-padded to
    whole 64-channel stages, is_bf16, round_act)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {x.dtype} not supported by the CUDA kernels "
                        "(f32, bf16)")
    if other.dtype != x.dtype:
        raise TypeError(f"w/dz dtype {other.dtype} != x dtype {x.dtype}")
    act = _act(x, act_dtype)
    if act not in (torch.float32, torch.bfloat16):
        raise TypeError(f"act_dtype {act} not supported by the CUDA kernels "
                        "(f32, bf16)")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError("x and w/dz must be contiguous (rows of channels)")
    K = x.shape[1]
    ab = torch.zeros((2, _round_up(K, 64)), dtype=torch.float32,
                     device=x.device)
    ab[0, :K] = a
    ab[1, :K] = b
    is_bf16 = x.dtype == torch.bfloat16
    round_act = int(act == torch.bfloat16 and not is_bf16)
    return ab[0], ab[1], int(is_bf16), round_act


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bnconv_fwd(x, a, b, w, act_dtype=None) -> torch.Tensor:
    """``relu(x*a + b) @ w``: (M, N) in x's dtype."""
    _check(x, a, b, w, x.shape[1], "w")
    if x.device.type == "cpu":
        return bnconv_fwd_plain(x, a, b, w, act_dtype)
    a, b, is_bf16, round_act = _cuda_args(x, a, b, w, act_dtype)
    (M, K), N = x.shape, w.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=x.dtype, device=x.device)
    Kp, Np = (_round_up(K, 8), _round_up(N, 8)) if is_bf16 else (K, N)
    x, w = _pad2(x, M, Kp), _pad2(w, Kp, Np)
    out = torch.empty((M, Np), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        _launch("bnconv_fwd", lib.kftpu_bnconv_fwd, x.data_ptr(),
                a.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(),
                M, Kp, Np, is_bf16, round_act, _stream(x))
    return out if Np == N else out[:, :N].contiguous()


def _splits(lib, dev, M: int, K: int, N: int, is_bf16: int
            ) -> Tuple[int, int]:
    """(splits, chunk): rows of x per block of the dW kernel, a multiple
    of its step, so that the tiles of dW times the splits fill the card."""
    tile_k, tile_n, step = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.kftpu_bnconv_geometry(is_bf16, ctypes.byref(tile_k),
                              ctypes.byref(tile_n), ctypes.byref(step))
    tiles = -(-K // tile_k.value) * -(-N // tile_n.value)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = max(1, (_DW_BLOCKS_PER_SM[bool(is_bf16)] * sms) // tiles)
    steps = -(-M // step.value)
    chunk = -(-steps // min(want, steps)) * step.value
    return -(-M // chunk), chunk


def bnconv_dw(x, a, b, dz, act_dtype=None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``relu(x*a + b)^T @ dz``: (K, N), summed in f32 and returned in
    ``out_dtype`` (f32 or bf16 on CUDA)."""
    _check(x, a, b, dz, x.shape[0], "dz")
    if x.device.type == "cpu":
        return bnconv_dw_plain(x, a, b, dz, act_dtype, out_dtype)
    a, b, is_bf16, round_act = _cuda_args(x, a, b, dz, act_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} not supported (f32, bf16)")
    (M, K), N = x.shape, dz.shape[1]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((K, N), dtype=out_dtype, device=x.device)
    Kp, Np = (_round_up(K, 8), _round_up(N, 8)) if is_bf16 else (K, N)
    x, dz = _pad2(x, M, Kp), _pad2(dz, M, Np)
    out = torch.empty((Kp, Np), dtype=out_dtype, device=x.device)
    lib = _lib()
    splits, chunk = _splits(lib, x.device, M, Kp, Np, is_bf16)
    ws = torch.empty((splits, Kp, Np), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch("bnconv_dw", lib.kftpu_bnconv_dw, x.data_ptr(),
                a.data_ptr(), b.data_ptr(), dz.data_ptr(), ws.data_ptr(),
                out.data_ptr(), M, Kp, Np, splits, chunk, is_bf16,
                int(out_dtype == torch.bfloat16), round_act, _stream(x))
    return out if (Kp, Np) == (K, N) else out[:K, :N].contiguous()


# -- the autograd function ---------------------------------------------------


def fused_vjp(x, a, b, w, dz, act_dtype=None, dw_fn=bnconv_dw):
    """``(dx, da, db, dw)`` of ``relu(x*a + b) @ w`` at cotangent ``dz``:
    the reference's ``_fused_vjp_bwd``, with dW from ``dw_fn`` (the
    kernel wrapper, or :func:`bnconv_dw_plain` to hold it against)."""
    dz = dz.contiguous()
    xf = x.float()
    af = a.float()
    xhat = xf * af + b.float()
    dy = dz.float() @ w.float().t()
    dxhat = torch.where(xhat > 0.0, dy, 0.0)
    dx = (dxhat * af).to(x.dtype)
    da = (dxhat * xf).sum(dim=0).to(a.dtype)
    db = dxhat.sum(dim=0).to(b.dtype)
    dw = dw_fn(x, a, b, dz, act_dtype, out_dtype=w.dtype)
    return dx, da, db, dw


class _FusedScaleReluMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, a, b, w, act_dtype):
        ctx.save_for_backward(x, a, b, w)
        ctx.act_dtype = act_dtype
        return bnconv_fwd(x, a, b, w, act_dtype)

    @staticmethod
    def backward(ctx, dz):
        x, a, b, w = ctx.saved_tensors
        return (*fused_vjp(x, a, b, w, dz, ctx.act_dtype), None)


def fused_scale_relu_matmul(x: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, w: torch.Tensor,
                            act_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """``relu(x * a + b) @ w`` in one pass over ``x``: (M, N) in x's
    dtype, differentiable in all four inputs (the reference's
    ``fused_scale_relu_matmul`` without its ``interpret`` switch)."""
    return _FusedScaleReluMatmul.apply(x, a, b, w, act_dtype)
