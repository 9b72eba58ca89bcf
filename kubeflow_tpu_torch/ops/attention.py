"""Attention cores of the model: the dense oracle and flash attention.

Counterpart of ``kubeflow_tpu/ops/attention.py``: ``NEG_INF``,
``gqa_repeat`` and ``reference_attention`` (:39-75), and
:func:`flash_attention` (:587-650), whose forward and backward passes
are the CUDA kernels of ``ops/flash_attention.py``. All functions take
``(B, S, H, D)`` q/k/v and return ``(B, S, H, D)``; the bf16 rounding
points of ``reference_attention`` are the JAX package's: scores from an
einsum in the input dtype, softmax in f32, probabilities cast back
before the value product.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def gqa_repeat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Repeat grouped KV heads up to q's head count (no-op when equal)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def reference_attention(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        kv_len: Optional[torch.Tensor] = None):
    """Plain O(S²)-memory attention; ``kv_len`` (B,) masks KV positions
    at or past each row's valid length."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    S, T = q.shape[1], k.shape[1]
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (T - S))
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
    if kv_len is not None:
        valid = (torch.arange(T, device=q.device)[None, :]
                 < kv_len[:, None])
        logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


class _FlashAttention(torch.autograd.Function):
    """Forward saves ``(q, k, v, out, lse, kv_len)``; backward computes
    ``delta = Σ_d dO·O`` in f32 as a plain op (XLA's fused reduce in the
    reference, :508-511), then runs the dQ and dK/dV passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_len):
        # local: ops/flash_attention.py imports NEG_INF from this module
        from kubeflow_tpu_torch.ops import flash_attention as fa

        out, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        from kubeflow_tpu_torch.ops import flash_attention as fa

        q, k, v, out, lse, kv_len = ctx.saved_tensors
        if g.stride(-1) != 1:   # the kernels read rows of the head dim
            g = g.contiguous()
        delta = fa.flash_delta(g, out)
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale, kv_len=kv_len)
        dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """Flash attention with the reference's signature; differentiable in
    q, k and v.

    K and V arrive already GQA-repeated. ``block_q``/``block_k`` are the
    reference's TPU tile knobs and are accepted and ignored: the CUDA
    kernels take their own 64 x 64 tiles. ``kv_len`` is an optional
    ``(B,)`` int32 valid length per batch row; keys at or past it are
    masked in the forward and both backward passes (outputs at padded q
    positions are unspecified, as in the reference).
    """
    del block_q, block_k
    return _FlashAttention.apply(q, k, v, causal, sm_scale, kv_len)
