"""Attention helpers shared by the model and the paged kernel's plain twin.

Counterpart of ``kubeflow_tpu/ops/attention.py:39-75`` (``NEG_INF``,
``gqa_repeat``, ``reference_attention``). All functions take
``(B, S, H, D)`` q/k/v and return ``(B, S, H, D)``; the bf16 rounding
points are the JAX package's: scores from an einsum in the input dtype,
softmax in f32, probabilities cast back before the value product.
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
