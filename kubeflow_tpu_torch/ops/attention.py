"""Attention cores of the model: the dense oracle, blockwise, flash, and
the sequence-parallel ring and Ulysses cores.

Counterpart of ``kubeflow_tpu/ops/attention.py``: ``NEG_INF``,
``gqa_repeat`` and ``reference_attention`` (:39-75);
:func:`blockwise_attention` (:106, the online-softmax accumulation of
``_block_update`` :82-103 over KV blocks); :func:`flash_attention`
(:587-650), whose forward and backward passes are the CUDA kernels of
``ops/flash_attention.py``; :func:`ring_attention` (:658),
:func:`ulysses_attention` (:710) and their ``_sharded`` wrappers (:770,
:782). All functions take ``(B, S, H, D)`` q/k/v and return ``(B, S, H,
D)``; the bf16 rounding points are the JAX package's: scores from an
einsum in the input dtype, softmax in f32, probabilities cast back
before the value product.

The reference's blockwise, ring and Ulysses cores are plain tensor
math outside any Pallas kernel, and so are these: PyTorch ops with
gradients. Where the reference runs ring and Ulysses inside
``shard_map`` over a mesh axis, here each rank passes its own sequence
block and the mesh axis whose process group carries the exchange
(``ops/collectives.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops import collectives as col
from kubeflow_tpu_torch.parallel import mesh as pmesh

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
    reference, :508-511), then dQ, dK and dV in one call
    (``flash_attention.flash_bwd``: one kernel at bf16 and D <= 64)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_len, block_q, block_k):
        # local: ops/flash_attention.py imports NEG_INF from this module
        from kubeflow_tpu_torch.ops import flash_attention as fa

        _resolve_tiles("flash_fwd", q, causal, block_q, block_k)
        out, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        from kubeflow_tpu_torch.ops import flash_attention as fa

        q, k, v, out, lse, kv_len = ctx.saved_tensors
        if g.stride(-1) != 1:   # the kernels read rows of the head dim
            g = g.contiguous()
        delta = fa.flash_delta(g, out)
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale, kv_len=kv_len)
        for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            _resolve_tiles(kernel, q, ctx.causal, *ctx.blocks)
        dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None, None


def _resolve_tiles(kernel: str, q, causal: bool, block_q, block_k):
    """One flash pass's tile resolution (``autotune.resolve_flash``),
    recorded for ``autotune.record_resolutions``. The kernels run the
    tile of ``autotune.flash_tile`` whatever resolves: a caller's TPU
    knobs are recorded as an override, not refused."""
    from kubeflow_tpu_torch.ops import autotune

    B, S, H, D = q.shape
    return autotune.resolve_flash(
        kernel, seq=S, head_dim=D, n_heads=H, n_kv_heads=H, dtype=q.dtype,
        causal=causal, block_q=block_q, block_k=block_k, batch=B,
        sms=autotune.sm_count(q.device),
        generation=autotune.backend_generation(q.device))


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """Flash attention with the reference's signature; differentiable in
    q, k and v.

    K and V arrive already GQA-repeated. ``block_q``/``block_k`` are the
    reference's tile knobs: each pass resolves its kernel key through the
    tile table (``ops/autotune.py:resolve_flash``, recorded for
    ``record_resolutions``; explicit knobs as an override), and the CUDA
    kernels run a tile they are compiled for (``autotune.flash_tile``:
    the forward's rows are those whose grid ends first on the card).
    ``kv_len`` is an optional ``(B,)`` int32 valid length per batch
    row; keys at or past it are masked in the forward and both backward
    passes (outputs at padded q positions are unspecified, as in the
    reference).
    """
    return _FlashAttention.apply(q, k, v, causal, sm_scale, kv_len,
                                 block_q, block_k)


# -- blockwise attention: online softmax over KV blocks -----------------------


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def _block_update(carry, k, v, q, q_pos, kv_pos, scale, causal):
    """One online-softmax accumulation step over a KV block.

    carry: ``(o, l, m)`` f32 accumulators, o ``(B, Sq, H, D)``, l and m
    ``(B, Sq, H)``. ``kv_pos``/``q_pos`` are global positions; a
    negative ``kv_pos`` marks padding (masked, causal or not)."""
    o, l, m = carry
    logits = torch.einsum("bshd,bthd->bsht", q, k).float() * scale
    valid = kv_pos[None, :] >= 0
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])   # (Sq, Skv)
    logits = logits.masked_fill(~valid[None, :, None, :], NEG_INF)
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum(
        "bsht,bthd->bshd", p.to(v.dtype), v).float()
    return o, l, m_new


def _init_carry(q: torch.Tensor):
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    return o, l, torch.full_like(l, NEG_INF)


def blockwise_attention(q, k, v, *, causal: bool = True, block_k: int = 512,
                        sm_scale: Optional[float] = None):
    """Memory-efficient attention: the online softmax over KV blocks of
    ``block_k`` (the last one padded and masked), never the whole
    ``(S, S)`` score matrix at once in the forward. Differentiable."""
    B, Sq, H, D = q.shape
    T = k.shape[1]
    block_k = min(block_k, T)
    n_blocks = -(-T // block_k)
    pad = n_blocks * block_k - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = _scale(q, sm_scale)
    q_pos = torch.arange(Sq, device=q.device) + (T - Sq)
    carry = _init_carry(q)
    for j in range(n_blocks):
        kv_pos = j * block_k + torch.arange(block_k, device=q.device)
        kv_pos = torch.where(kv_pos < T, kv_pos, -1)
        sl = slice(j * block_k, (j + 1) * block_k)
        carry = _block_update(carry, k[:, sl], v[:, sl], q, q_pos, kv_pos,
                              scale, causal)
    o, l, _ = carry
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# -- ring attention: sequence-parallel over a mesh axis -----------------------


def _ring_mask(q_pos, kv_pos, causal):
    if not causal:
        return None
    return (kv_pos[None, :] <= q_pos[:, None])[None, :, None, :]


class _RingAttention(torch.autograd.Function):
    """The ring's forward and its transpose in one function, so every
    rank issues the same rotations in the same order whatever blocks
    its causal skip leaves out (autograd through a skipped block would
    drop that rank's share of the backward's exchanges).

    Forward: step ``s`` attends to the KV block of rank ``(idx - s) %
    n`` (skipped when causal and that block is strictly ahead), then
    rotates K/V one hop, every step. Backward runs the steps in reverse:
    K/V rotate back one hop a step (after ``n`` hops forward they are
    home again), and the dK/dV accumulator of each block travels with
    it, so after the last step every rank holds its own block's
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal, scale):
        Sq = q.shape[1]
        q_pos = idx * Sq + torch.arange(Sq, device=q.device)
        carry = _init_carry(q)
        kv = torch.stack([k, v])
        for step in range(n):
            src = (idx - step) % n
            if not (causal and src > idx):
                kv_pos = src * Sq + torch.arange(kv.shape[2],
                                                 device=q.device)
                carry = _block_update(carry, kv[0], kv[1], q, q_pos, kv_pos,
                                      scale, causal)
            kv = col._rotate(kv, group, n, 1)
        o, l, m = carry
        out = (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, n, idx, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, idx, causal, scale = ctx.args
        Sq = q.shape[1]
        q_pos = idx * Sq + torch.arange(Sq, device=q.device)
        qf, do = q.float(), dout.float()
        delta = (do * out.float()).sum(dim=-1)              # (B, Sq, H)
        dq = torch.zeros_like(qf)
        kv = torch.stack([k, v])
        dkv = None
        for step in reversed(range(n)):
            kv = col._rotate(kv, group, n, -1)
            dkv = (torch.zeros(kv.shape, dtype=torch.float32,
                               device=kv.device) if dkv is None
                   else col._rotate(dkv, group, n, -1))
            src = (idx - step) % n
            if causal and src > idx:
                continue
            kb, vb = kv[0].float(), kv[1].float()
            kv_pos = src * Sq + torch.arange(kb.shape[1], device=q.device)
            logits = torch.einsum("bshd,bthd->bsht", q, kv[0]).float()
            logits = logits * scale
            mask = _ring_mask(q_pos, kv_pos, causal)
            if mask is not None:
                logits = logits.masked_fill(~mask, NEG_INF)
            p = torch.exp(logits - lse[..., None])           # (B,Sq,H,T)
            dp = torch.einsum("bshd,bthd->bsht", do, vb)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bsht,bthd->bshd", ds, kb) * scale
            dkv[0] += torch.einsum("bsht,bshd->bthd", ds, qf) * scale
            dkv[1] += torch.einsum("bsht,bshd->bthd", p, do)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, *, mesh, axis_name: str = "tp",
                   causal: bool = True, sm_scale: Optional[float] = None):
    """Sequence-parallel attention over ``axis_name``: rank ``idx`` of
    the axis holds query, key and value block ``idx`` of the sequence
    (``(B, S/n, H, D)``, K/V already GQA-repeated) and gets its output
    block back. K/V rotate one hop a step for ``n`` steps, accumulating
    as :func:`blockwise_attention` does, with masks from global block
    offsets; causally, a block strictly ahead of this rank's queries
    (``src > idx``) is skipped, and the rotation still runs every step.
    At ``n = 1`` the ring's one permutation is ``[(0, 0)]``, and the
    rotation is a copy (``ops/collectives.py``): that is the only branch
    taken on one rank, the reference's identity, not a fallback."""
    group = pmesh.axis_group(mesh, axis_name)
    n = pmesh.axis_size(mesh, axis_name)
    idx = pmesh.axis_index(mesh, axis_name)
    return _RingAttention.apply(q, k, v, group, n, idx, causal,
                                _scale(q, sm_scale))


def ulysses_attention(q, k, v, *, mesh, axis_name: str = "tp",
                      causal: bool = True, sm_scale: Optional[float] = None,
                      block_k: int = 512):
    """DeepSpeed-Ulysses sequence parallelism over ``axis_name``: q/k/v
    arrive sequence-sharded ``(B, S/n, h, D)``; one all-to-all (q, k and
    v packed into one exchange) re-shards them to the full sequence and
    ``h/n`` heads, :func:`blockwise_attention` runs locally, and a second
    all-to-all restores sequence sharding. K/V may carry fewer heads
    than q (GQA): the repeat happens AFTER the exchange, so it moves only
    the distinct KV heads. Needs ``H % n == 0`` and ``KH % n == 0``."""
    n = pmesh.axis_size(mesh, axis_name)
    H, KH = q.shape[2], k.shape[2]
    if H % n or KH % n:
        raise ValueError(
            f"ulysses needs q heads {H} and kv heads {KH} divisible by "
            f"axis size {n}")
    B, s, _, D = q.shape
    packed = torch.cat([t.reshape(B, s, n, t.shape[2] // n, D)
                        for t in (q, k, v)], dim=3).reshape(B, s, -1, D)
    full = col.all_to_all_grad(packed, mesh, axis_name, split_axis=2,
                               concat_axis=1)        # (B, S, (H+2KH)/n, D)
    qg, kg, vg = full.split([H // n, KH // n, KH // n], dim=2)
    kg, vg = gqa_repeat(qg, kg, vg)
    o = blockwise_attention(qg, kg, vg, causal=causal, sm_scale=sm_scale,
                            block_k=block_k)
    return col.all_to_all_grad(o, mesh, axis_name, split_axis=1,
                               concat_axis=2)


def _sharded_seq_attention(core, q, k, v, mesh, seq_axis, batch_axis):
    """Full ``(B, S, H, D)`` arrays in, this rank's block out: the batch
    over ``batch_axis`` (names the mesh lacks dropped), the sequence
    over ``seq_axis``."""
    spec = pmesh.spec_for_mesh(pmesh.PartitionSpec(batch_axis, seq_axis),
                               mesh)
    q, k, v = (pmesh.local_block(t, spec, mesh) for t in (q, k, v))
    return core(q, k, v)


def ring_attention_sharded(q, k, v, mesh, *, seq_axis: str = "tp",
                           batch_axis=("dcn", "dp"), causal: bool = True,
                           sm_scale: Optional[float] = None):
    """:func:`ring_attention` from the full arrays every rank holds; the
    result is this rank's block, batch over ``batch_axis`` (a name, a
    tuple of names or None) and sequence over ``seq_axis``."""
    def core(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis_name=seq_axis,
                              causal=causal, sm_scale=sm_scale)
    return _sharded_seq_attention(core, q, k, v, mesh, seq_axis, batch_axis)


def ulysses_attention_sharded(q, k, v, mesh, *, seq_axis: str = "tp",
                              batch_axis=("dcn", "dp"), causal: bool = True,
                              sm_scale: Optional[float] = None):
    """:func:`ulysses_attention` from the full arrays every rank holds;
    the result is this rank's block, as :func:`ring_attention_sharded`."""
    def core(q, k, v):
        return ulysses_attention(q, k, v, mesh=mesh, axis_name=seq_axis,
                                 causal=causal, sm_scale=sm_scale)
    return _sharded_seq_attention(core, q, k, v, mesh, seq_axis, batch_axis)
