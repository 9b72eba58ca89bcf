"""Autoregressive decoding over the paged KV cache, and the sampler.

PyTorch port of ``kubeflow_tpu/models/decode.py`` (paged half). The
reference threads a flax ``cache`` collection through jitted functions;
here the cache is a :class:`~kubeflow_tpu_torch.models.transformer.
PagedKVCache` of explicit tensors — K/V pools ``(L, P, ps, KH, Dh)``,
``positions (B,)``, ``pages (B, n_log)`` — and every function updates
it IN PLACE (the reference returns a new cache; the port saves the
copy). Functions still return the cache so call sites read alike.

Sampling takes its randomness as Gumbel noise ``(B, V)``
(:func:`kubeflow_tpu_torch.ops.sampling.gumbel_noise`): a categorical
draw is ``argmax(logits + gumbel)``, the identity ``jax.random.
categorical`` is built on, so the same noise gives the same token in
every sampler and tests can inject it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kubeflow_tpu_torch.models.transformer import (
    PagedKVCache,
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.ops.attention import NEG_INF


def init_cache(config: TransformerConfig, batch: int, *,
               device) -> PagedKVCache:
    """An empty paged cache, every row DISARMED: position ``max_seq_len``
    and an all-sentinel page table, so writes drop and nothing live is
    read until :func:`arm_slot` points a row at real pages."""
    c = config
    if not c.kv_page_size:
        raise NotImplementedError(
            "the dense decode cache is not ported yet; set kv_page_size "
            "(see ROADMAP.md Queue A)")
    shape = (c.n_layers, c.kv_pages, c.kv_page_size, c.n_kv_heads,
             c.head_dim)
    n_log = c.max_seq_len // c.kv_page_size
    return PagedKVCache(
        k=torch.zeros(shape, dtype=c.dtype, device=device),
        v=torch.zeros(shape, dtype=c.dtype, device=device),
        positions=torch.full((batch,), c.max_seq_len, dtype=torch.int32,
                             device=device),
        pages=torch.full((batch, n_log), c.kv_pages, dtype=torch.int32,
                         device=device),
        attention_impl=c.paged_attention_impl)


def arm_slot(cache: PagedKVCache, slot: int, start: int,
             page_row) -> PagedKVCache:
    """Point one row's position and page table at host truth — admission,
    page growth and retirement are this page-map surgery, never a KV
    copy."""
    cache.positions[slot] = int(start)
    cache.pages[slot] = torch.as_tensor(page_row, dtype=torch.int32)
    return cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy one physical page (K and V, every layer) ``src`` → ``dst``:
    the copy-on-write split of a shared boundary page."""
    cache.k[:, int(dst)] = cache.k[:, int(src)]
    cache.v[:, int(dst)] = cache.v[:, int(src)]
    return cache


def prefill(model: Transformer, cache: PagedKVCache, tokens: torch.Tensor,
            true_len=None) -> Tuple[torch.Tensor, PagedKVCache]:
    """Run right-padded prompts ``(B, S)`` through rows whose tables are
    armed at position 0, then pull each row's position back to its true
    length (scalar or ``(B,)``). Returns each row's last real token's
    logits ``(B, V)``."""
    B, S = tokens.shape
    lens = torch.broadcast_to(torch.as_tensor(
        S if true_len is None else true_len, dtype=torch.int32,
        device=tokens.device), (B,))
    logits = model(tokens, cache)
    cache.positions.copy_(lens)
    last = logits[torch.arange(B, device=tokens.device), lens.long() - 1]
    return last, cache


def prefill_chunk(model: Transformer, cache: PagedKVCache,
                  tokens: torch.Tensor, slot: int, start: int,
                  true_n: int) -> Tuple[torch.Tensor, PagedKVCache]:
    """One prompt chunk ``(1, C)`` for ONE slot: the chunk writes from
    the host-authoritative ``start`` through the slot's page row, and
    the slot's position lands on ``start + true_n`` (the pad tail's
    KV stays in the slot's own pages, causally masked until decode
    overwrites it). Returns the last real token's logits ``(1, V)``."""
    dev = tokens.device
    view = PagedKVCache(
        k=cache.k, v=cache.v,
        positions=torch.tensor([int(start)], dtype=torch.int32, device=dev),
        pages=cache.pages[slot:slot + 1],
        attention_impl=cache.attention_impl)
    logits = model(tokens, view)
    cache.positions[slot] = int(start) + int(true_n)
    return logits[:, int(true_n) - 1], cache


def decode_step(model: Transformer, cache: PagedKVCache,
                token: torch.Tensor) -> Tuple[torch.Tensor, PagedKVCache]:
    """One token per row in, its logits ``(B, V)`` out; every row's
    position advances by one."""
    return model(token[:, None], cache)[:, 0], cache


def _per_row(x, B: int, dtype, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype,
                                              device=device), (B,))


def sample_logits(logits: torch.Tensor, gumbel: torch.Tensor, *,
                  temperature=1.0, top_k=0, top_p=1.0,
                  bound: Optional[int] = None) -> torch.Tensor:
    """Sample ``(B,)`` int32 token ids from ``(B, V)`` logits.

    Semantics of the reference's ``sample_logits``: per-row (or scalar)
    ``temperature`` (<= 0 → argmax), ``top_k`` (<= 0 or >= V → off),
    ``top_p`` (>= 1 → a strict no-op), composed temperature → top-k →
    top-p. ``bound=None`` (or 0) is the exact path: one descending sort
    drives both filters. ``bound=M`` is the bounded path over the top-M
    candidates: top-k clamps to M, nucleus masses stay exact (full-vocab
    logsumexp), unfiltered rows draw from the full vocabulary.

    ``gumbel`` is ``(B, V)`` noise; categorical draws are
    ``argmax(masked + gumbel)`` (the bounded path uses its first M
    columns over the sorted candidates).
    """
    B, V = logits.shape
    dev = logits.device
    logits = logits.float()
    temp = _per_row(temperature, B, torch.float32, dev)
    k = _per_row(top_k, B, torch.int64, dev)
    p = _per_row(top_p, B, torch.float32, dev)
    greedy_row = temp <= 0.0
    scaled = logits / torch.where(greedy_row, torch.ones_like(temp),
                                  temp)[:, None]
    argmax = torch.argmax(logits, dim=-1)

    if bound is not None and 0 < int(bound) < V:
        M = int(bound)
        topv, topi = torch.topk(scaled, M, dim=-1)  # descending
        k_eff = torch.where(k <= 0, torch.full_like(k, M), k.clamp(max=M))
        kmask = torch.arange(M, device=dev)[None, :] < k_eff[:, None]
        full_lse = torch.logsumexp(scaled, dim=-1)
        k_lse = torch.logsumexp(torch.where(kmask, topv, NEG_INF), dim=-1)
        denom = torch.where(k <= 0, full_lse, k_lse)
        probs = torch.exp(topv - denom[:, None]) * kmask
        before = torch.cumsum(probs, dim=-1) - probs
        keep = kmask & ((before < p[:, None]) | (p[:, None] >= 1.0))
        choice = torch.argmax(torch.where(keep, topv, NEG_INF)
                              + gumbel[:, :M], dim=-1)
        bounded_tok = torch.gather(topi, 1, choice[:, None])[:, 0]
        unfiltered = (k <= 0) & (p >= 1.0)
        full_tok = torch.argmax(scaled + gumbel, dim=-1)
        out = torch.where(greedy_row, argmax,
                          torch.where(unfiltered, full_tok, bounded_tok))
        return out.to(torch.int32)

    srt = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(k <= 0, torch.full_like(k, V), k.clamp(max=V))
    kth = torch.gather(srt, 1, (k_eff - 1)[:, None])
    keep = scaled >= kth
    srt_masked = torch.where(
        torch.arange(V, device=dev)[None, :] < k_eff[:, None], srt, NEG_INF)
    probs = torch.softmax(srt_masked, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    # p >= 1 must be a strict no-op even when cumsum rounding pushes a
    # tail token's before-mass to exactly 1.0
    kept_sorted = (before < p[:, None]) | (p[:, None] >= 1.0)
    n_kept = kept_sorted.sum(dim=-1)  # >= 1
    p_thresh = torch.gather(srt, 1, (n_kept - 1)[:, None])
    keep = keep & (scaled >= p_thresh)
    masked = torch.where(keep, scaled, NEG_INF)
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(greedy_row, argmax, sampled).to(torch.int32)
