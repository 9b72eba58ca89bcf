"""Autoregressive decoding over the dense or the paged KV cache, and the
sampler.

PyTorch port of ``kubeflow_tpu/models/decode.py``. The reference threads
a flax ``cache`` collection through jitted functions; here the cache is
explicit tensors, and every function updates it IN PLACE (the reference
returns a new cache; the port saves the copy). Functions still return
the cache so call sites read alike.

- :class:`~kubeflow_tpu_torch.models.transformer.DenseKVCache`: K/V rows
  ``(L, B, max_seq_len, KH, Dh)`` and ``positions (B,)``. A prefill
  starts from a fresh cache (:func:`init_cache`) at position 0, like the
  reference's, which always starts from a new one.
- :class:`~kubeflow_tpu_torch.models.transformer.PagedKVCache`: K/V
  pools ``(L, P, ps, KH, Dh)``, ``positions (B,)``, ``pages (B, n_log)``.

Greedy speculative decoding (:func:`speculative_generate`) runs a small
draft model beside the target over two dense caches and rolls rejected
proposals back by resetting each row's write position.

Sampling takes its randomness as Gumbel noise ``(B, V)``
(:func:`kubeflow_tpu_torch.ops.sampling.gumbel_noise`): a categorical
draw is ``argmax(logits + gumbel)``, the identity ``jax.random.
categorical`` is built on, so the same noise gives the same token in
every sampler and tests can inject it. :func:`generate` draws its noise
from ``(seed, step)``: reproducible per seed, but not the bits
``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import (
    DenseKVCache,
    PagedKVCache,
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.ops.attention import NEG_INF
from kubeflow_tpu_torch.ops.sampling import noise_seed, uniform_to_gumbel

Cache = Union[DenseKVCache, PagedKVCache]


def init_cache(config: TransformerConfig, batch: int, *,
               device) -> Cache:
    """An empty decode cache for ``batch`` rows.

    ``kv_page_size == 0``: the dense cache, zeros at position 0.
    Otherwise the paged cache, every row DISARMED: position
    ``max_seq_len`` and an all-sentinel page table, so writes drop and
    nothing live is read until :func:`arm_slot` points a row at real
    pages."""
    c = config
    if not c.kv_page_size:
        shape = (c.n_layers, batch, c.max_seq_len, c.n_kv_heads,
                 c.head_dim)
        return DenseKVCache(
            k=torch.zeros(shape, dtype=c.dtype, device=device),
            v=torch.zeros(shape, dtype=c.dtype, device=device),
            positions=torch.zeros((batch,), dtype=torch.int32,
                                  device=device))
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


def _lengths(x, B: int, device) -> torch.Tensor:
    n = torch.as_tensor(x, dtype=torch.int32, device=device)
    if n.dim() > 1:
        raise ValueError("lengths must be a scalar or a (B,) vector")
    return torch.broadcast_to(n, (B,))


def prefill(model: Transformer, cache: Cache, tokens: torch.Tensor,
            true_len=None) -> Tuple[torch.Tensor, Cache]:
    """Run right-padded prompts ``(B, S)`` through rows at position 0 (a
    fresh dense cache, or paged rows armed at 0), then pull each row's
    position back to its true length (scalar or ``(B,)``; default
    ``S``): its generated tokens overwrite the pad tail, which stays
    causally masked until then. Returns each row's last real token's
    logits ``(B, V)``."""
    B, S = tokens.shape
    lens = _lengths(S if true_len is None else true_len, B, tokens.device)
    logits = model(tokens, cache)
    cache.positions.copy_(lens)
    last = logits[torch.arange(B, device=tokens.device), lens.long() - 1]
    return last, cache


def prefill_continue(model: Transformer, cache: Cache,
                     tokens: torch.Tensor, suffix_len, total_len
                     ) -> Tuple[torch.Tensor, Cache]:
    """Extend a prefilled cache by a right-padded suffix ``(B, S)``.

    The prefix-caching primitive: ``cache`` holds a prompt prefix with
    its positions at the prefix length (rows sharing a start take the
    slice write; per-row starts need ``config.ragged_decode``);
    ``suffix_len`` is each row's true suffix length and ``total_len``
    its full prompt length. Returns the last real token's logits with
    the cache positioned at ``total_len`` — :func:`prefill`'s contract
    at the suffix's cost."""
    B = tokens.shape[0]
    suffix = _lengths(suffix_len, B, tokens.device)
    total = _lengths(total_len, B, tokens.device)
    logits = model(tokens, cache)
    cache.positions.copy_(total)
    last = logits[torch.arange(B, device=tokens.device),
                  suffix.long() - 1]
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


def decode_step(model: Transformer, cache: Cache,
                token: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One token per row in, its logits ``(B, V)`` out; every row's
    position advances by one."""
    return model(token[:, None], cache)[:, 0], cache


def _longest(true_len, width: int) -> int:
    """The longest true prompt length (``width`` when none is given)."""
    if true_len is None:
        return width
    if isinstance(true_len, torch.Tensor):
        true_len = true_len.cpu()
    return int(np.max(np.asarray(true_len)))


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


def _batch_gumbel(seed: int, step: int, B: int, V: int,
                  device) -> torch.Tensor:
    """``(B, V)`` Gumbel noise from one generator seeded by ``(seed,
    step)``: the rows of a batch draw apart, as the reference's one key
    over the ``(B, V)`` categorical does."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(noise_seed(seed, step))
    return uniform_to_gumbel(torch.rand((B, V), generator=gen,
                                        device=device))


@torch.no_grad()
def generate(model: Transformer, prompt: torch.Tensor, *,
             max_new_tokens: int, true_len=None, temperature=0.0,
             top_k=0, top_p=1.0, seed: Optional[int] = None
             ) -> torch.Tensor:
    """Prefill + decode over a fresh dense cache; ``(B, max_new_tokens)``
    int32 on the prompt's device.

    ``prompt`` is ``(B, S)`` right-padded with true lengths ``true_len``
    (scalar or ``(B,)``, default ``S``). ``temperature`` 0 is greedy;
    otherwise rows sample through :func:`sample_logits` (exact path),
    ``top_k``/``top_p`` as scalars or ``(B,)``, with noise drawn from
    ``(seed, step)``. Validation is the reference's: a sampled run needs
    a seed, ``temperature >= 0``, ``top_k >= 0``, ``top_p`` in (0, 1],
    and the prompt plus the new tokens must fit ``max_seq_len``."""
    c = model.config
    greedy = isinstance(temperature, (int, float)) and temperature == 0.0
    if not greedy:
        if seed is None:
            raise ValueError("sampling (temperature > 0) needs a seed")
        if isinstance(temperature, (int, float)) and temperature < 0:
            raise ValueError("temperature must be >= 0")
    if isinstance(top_k, int) and top_k < 0:
        raise ValueError("top_k must be >= 0 (0 = no filter)")
    if isinstance(top_p, (int, float)) and not 0.0 < top_p <= 1.0:
        raise ValueError("top_p must be in (0, 1]")
    B, S = prompt.shape
    start = _longest(true_len, S)
    if start + max_new_tokens > c.max_seq_len:
        raise ValueError(
            f"prompt length {start} + max_new_tokens {max_new_tokens} "
            f"exceeds max_seq_len {c.max_seq_len}: cache writes past the "
            "end would be dropped")
    dev = prompt.device
    cache = init_cache(dataclasses.replace(c, kv_page_size=0), B,
                       device=dev)

    def pick(logits, step):
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        noise = _batch_gumbel(seed, step, B, logits.shape[-1], dev)
        return sample_logits(logits, noise, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    logits, cache = prefill(model, cache, prompt, true_len)
    tok = pick(logits, 0)
    out = [tok]
    for step in range(1, max_new_tokens):
        logits, cache = decode_step(model, cache, tok)
        tok = pick(logits, step)
        out.append(tok)
    return torch.stack(out, dim=1)


def make_generate(config: TransformerConfig, *, max_new_tokens: int,
                  temperature=0.0, top_k=0, top_p=1.0):
    """A generate closure ``(model, prompt, true_len, seed) -> tokens``
    with the sampling settings fixed (the reference's jitted closure);
    ``model`` must carry ``config``."""

    def fn(model: Transformer, prompt: torch.Tensor, true_len,
           seed: Optional[int]) -> torch.Tensor:
        if model.config != config:
            raise ValueError("model config differs from the closure's")
        return generate(model, prompt, max_new_tokens=max_new_tokens,
                        true_len=true_len, temperature=temperature,
                        top_k=top_k, top_p=top_p, seed=seed)

    return fn


# -- speculative decoding ------------------------------------------------------


def _spec_validate(config: TransformerConfig,
                   draft_config: TransformerConfig, prompt_width: int,
                   max_new_tokens: int, k: int, true_len) -> None:
    """The reference's eager checks: ``draft_len >= 1``, one vocabulary,
    and slack for ``k`` in-flight proposals past the output in both
    contexts (from the longest TRUE prompt when lengths are given)."""
    if k < 1:
        raise ValueError("draft_len must be >= 1")
    if config.vocab_size != draft_config.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    start = _longest(true_len, prompt_width)
    for name, c in (("target", config), ("draft", draft_config)):
        if start + max_new_tokens + k > c.max_seq_len:
            raise ValueError(
                f"prompt {start} + max_new_tokens {max_new_tokens} + "
                f"draft_len {k} exceeds {name} max_seq_len "
                f"{c.max_seq_len} (speculation needs slack for "
                "in-flight proposals)")


def _spec_round(model: Transformer, draft: Transformer,
                t_cache: DenseKVCache, d_cache: DenseKVCache,
                pending: torch.Tensor, k: int):
    """One propose-verify-rollback round (the reference's
    ``_spec_round_body``): the draft proposes ``x1..xk`` greedily, the
    target verifies ``(pending, x1..x_{k-1})`` in ONE forward that writes
    each row from its own position, and both caches roll back to the
    accepted length by resetting positions (token t sits at slot t, so
    the stale tail is overwritten before it can be attended).

    Returns ``(out (B, k), m (B,), new_pending (B,), n (B,))``: the
    emitted tokens (the first ``m`` of each row are real), and ``n`` the
    accepted proposals. A row whose writes would pass ``max_seq_len``
    (a fast row of a ragged batch overshooting) writes nothing there;
    only its discarded tail depends on it."""
    B = pending.shape[0]
    dev = pending.device
    tok, xs = pending, []
    for _ in range(k):
        logits, _ = decode_step(draft, d_cache, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        xs.append(tok)
    xs = torch.stack(xs, dim=1)                               # (B, k)
    seq = torch.cat([pending[:, None], xs[:, :k - 1]], dim=1)
    preds = torch.argmax(model(seq, t_cache, ragged=True),
                         dim=-1).to(torch.int32)              # (B, k)
    n = torch.cumprod((xs == preds).to(torch.int32), dim=1).sum(dim=1)
    idx = torch.arange(k, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    correction = preds[rows, n.clamp(max=k - 1)]
    out = torch.where(idx < n[:, None], xs, 0)
    out = torch.where(idx == n[:, None], correction[:, None], out)
    m = torch.where(n < k, n + 1, k)
    new_pending = torch.where(n < k, correction, xs[:, k - 1])
    # the verify advanced every row k slots and the draft k slots; only
    # (pending, x1..x_n) are valid: n+1 on a rejection, all k on a full
    # acceptance (x_k was proposed, never written)
    delta = (k - n - 1).clamp(min=0).to(torch.int32)
    t_cache.positions.sub_(delta)
    d_cache.positions.sub_(delta)
    return out, m, new_pending, n


@torch.no_grad()
def speculative_generate(model: Transformer, draft: Transformer,
                         prompt: torch.Tensor, *, max_new_tokens: int,
                         draft_len: int = 4, true_len=None):
    """Greedy speculative decoding: the draft proposes ``draft_len``
    tokens a round, the target verifies them in one multi-token forward,
    and every accepted token costs the target 1/draft_len of a step.

    The output is ``generate(model, prompt, ...)``'s greedy stream token
    for token at f32 (a proposal is accepted iff it equals the target's
    argmax); at bf16 the k-token verify and the 1-token step may resolve
    a near-tie differently, as in the reference. Ragged rows
    (``true_len`` ``(B,)``) accept independently; a finished row keeps
    stepping until the slowest row is done.

    Returns ``(tokens (B, max_new_tokens) int32, stats)``, ``stats =
    {"rounds", "draft_tokens": rounds * draft_len, "accepted"}`` as
    Python ints. One host sync a round decides whether another runs."""
    B, S = prompt.shape
    k = int(draft_len)
    _spec_validate(model.config, draft.config, S, max_new_tokens, k,
                   true_len)
    dev = prompt.device
    t_cache = init_cache(dataclasses.replace(model.config, kv_page_size=0),
                         B, device=dev)
    d_cache = init_cache(dataclasses.replace(draft.config, kv_page_size=0),
                         B, device=dev)
    t_logits, t_cache = prefill(model, t_cache, prompt, true_len)
    _, d_cache = prefill(draft, d_cache, prompt, true_len)
    first = torch.argmax(t_logits, dim=-1).to(torch.int32)
    # slack: a row one short of max_new can still emit k tokens
    cap = max_new_tokens + k + 1
    out_buf = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    out_buf[:, 0] = first
    counts = torch.ones((B,), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    idx = torch.arange(k, device=dev)[None, :]
    pending = first
    rounds = 0
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    while int(counts.min()) < max_new_tokens:
        out, m, pending, n = _spec_round(model, draft, t_cache, d_cache,
                                         pending, k)
        # rows past their count write into the buffer's slack columns
        pos = (counts[:, None] + idx).clamp(max=cap - 1)
        keep = idx < m[:, None]
        out_buf[rows.expand_as(pos)[keep], pos[keep]] = out[keep]
        counts += m
        accepted += n.sum()
        rounds += 1
    stats = {"rounds": rounds, "draft_tokens": rounds * k,
             "accepted": int(accepted)}
    return out_buf[:, :max_new_tokens], stats


def speculative_generate_fused(model: Transformer, draft: Transformer,
                               prompt: torch.Tensor, *,
                               max_new_tokens: int, draft_len: int = 4,
                               true_len=None):
    """The reference's one-program variant. Eager PyTorch has no
    traced loop to fuse the rounds into, so this is
    :func:`speculative_generate`: the same round math, tokens and
    stats."""
    return speculative_generate(model, draft, prompt,
                                max_new_tokens=max_new_tokens,
                                draft_len=draft_len, true_len=true_len)


def speculative_generate_jit(model: Transformer, draft: Transformer,
                             prompt: torch.Tensor, *, max_new_tokens: int,
                             draft_len: int = 4, true_len=None):
    """The serving entry (the reference's cached compiled program with
    eager validation): :func:`speculative_generate`, whose slack
    ``ValueError`` fires before any device work and whose stats are
    Python ints."""
    return speculative_generate(model, draft, prompt,
                                max_new_tokens=max_new_tokens,
                                draft_len=draft_len, true_len=true_len)
