"""Decoder-only transformer LM.

PyTorch port of ``kubeflow_tpu/models/transformer.py``.

Parameters keep the JAX package's einsum layouts — ``q_proj``/``k_proj``/
``v_proj`` ``(D, H, Dh)``, ``o_proj`` ``(H, Dh, D)``, MLP ``(D, F)``/
``(F, D)``, tied ``token_embed`` ``(V, D)`` — so weights carry across
unchanged (``models/convert.py``). Layers are an ``nn.ModuleList``: the
JAX ``nn.scan`` becomes a plain loop and its stacked layer axis becomes
the list index.

The bf16 rounding points are the reference's: projections are
``x @ w.to(dtype)``; rope runs in the activation dtype; attention scores
come from an einsum in the activation dtype and are then widened to f32;
probabilities are cast back before the value product; RMSNorm runs in
f32. (Compute-dtype copies of the f32 weights are made once and reused,
which rounds exactly as casting on every call would.)

Decode mode (a :class:`PagedKVCache` passed to :meth:`Transformer.forward`)
is the PAGED cache of ``_paged_decode_attend``: a pool of ``kv_pages``
pages of ``kv_page_size`` tokens per layer, shared by the batch through
a per-row page table. The pools are updated IN PLACE (the reference's
functional cache update, without the copy).

- Writes scatter each token to ``(pages[b, pos // ps], pos % ps)``. The
  reference relies on ``scatter(mode="drop")`` for writes through the
  sentinel page ``P`` or past ``max_seq_len``; torch has no dropping
  scatter, so those writes are removed by an explicit mask — they never
  wrap or clamp onto a live page.
- Single-token steps attend through :func:`~kubeflow_tpu_torch.ops.
  paged_attention.paged_decode_attention` when the cache's
  ``attention_impl`` is ``"kernel"`` (or ``"auto"`` on CUDA); everything
  else — prefill chunks and the ``"gather"`` impl — gathers each row's
  logical view (sentinel entries clamp to page ``P-1``, as
  ``jnp.take(mode="clip")`` does, and are causally masked) before the
  exact attention math.

Not yet ported (later slices, see ROADMAP.md): the dense decode cache,
MoE, and the flash/blockwise/ring/ulysses attention cores.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.ops.attention import (
    NEG_INF,
    gqa_repeat,
    reference_attention,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(x: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or a numpy/JAX dtype."""
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else getattr(x, "name", None)
    if name is None:
        name = np.dtype(x).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {x!r}")
    return _DTYPES[name]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to kubeflow_tpu_torch yet; see ROADMAP.md "
        "Queue A")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's fields, one for one, so exports parse unchanged.

    The tile knobs (``attention_block_*``, ``paged_head_block``) are TPU
    tuning and drive nothing here; ``seq_axis``/``rules``/``remat``/
    ``scan_layers`` are accepted for the same reason. ``ragged_decode``
    only selects between dense-cache write paths; the paged cache takes
    per-row positions for every ``S``.
    """

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    n_experts: int = 0
    experts_per_token: int = 2
    moe_capacity_factor: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True
    logits_softcap: float = 0.0
    attention_impl: str = "dense"
    attention_block_k: Optional[int] = None
    attention_block_q: Optional[int] = None
    causal: bool = True
    seq_axis: str = "tp"
    # logical-axis -> mesh-axis sharding rules (the reference's
    # DEFAULT_RULES); accepted so configs round-trip, unused until mesh
    # serving is ported
    rules: Any = (("batch", ("dcn", "dp")), ("stage", ("pp",)),
                  ("embed", None), ("seq", ("tp",)), ("heads", ("tp",)),
                  ("kv", None), ("mlp", ("tp",)), ("vocab", ("tp",)),
                  ("expert", ("dp",)), ("expert_mlp", ("tp",)))
    ragged_decode: bool = False
    kv_page_size: int = 0
    kv_pages: int = 0
    paged_attention_impl: str = "auto"
    paged_head_block: Optional[int] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype",
                           torch_dtype(self.param_dtype))

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.n_experts and self.experts_per_token > self.n_experts:
            raise ValueError("experts_per_token > n_experts")
        if self.attention_impl not in ("dense", "blockwise", "flash",
                                       "ring", "ulysses", "auto"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        for knob in ("attention_block_q", "attention_block_k",
                     "paged_head_block"):
            v = getattr(self, knob)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 1):
                raise ValueError(
                    f"{knob} must be None (tile-table/auto) or a "
                    f"positive int, got {v!r}")
        if self.kv_page_size:
            if self.max_seq_len % self.kv_page_size:
                raise ValueError(
                    f"kv_page_size {self.kv_page_size} must divide "
                    f"max_seq_len {self.max_seq_len}")
            if self.kv_pages < 1:
                raise ValueError("paged decode needs kv_pages >= 1")
        if self.paged_attention_impl not in ("auto", "gather", "kernel"):
            raise ValueError(
                f"unknown paged_attention_impl "
                f"{self.paged_attention_impl!r}; valid: auto, gather, "
                "kernel")


@dataclasses.dataclass
class PagedKVCache:
    """The paged decode cache as explicit tensors (the reference's flax
    ``cache`` collection): per-layer K/V pools and the per-row state
    every layer shares."""

    k: torch.Tensor          # (L, P, ps, KH, Dh), activation dtype
    v: torch.Tensor          # (L, P, ps, KH, Dh)
    positions: torch.Tensor  # (B,) int32: each row's next write position
    pages: torch.Tensor      # (B, n_log) int32: logical → physical page
    # single-token attention core: "kernel" (ops/paged_attention.py),
    # "gather" (the dense logical view, the parity oracle), or "auto"
    # (the kernel on CUDA, the gather elsewhere)
    attention_impl: str = "auto"


def _compute(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``, made once per weight version and reused."""
    if w.dtype == dtype:
        return w
    hit = getattr(w, "_kftpu_compute", None)
    if (hit is not None and hit[0] == w._version and hit[1] == dtype
            and hit[2].device == w.device):
        return hit[2]
    c = w.detach().to(dtype)
    w._kftpu_compute = (w._version, dtype, c)
    return c


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6,
                 param_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        var = x.square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        return (x * self.scale).to(dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                          dtype=torch.float32,
                                          device=device) / head_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)  # (S, Dh/2)
    return torch.sin(angles), torch.cos(angles)


def _rotate(x: torch.Tensor, sin: torch.Tensor,
            cos: torch.Tensor) -> torch.Tensor:
    """The rope rotation core; sin/cos arrive broadcastable to x."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); sin/cos: (S, Dh/2)."""
    return _rotate(x, sin[None, :, None, :].to(x.dtype),
                   cos[None, :, None, :].to(x.dtype))


@dataclasses.dataclass
class _DecodeStep:
    """Per-forward decode quantities every layer shares."""

    q_pos: torch.Tensor          # (B, S) int64
    sin: torch.Tensor            # (B, S, 1, Dh/2), activation dtype
    cos: torch.Tensor
    write: Tuple[torch.Tensor, ...]  # (rows, seq idx, page, offset)
    read_pages: torch.Tensor     # (B, n_log) int64, sentinel clamped
    use_kernel: bool


class Attention(nn.Module):
    def __init__(self, c: TransformerConfig) -> None:
        super().__init__()
        self.c = c
        D, H, KH, Dh = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
        pd = c.param_dtype
        self.q_proj = nn.Parameter(torch.empty(D, H, Dh, dtype=pd))
        self.k_proj = nn.Parameter(torch.empty(D, KH, Dh, dtype=pd))
        self.v_proj = nn.Parameter(torch.empty(D, KH, Dh, dtype=pd))
        self.o_proj = nn.Parameter(torch.empty(H, Dh, D, dtype=pd))

    def _proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        w = _compute(w, self.c.dtype)
        return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])

    def forward(self, x, sin, cos, kv=None,
                step: Optional[_DecodeStep] = None):
        c = self.c
        q = self._proj(x, self.q_proj)
        k = self._proj(x, self.k_proj)
        v = self._proj(x, self.v_proj)
        if kv is not None:
            out = self._paged_decode_attend(q, k, v, kv, step)
        else:
            if c.attention_impl not in ("dense", "auto"):
                raise _not_ported(f"attention_impl={c.attention_impl!r}")
            q = apply_rope(q, sin, cos)
            k = apply_rope(k, sin, cos)
            k, v = gqa_repeat(q, k, v)
            out = reference_attention(q, k, v, causal=c.causal)
        B, S = out.shape[:2]
        wo = _compute(self.o_proj, c.dtype)
        return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])

    def _paged_decode_attend(self, q, k, v, kv, step: _DecodeStep):
        c = self.c
        ck, cv, pages, pos = kv
        B, S, KH, Dh = k.shape
        Smax = c.max_seq_len
        q = _rotate(q, step.sin, step.cos)
        k = _rotate(k, step.sin, step.cos)
        # masked scatter: only writes with a real page land
        rows, seq, pg, off = step.write
        ck[pg, off] = k[rows, seq]
        cv[pg, off] = v[rows, seq]
        if step.use_kernel:
            from kubeflow_tpu_torch.ops.paged_attention import (
                paged_decode_attention,
            )

            out = paged_decode_attention(q[:, 0].contiguous(), ck, cv,
                                         pages, pos, sm_scale=Dh ** -0.5)
            return out[:, None]
        # gather each row's logical view (B, Smax, KH, Dh)
        kc = ck[step.read_pages].reshape(B, Smax, KH, Dh)
        vc = cv[step.read_pages].reshape(B, Smax, KH, Dh)
        kc, vc = gqa_repeat(q, kc, vc)
        logits = torch.einsum("bshd,bthd->bhst", q, kc).float()
        logits = logits * (Dh ** -0.5)
        kv_pos = torch.arange(Smax, device=q.device)
        mask = kv_pos[None, None, :] <= step.q_pos[:, :, None]  # (B,S,T)
        logits = logits.masked_fill(~mask[:, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, vc)


class Mlp(nn.Module):
    def __init__(self, c: TransformerConfig) -> None:
        super().__init__()
        self.c = c
        D, F, pd = c.d_model, c.d_ff, c.param_dtype
        self.gate_proj = nn.Parameter(torch.empty(D, F, dtype=pd))
        self.up_proj = nn.Parameter(torch.empty(D, F, dtype=pd))
        self.down_proj = nn.Parameter(torch.empty(F, D, dtype=pd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.c.dtype
        h = (torch.nn.functional.silu(x @ _compute(self.gate_proj, dt))
             * (x @ _compute(self.up_proj, dt)))
        return h @ _compute(self.down_proj, dt)


class Block(nn.Module):
    def __init__(self, c: TransformerConfig) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(c.d_model, param_dtype=c.param_dtype)
        self.attn = Attention(c)
        self.mlp_norm = RMSNorm(c.d_model, param_dtype=c.param_dtype)
        self.mlp = Mlp(c)

    def forward(self, x, sin, cos, kv=None, step=None):
        x = x + self.attn(self.attn_norm(x), sin, cos, kv, step)
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """``forward(tokens)`` → logits ``(B, S, V)`` f32 (or the final-norm
    hidden states with ``return_hidden=True``); ``forward(tokens,
    cache)`` runs decode mode over a :class:`PagedKVCache` and advances
    its positions by ``S``."""

    def __init__(self, config: TransformerConfig,
                 return_hidden: bool = False) -> None:
        super().__init__()
        config.validate()
        if config.n_experts:
            raise _not_ported("MoE (n_experts > 0)")
        self.config = config
        self.return_hidden = return_hidden
        self.token_embed = nn.Parameter(torch.empty(
            config.vocab_size, config.d_model, dtype=config.param_dtype))
        self.blocks = nn.ModuleList(Block(config)
                                    for _ in range(config.n_layers))
        self.final_norm = RMSNorm(config.d_model,
                                  param_dtype=config.param_dtype)
        self._rope: Dict[Tuple[int, torch.device], Tuple] = {}

    def _tables(self, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (n, torch.device(device))
        if key not in self._rope:
            c = self.config
            self._rope[key] = rope_tables(n, c.head_dim, c.rope_theta,
                                          device)
        return self._rope[key]

    def _decode_step(self, cache: PagedKVCache, S: int,
                     device) -> _DecodeStep:
        c = self.config
        Smax = c.max_seq_len
        P, ps = cache.k.shape[1], cache.k.shape[2]
        if cache.pages.shape[1] * ps != Smax:
            raise ValueError(f"page table {tuple(cache.pages.shape)} x page "
                             f"{ps} does not span max_seq_len {Smax}")
        q_pos = (cache.positions.long()[:, None]
                 + torch.arange(S, device=device)[None, :])  # (B, S)
        safe = q_pos.clamp(max=Smax - 1)
        sin_full, cos_full = self._tables(Smax, device)
        sin = sin_full[safe][:, :, None, :].to(c.dtype)
        cos = cos_full[safe][:, :, None, :].to(c.dtype)
        pages = cache.pages.long()
        pg = torch.gather(pages, 1, safe // ps)
        pg = torch.where(q_pos < Smax, pg, P)
        rows, seq = torch.nonzero((pg >= 0) & (pg < P), as_tuple=True)
        write = (rows, seq, pg[rows, seq], (q_pos % ps)[rows, seq])
        impl = cache.attention_impl
        if impl not in ("auto", "gather", "kernel"):
            raise ValueError(f"unknown paged attention impl {impl!r}")
        use_kernel = S == 1 and (impl == "kernel" or (
            impl == "auto" and torch.device(device).type == "cuda"))
        return _DecodeStep(q_pos=q_pos, sin=sin, cos=cos, write=write,
                           read_pages=pages.clamp(0, P - 1),
                           use_kernel=use_kernel)

    def forward(self, tokens: torch.Tensor,
                cache: Optional[PagedKVCache] = None) -> torch.Tensor:
        c = self.config
        B, S = tokens.shape
        dev = tokens.device
        embed = _compute(self.token_embed, c.dtype)
        x = embed[tokens.long()]
        if cache is None:
            sin, cos = self._tables(S, dev)
            for blk in self.blocks:
                x = blk(x, sin, cos)
        else:
            step = self._decode_step(cache, S, dev)
            for i, blk in enumerate(self.blocks):
                kv = (cache.k[i], cache.v[i], cache.pages, cache.positions)
                x = blk(x, None, None, kv, step)
            cache.positions.add_(S)
        x = self.final_norm(x)
        if self.return_hidden:
            return x
        logits = (x @ embed.t()).float()
        if c.logits_softcap:
            logits = c.logits_softcap * torch.tanh(logits / c.logits_softcap)
        return logits


def tiny_config(**overrides) -> TransformerConfig:
    """The reference's ``tiny_config()``: small enough for CPU tests."""
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64,
                dtype=torch.float32, remat=False)
    base.update(overrides)
    return TransformerConfig(**base)
