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
f32. Where no gradient is wanted, compute-dtype copies of the f32
weights are made once and reused (rounding exactly as casting on every
call would); under autograd the cast stays in the graph, so gradients
reach the f32 parameters as they do through JAX's ``w.astype(dtype)``.

Training (no cache): ``attention_impl="flash"`` runs the CUDA flash
kernels through :func:`~kubeflow_tpu_torch.ops.attention.flash_attention`
(their plain versions on CPU tensors); ``"auto"`` is flash on CUDA and
dense elsewhere, as the reference picks flash on the TPU and dense
elsewhere. ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat(Block)``).
:func:`run_blocks` runs a block stack for training; it carries the
per-row ``kv_len`` padding mask of the BERT encoder (``models/bert.py``)
to the dense and flash cores, and any other core refuses it.

Decode mode takes a cache in :meth:`Transformer.forward`; its type
picks the reference's attention core, and the cache is updated IN PLACE
(the reference's functional cache update, without the copy).

A :class:`DenseKVCache` is ``_decode_attend``'s dense cache: K/V rows
``(L, B, max_seq_len, KH, Dh)`` where token ``t`` of a row sits at
position ``t``, and a per-row write position. Three write cases, as in
the reference: a single-token step writes each row at its own position;
``ragged_decode`` multi-token forwards write each row from its own
start; other multi-token forwards (prefill) share row 0's start, which
is clamped so the slice fits as ``dynamic_update_slice`` clamps it.
Attention then runs over all of ``max_seq_len`` under the causal bound
``kv_pos <= q_pos``. The reference drops per-row writes past
``max_seq_len`` (its scatter's out-of-bounds rule); torch raises on
them, so they are removed without a host sync: each write targets its
position modulo ``max_seq_len`` (distinct within a row, since a forward
spans at most ``max_seq_len`` tokens) and keeps the value already there
when its position is out of range. Rope gathers clamp to the last
position; the rows that read a clamped value are past their context and
nothing reads their output (the reference fills NaN there).

A :class:`PagedKVCache` is the PAGED cache of ``_paged_decode_attend``:
a pool of ``kv_pages`` pages of ``kv_page_size`` tokens per layer, shared
by the batch through a per-row page table.

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

MoE (``n_experts > 0``) replaces each block's MLP with
:class:`MoeMlp`: the reference's exact dense top-k dispatch, or with
``moe_capacity_factor > 0`` its capacity dispatch on one device
(:mod:`kubeflow_tpu_torch.ops.moe`). The reference ``sow``s each layer's
Switch auxiliary loss into a ``"losses"`` collection; here a training
forward returns it when asked (``return_aux=True``: the sum over the
layers, as the reference's train step sums the collection), so nothing
about it outlives the call.

``attention_impl="blockwise"`` runs the online-softmax core; ``"ring"``
and ``"ulysses"`` run their sequence-parallel cores over
``config.seq_axis`` when the model is built over a mesh, and the
blockwise core without one, as the reference falls back without a mesh
(all in ``ops/attention.py``).

Built over a mesh (``Transformer(config, mesh=mesh)``, see
``parallel/mesh.py``), each rank holds the block of every parameter
that the reference's rules table (:data:`_PARAM_AXES` through
``config.rules``, ``spec_for_mesh`` and ``shape_aware_spec``) assigns
it, and the forward issues the collectives GSPMD derives in the
reference:

- **Tensor parallelism** over ``tp``: heads, ``mlp`` and ``vocab`` are
  split. Attention and the MLP take their input through
  ``copy_to`` and return through ``reduce_from`` (Megatron's f and g:
  one all-reduce forward and one backward, each). Flash and the other
  cores run on the rank's ``H/tp`` heads. GQA kv heads that ``tp`` does
  not divide are replicated, as ``shape_aware_spec`` replicates them;
  each rank then picks the kv head of each of its q heads by the global
  head index, and the replicated projections take their input through
  ``copy_to`` so their gradient sums over ``tp``. The tied embedding's
  lookup keeps ``jnp.take``'s meaning under the ``vocab`` split: an id
  in ``[-V, 0)`` wraps before the shard test, each rank gives the rows
  it owns and zeros elsewhere, the sum over ``tp`` is the row, and an id
  owned by no shard reads NaN. The unembedding gives this rank's
  vocabulary block of the logits (the loss is vocab-parallel,
  ``train/trainer.py``).
- **Context parallelism** under ``"ring"``/``"ulysses"``: each rank of
  ``seq_axis`` runs its block of the sequence (positions ``[r S/n,
  (r+1) S/n)``, RoPE at the global positions), the parameters are
  whole on every rank of that axis (their gradients sum over it in the
  train step), and attention exchanges K/V over the axis. The output is
  this rank's block of the sequence. The reference instead keeps the
  head-sharded projections and lets GSPMD reshard the sequence around
  attention; the numbers are the same.

- **Expert parallelism** for MoE layers: the experts' weights are split
  over ``dp`` by their ``expert`` axis and over ``tp`` by their
  ``expert_mlp`` axis; the router is whole on every rank. The dense
  dispatch gathers the expert shards over ``dp`` (``all_gather_grad``:
  the backward reduce-scatters, so an expert's gradient arrives summed
  over ``dp``), as GSPMD gathers them in the reference, and splits the
  experts' hidden width over ``tp`` as the MLP does; the combine weights
  enter that tp-split product through ``copy_to``, so the router's
  gradient sums the ranks' partial products. The capacity dispatch
  (``ops/moe.py``) fills the reference's global slots and moves the
  buffers to the experts' owners. The load-balance loss is the global
  batch's.
- **Pipeline stages** over ``pp``: a model built over ``pp > 1`` holds
  its stage's ``L / pp`` blocks only, under their global names
  (``blocks.{r L/pp + i}``), and their specs lead with ``"pp"`` (the
  ``stage`` rule on the reference's stacked layer axis). It trains
  through ``parallel/pipeline.py:make_pipelined_lm_forward``; its plain
  forward refuses.

- **Decoding** on a model split over ``tp`` (mesh serving): every rank
  runs the same decode forward on its heads and its block of the MLP
  and of the vocabulary; its cache holds its kv heads
  (:attr:`Transformer.cache_kv_heads`: ``KH/tp``, or all of them,
  replicated, where ``tp`` does not divide them). The embedding keeps
  ``_take_rows_split``; the output projection and the MLP return
  through ``reduce_from``; the logits' vocabulary blocks are gathered
  over ``tp`` into the full row on every rank, as GSPMD gathers them
  under the reference's sampler. With replicated kv heads the paged
  kernel reads, in place, the window of the pool's kv heads that this
  rank's q heads map to (:func:`kv_window`), with this rank's q heads
  among zeros only where they span more than one kv head. Decoding from
  a MoE model split over a mesh, or from a pipeline stage, refuses
  (ROADMAP Queue A 2.8).

Context parallelism for MoE layers and inside the pipeline is not
ported, and refuses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.ops import collectives as col
from kubeflow_tpu_torch.ops.attention import (
    NEG_INF,
    blockwise_attention,
    flash_attention,
    gqa_repeat,
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from kubeflow_tpu_torch.parallel import mesh as pmesh

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


# KV tile of the non-flash cores (blockwise, the Ulysses inner loop)
# when attention_block_k is None: the reference's untuned default
_UNTUNED_BLOCK_K = 1024


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's fields, one for one, so exports parse unchanged.

    The tile knobs (``attention_block_q``, ``paged_head_block``) are TPU
    tuning and drive nothing here; ``attention_block_k`` is the KV tile
    of the blockwise and Ulysses cores (1024 when None, as in the
    reference). ``seq_axis`` is the mesh axis of ring and Ulysses;
    ``rules`` map the parameters' logical axes onto a mesh;
    ``scan_layers`` names the JAX param layout only. ``remat`` recomputes
    each block in the backward of a training forward. ``ragged_decode``
    selects the dense cache's per-row multi-token write; the paged cache
    takes per-row positions for every ``S``.
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
    # logical-axis -> mesh-axis sharding rules
    rules: Any = pmesh.DEFAULT_RULES
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


@dataclasses.dataclass
class DenseKVCache:
    """The dense decode cache as explicit tensors (the reference's flax
    ``cache`` collection in dense mode)."""

    k: torch.Tensor          # (L, B, Smax, KH, Dh), activation dtype
    v: torch.Tensor          # (L, B, Smax, KH, Dh)
    positions: torch.Tensor  # (B,) int32: each row's next write position


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` as the reference's embeddings
    read it: an id in ``[-V, 0)`` wraps to ``id + V``, and any other id
    outside ``[0, V)`` gives a row of NaN. The gather reads a clamped id,
    so a bad id from a request never reaches the card as an
    out-of-range index (a device-side assert would poison the CUDA
    context of every model the process serves)."""
    V = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    rows = table[idx.clamp(0, V - 1)]
    bad = (idx < 0) | (idx >= V)
    return rows.masked_fill(bad[..., None], float("nan"))


def _compute(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``: in the autograd graph when a gradient is wanted,
    else made once per weight version and reused."""
    if w.dtype == dtype:
        return w
    if torch.is_grad_enabled() and w.requires_grad:
        return w.to(dtype)
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


@dataclasses.dataclass
class _DenseStep:
    """Per-forward dense-cache quantities every layer shares."""

    q_pos: torch.Tensor          # (B, S), or (1, S) when rows share a start
    sin: torch.Tensor            # broadcastable to q, activation dtype
    cos: torch.Tensor
    # per-row writes: (rows, positions mod Smax, in range); or, for a
    # shared start, (None, the S positions the slice covers, None)
    write: Tuple[Optional[torch.Tensor], torch.Tensor,
                 Optional[torch.Tensor]]


class Attention(nn.Module):
    # how a model built over a mesh shares out the work (_Split), set by
    # Transformer; None off a mesh
    split = None

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
                step: Optional[_DecodeStep] = None,
                kv_len: Optional[torch.Tensor] = None):
        """``kv_len`` (training forward only) is the per-row valid-length
        padding mask, ``(B,)`` int32 on x's device: keys at or past a
        row's length are masked in every attention."""
        c = self.c
        sp = self.split
        tp = sp.tp if sp is not None else 1
        wk, wv = self.k_proj, self.v_proj
        if tp > 1:
            x = col.copy_to(x, sp.mesh, "tp")
            if not sp.kv_sharded:
                wk = col.copy_to(wk, sp.mesh, "tp")
                wv = col.copy_to(wv, sp.mesh, "tp")
        q = self._proj(x, self.q_proj)
        k = self._proj(x, wk)
        v = self._proj(x, wv)
        if isinstance(step, _DenseStep):
            out = self._dense_decode_attend(q, k, v, kv, step)
        elif kv is not None:
            out = self._paged_decode_attend(q, k, v, kv, step)
        else:
            out = self._attend(q, k, v, sin, cos, kv_len)
        B, S = out.shape[:2]
        wo = _compute(self.o_proj, c.dtype)
        out = out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
        return col.reduce_from(out, sp.mesh, "tp") if tp > 1 else out

    def _replicated_kv(self) -> bool:
        """Whether ``tp`` splits the q heads but not the kv heads (they
        do not divide by it): each rank then holds every kv head."""
        sp = self.split
        return sp is not None and sp.tp > 1 and not sp.kv_sharded

    def _local_kv(self, k, v):
        """``k``/``v`` ``(B, T, KH, Dh)`` cut to the kv head of each of
        this rank's q heads, by the q head's global index, where the kv
        heads are replicated; unchanged otherwise."""
        if not self._replicated_kv():
            return k, v
        sp, c = self.split, self.c
        H = c.n_heads // sp.tp
        head = sp.tp_rank * H + torch.arange(H, device=k.device)
        idx = head // (c.n_heads // c.n_kv_heads)
        return k[:, :, idx], v[:, :, idx]

    def _attend(self, q, k, v, sin, cos, kv_len):
        """The training forward's attention core on this rank's heads."""
        c, sp = self.c, self.split
        impl = c.attention_impl
        if impl == "auto":
            impl = "flash" if q.device.type == "cuda" else "dense"
        if kv_len is not None and impl not in ("dense", "flash"):
            raise ValueError(
                f"kv_len padding mask is not supported by "
                f"attention_impl={impl!r} (dense and flash only)")
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        k, v = self._local_kv(k, v)
        block_k = c.attention_block_k or _UNTUNED_BLOCK_K
        if impl == "ulysses" and sp is not None:
            return ulysses_attention(q, k, v, mesh=sp.mesh,
                                     axis_name=c.seq_axis, causal=c.causal,
                                     block_k=block_k)
        k, v = gqa_repeat(q, k, v)
        if impl == "flash":
            return flash_attention(q, k, v, c.causal, kv_len=kv_len)
        if impl == "dense":
            return reference_attention(q, k, v, causal=c.causal,
                                       kv_len=kv_len)
        if impl == "ring" and sp is not None:
            return ring_attention(q, k, v, mesh=sp.mesh,
                                  axis_name=c.seq_axis, causal=c.causal)
        # blockwise, and ring/ulysses without a mesh (the reference's
        # fallback off a mesh)
        return blockwise_attention(q, k, v, causal=c.causal, block_k=block_k)

    def _dense_decode_attend(self, q, k, v, kv, step: _DenseStep):
        ck, cv = kv
        q = _rotate(q, step.sin, step.cos)
        k = _rotate(k, step.sin, step.cos)
        rows, dest, valid = step.write
        if rows is None:
            ck.index_copy_(1, dest, k)
            cv.index_copy_(1, dest, v)
        else:
            # an out-of-range write keeps the value at its (wrapped) target
            keep = valid[..., None, None]
            ck[rows, dest] = torch.where(keep, k, ck[rows, dest])
            cv[rows, dest] = torch.where(keep, v, cv[rows, dest])
        kc, vc = self._local_kv(ck, cv)
        return _cache_attend(q, kc, vc, step.q_pos, self.c.head_dim)

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

            q1 = q[:, 0]
            if not self._replicated_kv():
                out = paged_decode_attention(q1.contiguous(), ck, cv, pages,
                                             pos, sm_scale=Dh ** -0.5)
                return out[:, None]
            # the pool holds every kv head: the kernel reads the slice of
            # the kv heads this rank's q heads map to, in place. Within
            # one kv head they are its group; across more, the q heads
            # of those kv heads' groups, this rank's among zeros
            H = q1.shape[1]
            kv, off, width = kv_window(self.split.tp_rank * H, H,
                                       c.n_heads // c.n_kv_heads)
            if kv.stop - kv.start > 1 and width > H:
                wide = q1.new_zeros((B, width, Dh))
                wide[:, off:off + H] = q1
                out = paged_decode_attention(
                    wide, ck[:, :, kv], cv[:, :, kv], pages, pos,
                    sm_scale=Dh ** -0.5)[:, off:off + H]
            else:
                out = paged_decode_attention(
                    q1.contiguous(), ck[:, :, kv], cv[:, :, kv], pages, pos,
                    sm_scale=Dh ** -0.5)
            return out[:, None]
        # gather each row's logical view (B, Smax, KH, Dh)
        kc = ck[step.read_pages].reshape(B, Smax, KH, Dh)
        vc = cv[step.read_pages].reshape(B, Smax, KH, Dh)
        kc, vc = self._local_kv(kc, vc)
        return _cache_attend(q, kc, vc, step.q_pos, Dh)


def kv_window(first: int, n: int, group: int) -> Tuple[slice, int, int]:
    """The kv heads that q heads ``first .. first + n - 1`` of a GQA
    layout with ``group`` q heads a kv head read: ``(kv heads, offset,
    width)``, the contiguous kv heads, and where those q heads sit among
    the ``width`` q heads of those kv heads' groups."""
    a, b = first // group, (first + n - 1) // group + 1
    return slice(a, b), first - a * group, (b - a) * group


def _cache_attend(q, kc, vc, q_pos, Dh: int) -> torch.Tensor:
    """Exact attention of ``q`` over every cache position ``(B, Smax)``
    under the causal bound ``kv_pos <= q_pos``: scores in the activation
    dtype widened to f32, probabilities cast back before the value
    product (the reference's rounding points)."""
    kc, vc = gqa_repeat(q, kc, vc)
    logits = torch.einsum("bshd,bthd->bhst", q, kc).float()
    logits = logits * (Dh ** -0.5)
    kv_pos = torch.arange(kc.shape[1], device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B or 1, S, T)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, vc)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, ``jax.nn.silu``'s formula. Not
    ``torch.nn.functional.silu``: under ``FlopCounterMode`` (the step
    telemetry's FLOP probe) its backward decomposes and rounds
    differently, so a probed step would not equal an unprobed one."""
    return x * torch.sigmoid(x)


class Mlp(nn.Module):
    split = None      # as Attention.split

    def __init__(self, c: TransformerConfig) -> None:
        super().__init__()
        self.c = c
        D, F, pd = c.d_model, c.d_ff, c.param_dtype
        self.gate_proj = nn.Parameter(torch.empty(D, F, dtype=pd))
        self.up_proj = nn.Parameter(torch.empty(D, F, dtype=pd))
        self.down_proj = nn.Parameter(torch.empty(F, D, dtype=pd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, sp = self.c.dtype, self.split
        tp = sp.tp if sp is not None else 1
        if tp > 1:
            x = col.copy_to(x, sp.mesh, "tp")
        h = (silu(x @ _compute(self.gate_proj, dt))
             * (x @ _compute(self.up_proj, dt)))
        y = h @ _compute(self.down_proj, dt)
        return col.reduce_from(y, sp.mesh, "tp") if tp > 1 else y


class MoeMlp(nn.Module):
    """The reference's ``MoeMlp``: a router ``(D, E)`` kept in f32 and
    ``E`` SwiGLU experts ``(E, D, F)``/``(E, F, D)``. ``forward`` returns
    ``(y, aux)``, ``aux`` the layer's Switch load-balance loss.

    Dense dispatch (``moe_capacity_factor == 0``): each token keeps its
    top ``experts_per_token`` router logits, softmaxed over those k; the
    combine weights are cast to the compute dtype, every expert runs on
    every token (``bsd,edf->bsef``) and the combine masks the outputs.
    Ties between router logits are possible: ``jax.lax.top_k`` and
    ``torch.topk`` may break them differently, so parity tests draw
    random f32 router logits, where a tie has probability zero.

    Over a mesh: the module docstring's expert parallelism."""

    split = None      # as Attention.split

    def __init__(self, c: TransformerConfig) -> None:
        super().__init__()
        self.c = c
        D, F, E, pd = c.d_model, c.d_ff, c.n_experts, c.param_dtype
        self.router = nn.Parameter(torch.empty(D, E, dtype=torch.float32))
        self.gate_proj = nn.Parameter(torch.empty(E, D, F, dtype=pd))
        self.up_proj = nn.Parameter(torch.empty(E, D, F, dtype=pd))
        self.down_proj = nn.Parameter(torch.empty(E, F, D, dtype=pd))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c, sp = self.c, self.split
        dt, E, K = c.dtype, c.n_experts, c.experts_per_token
        mesh = sp.mesh if sp is not None else None
        tp = sp.tp if sp is not None else 1
        ep = sp.ep_axis if sp is not None else None
        gate_logits = x.float() @ self.router              # (B, S, E)
        if c.moe_capacity_factor > 0:
            from kubeflow_tpu_torch.ops.moe import capacity_moe

            B, S, D = x.shape
            wg, wu, wd = (_compute(w, dt) for w in (
                self.gate_proj, self.up_proj, self.down_proj))

            def expert_fn(xe):                             # (E, C, D)
                if tp > 1:
                    xe = col.copy_to(xe, mesh, "tp")
                h = torch.einsum("ecd,edf->ecf", xe, wg)
                u = torch.einsum("ecd,edf->ecf", xe, wu)
                y = torch.einsum("ecf,efd->ecd", silu(h) * u, wd)
                return col.reduce_from(y, mesh, "tp") if tp > 1 else y

            y, aux = capacity_moe(
                x.reshape(B * S, D), gate_logits.reshape(B * S, E),
                expert_fn, k=K, capacity_factor=c.moe_capacity_factor,
                mesh=mesh, axes=sp.data_axes if sp is not None else (),
                ep_axis=ep)
            return y.reshape(B, S, D), aux
        wg, wu, wd = self.gate_proj, self.up_proj, self.down_proj
        if ep is not None:      # every expert's tp shard, on every rank
            wg, wu, wd = (col.all_gather_grad(w, mesh, ep)
                          for w in (wg, wu, wd))
        wg, wu, wd = (_compute(w, dt) for w in (wg, wu, wd))
        weights, idx = torch.topk(gate_logits, K, dim=-1)
        weights = torch.softmax(weights, dim=-1)           # (B, S, K)
        onehot = torch.nn.functional.one_hot(idx, E).float()
        combine = (onehot * weights[..., None]).sum(dim=2).to(dt)
        xe, ce = x, combine
        if tp > 1:
            xe = col.copy_to(x, mesh, "tp")
            ce = col.copy_to(combine, mesh, "tp")
        h = torch.einsum("bsd,edf->bsef", xe, wg)
        u = torch.einsum("bsd,edf->bsef", xe, wu)
        h = silu(h) * u
        y = torch.einsum("bsef,efd->bsed", h, wd)
        y = torch.einsum("bsed,bse->bsd", y, ce)
        if tp > 1:
            y = col.reduce_from(y, mesh, "tp")
        # Switch load balance: E * sum(fraction routed * mean router prob)
        probs = torch.softmax(gate_logits, dim=-1)
        routed = (combine.float() > 0).float()
        if mesh is None:
            density = routed.mean(dim=(0, 1))
            mean_prob = probs.mean(dim=(0, 1))
        else:
            from kubeflow_tpu_torch.ops.moe import global_mean

            density, mean_prob = global_mean(
                torch.stack([routed.sum(dim=(0, 1)), probs.sum(dim=(0, 1))]),
                x.shape[0] * x.shape[1], mesh, sp.data_axes)
        return y, E * (density * mean_prob).sum()


class Block(nn.Module):
    """``forward`` returns ``(x, aux)``: ``aux`` is the MoE layer's
    load-balance loss, None for a dense MLP."""

    def __init__(self, c: TransformerConfig) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(c.d_model, param_dtype=c.param_dtype)
        self.attn = Attention(c)
        self.mlp_norm = RMSNorm(c.d_model, param_dtype=c.param_dtype)
        if c.n_experts:
            self.moe = MoeMlp(c)
        else:
            self.mlp = Mlp(c)

    def forward(self, x, sin, cos, kv=None, step=None, kv_len=None):
        x = x + self.attn(self.attn_norm(x), sin, cos, kv, step, kv_len)
        h = self.mlp_norm(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.mlp(h), None


def run_blocks(blocks, x, sin, cos, *, remat: bool,
               kv_len: Optional[torch.Tensor] = None,
               return_aux: bool = False):
    """The training forward of a block stack (the reference's scanned or
    unrolled ``Block`` over ``aux = (sin, cos[, kv_len])``); with
    ``remat`` and autograd on, each block is recomputed in the backward
    (``torch.utils.checkpoint``, the mask passed through). With
    ``return_aux`` it returns ``(x, aux)``, ``aux`` the sum of the MoE
    layers' load-balance losses (0.0 without MoE)."""
    remat = remat and torch.is_grad_enabled()
    total: Any = 0.0
    for blk in blocks:
        if remat:
            x, aux = checkpoint(blk, x, sin, cos, kv_len=kv_len,
                                use_reentrant=False)
        else:
            x, aux = blk(x, sin, cos, kv_len=kv_len)
        if aux is not None:
            total = total + aux
    return (x, total) if return_aux else x


# -- parameter sharding: param name -> logical axes -> PartitionSpec ---------

_PARAM_AXES = {
    "token_embed": ("vocab", "embed"),
    "q_proj": ("embed", "heads", "kv"),
    "k_proj": ("embed", "heads", "kv"),
    "v_proj": ("embed", "heads", "kv"),
    "o_proj": ("heads", "kv", "embed"),
    "gate_proj": ("embed", "mlp"),
    "up_proj": ("embed", "mlp"),
    "down_proj": ("mlp", "embed"),
    "router": ("embed", None),
    "scale": (None,),
}

_MOE_PARAM_AXES = {
    "gate_proj": ("expert", "embed", "expert_mlp"),
    "up_proj": ("expert", "embed", "expert_mlp"),
    "down_proj": ("expert", "expert_mlp", "embed"),
}


def leaf_logical_axes(name: str, ndim: int, *, pipelined: bool = False
                      ) -> Tuple[Optional[str], ...]:
    """Logical axes of the port parameter ``name`` (``blocks.3.attn.
    q_proj``, ...) by its last component, as the reference's
    ``leaf_logical_axes`` matches a param path (the port's layer list
    has no stacked layer axis). Unknown names replicate. ``pipelined``:
    a block's leaf gets the reference's ``"stage"`` axis in front, the
    axes of the layer stack it is one layer of (``train/trainer.py:
    _leaf_axes``)."""
    parts = name.split(".")
    table = (_MOE_PARAM_AXES if "moe" in parts
             and parts[-1] in _MOE_PARAM_AXES else _PARAM_AXES)
    axes = table.get(parts[-1])
    if axes is None or ndim == 0:
        axes = (None,) * ndim
    elif len(axes) != ndim:
        raise ValueError(f"axes {axes} rank != param {name} rank {ndim}")
    if pipelined and ndim and parts[0] == "blocks":
        return ("stage",) + tuple(axes)
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class _Split:
    """How a model built over a mesh shares out its work."""

    mesh: Any
    tp: int              # tensor-parallel width (1 under context parallel)
    tp_rank: int
    seq: int             # context-parallel width (0: not context parallel)
    seq_rank: int
    vocab_sharded: bool  # token_embed split over tp (V % tp == 0)
    kv_sharded: bool     # k/v projections split over tp (KH % tp == 0)
    data_axes: Tuple[str, ...] = ("dcn", "dp")   # the global batch's split
    ep_axis: Optional[str] = None  # the axis the experts are split over
    pp: int = 1          # pipeline stages; > 1: this model holds one


class StageBlocks(nn.Module):
    """One pipeline stage's blocks under their global layer indices
    (children ``"{start}"`` ... ``"{start + n - 1}"``), so parameter names
    are the whole model's. Iterates, indexes and counts as the
    ``nn.ModuleList`` of a whole model does."""

    def __init__(self, blocks, start: int) -> None:
        super().__init__()
        for i, blk in enumerate(blocks):
            self.add_module(str(start + i), blk)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]


def stage_peer(name: str, stage: int, per_stage: int) -> str:
    """The name stage ``stage``'s rank gives the parameter this rank names
    ``name`` (``blocks.{i}...``, ``per_stage`` layers a stage): the same
    position in its stage. Names outside the blocks are their own."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return name
    parts[1] = str(stage * per_stage + int(parts[1]) % per_stage)
    return ".".join(parts)


def _shard(model: nn.Module, c: TransformerConfig, mesh):
    """Cut every parameter of ``model`` (built at full shapes, with its
    stage's blocks only under ``pp > 1``) down to this rank's block;
    returns the :class:`_Split` and each parameter's PartitionSpec fitted
    to the mesh (its full shape; a stage leaf's leads with ``"pp"``)."""
    cp = c.attention_impl in ("ring", "ulysses")
    tp = pmesh.axis_size(mesh, "tp")
    pp = pmesh.axis_size(mesh, "pp")
    if cp and c.seq_axis != "tp":
        raise NotImplementedError(
            f"ring/ulysses over seq_axis={c.seq_axis!r}: the port runs "
            "context parallelism over 'tp' only")
    if cp and (c.n_experts or pp > 1):
        raise NotImplementedError(
            "context parallelism (ring/ulysses) for MoE layers or inside "
            "the pipeline is not ported (ROADMAP Queue A 2.7)")
    if not cp:
        pmesh.validate_mesh_for_model(pmesh.mesh_config(mesh),
                                      n_heads=c.n_heads, d_ff=c.d_ff,
                                      n_experts=c.n_experts)
    specs = {}
    for name, p in list(model.named_parameters()):
        spec = pmesh.spec_for_mesh(pmesh.logical_to_mesh_axes(
            leaf_logical_axes(name, p.dim()), c.rules), mesh)
        if cp:      # parameters whole along the sequence's axis
            spec = pmesh.PartitionSpec(*(None if e == c.seq_axis else e
                                         for e in spec))
        spec = pmesh.shape_aware_spec(spec, tuple(p.shape), mesh)
        if pmesh.is_sharded(spec):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, nn.Parameter(p.new_empty(
                pmesh.local_shape(p.shape, spec, mesh))))
        if pp > 1 and name.startswith("blocks."):
            spec = pmesh.PartitionSpec("pp", *spec)
        specs[name] = spec
    kv = next((sp for n, sp in specs.items() if n.endswith(".attn.k_proj")),
              None)
    gate = next((pmesh.tensor_spec(sp) for n, sp in specs.items()
                 if n.endswith(".moe.gate_proj")), ())
    ep = gate[0] if gate else None          # the experts' axis, if split
    split = _Split(
        mesh=mesh, tp=1 if cp else tp,
        tp_rank=0 if cp else pmesh.axis_index(mesh, "tp"),
        seq=tp if cp else 0, seq_rank=pmesh.axis_index(mesh, "tp") if cp
        else 0,
        vocab_sharded=pmesh.is_sharded(specs.get("token_embed")),
        kv_sharded="tp" in pmesh.spec_axes(kv) if kv is not None else True,
        data_axes=pmesh.batch_axes(c.rules),
        ep_axis=ep if isinstance(ep, str) and pmesh.axis_size(mesh, ep) > 1
        else None,
        pp=pp)
    return split, specs


def split_over(model: nn.Module, c: TransformerConfig, mesh) -> None:
    """Cut ``model`` (a ``Transformer``, or an encoder over its blocks:
    ``Bert``, ``ViT``) down to this rank's blocks of ``mesh`` by the
    reference's rules for each leaf name (:func:`_shard`), and hand the
    split to its attention and MLP layers. Sets ``model.mesh``,
    ``model.split`` and ``model.param_specs`` (None and ``{}`` without
    a mesh)."""
    model.mesh, model.split, model.param_specs = mesh, None, {}
    if mesh is None:
        return
    model.split, model.param_specs = _shard(model, c, mesh)
    for mod in model.modules():
        if isinstance(mod, (Attention, Mlp, MoeMlp)):
            mod.split = model.split


def _take_rows_split(table: torch.Tensor, ids: torch.Tensor, V: int,
                     sp: _Split) -> torch.Tensor:
    """:func:`take_rows` over a ``vocab`` split over ``tp``: the id
    wrapped first, each rank's own rows (zeros for ids it does not own),
    summed over ``tp``; an id no shard owns reads NaN."""
    Vl = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    local = idx - sp.tp_rank * Vl
    mine = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    rows = col.reduce_from(rows, sp.mesh, "tp")
    bad = (idx < 0) | (idx >= V)
    return rows.masked_fill(bad[..., None], float("nan"))


class Transformer(nn.Module):
    """``forward(tokens)`` → logits ``(B, S, V)`` f32 (or the final-norm
    hidden states with ``return_hidden=True``); ``forward(tokens,
    cache)`` runs decode mode over a :class:`DenseKVCache` or a
    :class:`PagedKVCache` and advances its positions by ``S``.

    With ``mesh``, each rank holds its block of each parameter (the
    module docstring); ``param_specs`` gives each parameter's
    PartitionSpec over the mesh (whole on every rank where it names no
    axis of more than one rank),
    and the training forward returns this rank's block of the logits:
    its vocabulary block under tensor parallelism, its sequence block
    under context parallelism."""

    def __init__(self, config: TransformerConfig,
                 return_hidden: bool = False, *, mesh=None) -> None:
        super().__init__()
        config.validate()
        self.config = config
        self.return_hidden = return_hidden
        self.token_embed = nn.Parameter(torch.empty(
            config.vocab_size, config.d_model, dtype=config.param_dtype))
        pp = pmesh.axis_size(mesh, "pp") if mesh is not None else 1
        if pp > 1:      # this rank's pipeline stage only
            L = config.n_layers
            if L % pp:
                raise ValueError(f"layers {L} not divisible by stages {pp}")
            per = L // pp
            self.blocks = StageBlocks(
                [Block(config) for _ in range(per)],
                pmesh.axis_index(mesh, "pp") * per)
        else:
            self.blocks = nn.ModuleList(Block(config)
                                        for _ in range(config.n_layers))
        self.final_norm = RMSNorm(config.d_model,
                                  param_dtype=config.param_dtype)
        self._rope: Dict[Tuple[int, torch.device], Tuple] = {}
        split_over(self, config, mesh)

    @property
    def cache_kv_heads(self) -> int:
        """The kv heads this rank's decode cache holds: its block of
        them under tensor parallelism (``KH / tp``), or every one where
        ``tp`` does not divide them (replicated, as the reference's
        engine creates the cache through ``shape_aware_spec``)."""
        sp, KH = self.split, self.config.n_kv_heads
        if sp is not None and sp.tp > 1 and sp.kv_sharded:
            return KH // sp.tp
        return KH

    def _tables(self, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (n, torch.device(device))
        if key not in self._rope:
            c = self.config
            self._rope[key] = rope_tables(n, c.head_dim, c.rope_theta,
                                          device)
        return self._rope[key]

    def _dense_step(self, cache: DenseKVCache, S: int, device,
                    ragged: bool) -> _DenseStep:
        c = self.config
        Smax = c.max_seq_len
        if cache.k.shape[2] != Smax:
            raise ValueError(f"dense cache rows of {cache.k.shape[2]} do "
                             f"not span max_seq_len {Smax}")
        sin_full, cos_full = self._tables(Smax, device)
        ar = torch.arange(S, device=device)
        pos = cache.positions.long()
        if S == 1 or ragged:
            q_pos = pos[:, None] + ar[None, :]               # (B, S)
            safe = q_pos.clamp(max=Smax - 1)
            sin = sin_full[safe][:, :, None, :].to(c.dtype)
            cos = cos_full[safe][:, :, None, :].to(c.dtype)
            rows = torch.arange(pos.shape[0], device=device)[:, None]
            write = (rows, q_pos % Smax, q_pos < Smax)
        else:
            # rows share row 0's start; the slice is clamped to fit
            idx = pos[0]
            start = idx.clamp(0, Smax - S)
            span = start + ar
            sin = sin_full[span][None, :, None, :].to(c.dtype)
            cos = cos_full[span][None, :, None, :].to(c.dtype)
            q_pos = (idx + ar)[None, :]
            write = (None, span, None)
        return _DenseStep(q_pos=q_pos, sin=sin, cos=cos, write=write)

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

    def embed_table(self) -> torch.Tensor:
        """The tied embedding in the compute dtype: cast once a forward
        and shared by :meth:`embed` and :meth:`head`, so its gradient
        sums both uses before the cast back, as the reference's one
        ``astype`` does."""
        return _compute(self.token_embed, self.config.dtype)

    def embed(self, tokens: torch.Tensor, table: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The training forward up to the blocks: ``(x, sin, cos)`` for
        this rank's tokens (its sequence block under context
        parallelism), ``table`` from :meth:`embed_table`."""
        c, sp = self.config, self.split
        S = tokens.shape[1]
        sin, cos = self._tables(S, tokens.device)
        if sp is not None and sp.seq:
            if S % sp.seq:
                raise ValueError(f"seq len {S} does not divide over "
                                 f"{sp.seq} context-parallel ranks")
            n = S // sp.seq
            block = slice(sp.seq_rank * n, (sp.seq_rank + 1) * n)
            tokens, sin, cos = tokens[:, block], sin[block], cos[block]
        if sp is not None and sp.tp > 1 and sp.vocab_sharded:
            return _take_rows_split(table, tokens, c.vocab_size, sp), sin, cos
        return take_rows(table, tokens), sin, cos

    def head(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """The final norm, then the logits (this rank's vocabulary block
        under tensor parallelism), or the hidden states with
        ``return_hidden``."""
        c, sp = self.config, self.split
        x = self.final_norm(x)
        if self.return_hidden:
            return x
        if sp is not None and sp.tp > 1 and sp.vocab_sharded:
            x = col.copy_to(x, sp.mesh, "tp")
        logits = (x @ table.t()).float()
        if c.logits_softcap:
            logits = c.logits_softcap * torch.tanh(logits / c.logits_softcap)
        return logits

    def forward(self, tokens: torch.Tensor, cache: Optional[Any] = None,
                *, ragged: bool = False, return_aux: bool = False):
        """``ragged`` makes a dense-cache multi-token forward write each
        row from its own position, as ``ragged_decode`` does (the
        speculative verify). ``return_aux`` (training forward) returns
        ``(out, aux)``, ``aux`` the summed MoE load-balance loss."""
        c, sp = self.config, self.split
        if cache is not None and sp is not None and (
                sp.pp > 1 or (c.n_experts and (sp.tp > 1 or sp.ep_axis))):
            raise NotImplementedError(
                "decoding from a MoE or pipelined model split over a mesh "
                "is ROADMAP Queue A 2.8")
        if sp is not None and sp.pp > 1:
            raise ValueError(
                "a model built over pp > 1 holds one pipeline stage: it "
                "runs through parallel/pipeline.py:make_pipelined_lm_forward")
        B, S = tokens.shape
        dev = tokens.device
        aux: Any = 0.0
        table = self.embed_table()
        if cache is None:
            x, sin, cos = self.embed(tokens, table)
            x, aux = run_blocks(self.blocks, x, sin, cos, remat=c.remat,
                                return_aux=True)
            out = self.head(x, table)
            return (out, aux) if return_aux else out
        split_vocab = sp is not None and sp.tp > 1 and sp.vocab_sharded
        x = (_take_rows_split(table, tokens, c.vocab_size, sp)
             if split_vocab else take_rows(table, tokens))
        if isinstance(cache, DenseKVCache):
            step = self._dense_step(cache, S, dev,
                                    ragged or c.ragged_decode)
            for i, blk in enumerate(self.blocks):
                x, _ = blk(x, None, None, (cache.k[i], cache.v[i]), step)
        else:
            step = self._decode_step(cache, S, dev)
            for i, blk in enumerate(self.blocks):
                kv = (cache.k[i], cache.v[i], cache.pages, cache.positions)
                x, _ = blk(x, None, None, kv, step)
        cache.positions.add_(S)
        # the full row on every rank, as GSPMD gathers it under the
        # reference's sampler
        out = self.full_logits(self.head(x, table))
        return (out, aux) if return_aux else out

    def full_logits(self, out: torch.Tensor) -> torch.Tensor:
        """``(B, S, V)`` logits from this rank's vocabulary block (what a
        forward over a ``tp`` split returns): the blocks gathered over
        ``tp`` in order, the same on every rank (a collective). Whole
        logits and hidden states pass unchanged."""
        sp = self.split
        if (sp is None or sp.tp == 1 or not sp.vocab_sharded
                or self.return_hidden):
            return out
        B, S = out.shape[:2]
        blocks = col.all_gather(out.contiguous(), sp.mesh, "tp")
        return blocks.reshape(sp.tp, B, S, -1).permute(1, 2, 0, 3) \
            .reshape(B, S, -1)


def tiny_config(**overrides) -> TransformerConfig:
    """The reference's ``tiny_config()``: small enough for CPU tests."""
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64,
                dtype=torch.float32, remat=False)
    base.update(overrides)
    return TransformerConfig(**base)
