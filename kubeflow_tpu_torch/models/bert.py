"""BERT-family encoder: the bidirectional transformer with a masked-LM head.

PyTorch port of ``kubeflow_tpu/models/bert.py``: the reference's blocks
with ``causal=False``, RoPE positions, RMSNorm, bf16 compute over f32
parameters, remat, and an MLM head of ``gelu(x @ mlm_transform)`` (flax's
``nn.gelu``, the tanh form) followed by the tied-embedding product, f32
logits. Parameter names and layouts are the reference's
(``token_embed`` ``(V, D)``, ``type_embed`` ``(T, D)``, ``mlm_transform``
``(D, D)``, ``blocks.{i}`` as in ``models/transformer.py``), so weights
carry across through ``models/convert.py``.

``attention_impl="auto"`` (the default) runs the flash kernels on CUDA
tensors and the dense path elsewhere, as the reference picks flash on the
TPU. ``seq_lengths`` is the per-row padding mask: it is cast once to the
contiguous int32 ``kv_len`` the flash kernels take and carried through
every block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from kubeflow_tpu_torch.models.transformer import (
    Block,
    RMSNorm,
    TransformerConfig,
    _compute,
    _take_rows_split,
    rope_tables,
    run_blocks,
    split_over,
    take_rows,
    torch_dtype,
)
from kubeflow_tpu_torch.ops import collectives as col

MASK_TOKEN_ID = 103  # conventionally [MASK] in the BERT vocab


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The reference's fields, one for one. The tile knobs
    (``attention_block_*``) are TPU tuning and drive nothing here;
    ``scan_layers`` selects the JAX param layout only."""

    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2      # sentence A/B segments
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True
    attention_impl: str = "auto"
    attention_block_q: Any = None
    attention_block_k: Any = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype",
                           torch_dtype(self.param_dtype))

    def encoder_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_heads,
            d_ff=self.d_ff,
            max_seq_len=self.max_seq_len,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            remat=self.remat,
            scan_layers=self.scan_layers,
            causal=False,  # the defining difference from the LM flagship
            attention_impl=self.attention_impl,
            attention_block_q=self.attention_block_q,
            attention_block_k=self.attention_block_k,
        )


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)


def bert_tiny() -> BertConfig:
    """Test-sized config."""
    return BertConfig(vocab_size=1024, d_model=64, n_layers=2, n_heads=4,
                      d_ff=128, max_seq_len=128, remat=False,
                      scan_layers=False)


class Bert(nn.Module):
    """``forward(tokens, token_types=None, seq_lengths=None)`` → MLM
    logits ``(B, S, V)`` f32.

    Built over a mesh (``mesh=``), each rank holds its block of every
    leaf the reference's rules split by name (``models/transformer.py:
    split_over``): the blocks' heads and MLP, and ``token_embed``'s
    vocabulary where ``tp`` divides it; ``type_embed`` and
    ``mlm_transform`` are whole on every rank. The lookup then goes
    through ``_take_rows_split``, the head's input through ``copy_to``
    (so ``mlm_transform``'s gradient sums over ``tp``), and the forward
    returns this rank's vocabulary block of the logits: the MLM loss is
    vocab-parallel (``train/trainer.py``)."""

    def __init__(self, config: BertConfig, *, mesh=None) -> None:
        super().__init__()
        ec = config.encoder_config()
        ec.validate()
        self.config = config
        self._rope = (ec.head_dim, ec.rope_theta)
        D, pd = config.d_model, config.param_dtype
        self.token_embed = nn.Parameter(torch.empty(config.vocab_size, D,
                                                    dtype=pd))
        if config.type_vocab_size:
            self.type_embed = nn.Parameter(torch.empty(
                config.type_vocab_size, D, dtype=pd))
        self.blocks = nn.ModuleList(Block(ec) for _ in range(config.n_layers))
        self.final_norm = RMSNorm(D, param_dtype=pd)
        self.mlm_transform = nn.Parameter(torch.empty(D, D, dtype=pd))
        split_over(self, ec, mesh)

    def forward(self, tokens: torch.Tensor,
                token_types: Optional[torch.Tensor] = None,
                seq_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``seq_lengths`` is an optional ``(B,)`` valid length per row:
        positions at or past a row's length are excluded from every
        attention (dense and flash alike); logits AT padded positions
        are unspecified, as in the reference (the MLM loss weights zero
        them)."""
        c = self.config
        dt, dev = c.dtype, tokens.device
        S = tokens.shape[1]
        embed = _compute(self.token_embed, dt)
        sp = self.split
        vocab = sp is not None and sp.tp > 1 and sp.vocab_sharded
        x = (_take_rows_split(embed, tokens, c.vocab_size, sp) if vocab
             else take_rows(embed, tokens))
        if c.type_vocab_size:
            types = _compute(self.type_embed, dt)
            # no types: every position is segment 0, as the reference's
            # zeros_like(tokens) makes it
            x = x + (types[0] if token_types is None
                     else take_rows(types, torch.as_tensor(token_types,
                                                           device=dev)))
        kv_len = None
        if seq_lengths is not None:
            kv_len = torch.as_tensor(seq_lengths, device=dev).to(
                torch.int32).contiguous()
        sin, cos = rope_tables(S, *self._rope, dev)
        x = run_blocks(self.blocks, x, sin, cos, remat=c.remat,
                       kv_len=kv_len)
        x = self.final_norm(x)
        # MLM head: dense transform + tied-embedding decode
        h = torch.nn.functional.gelu(x @ _compute(self.mlm_transform, dt),
                                     approximate="tanh")
        if vocab:
            h = col.copy_to(h, sp.mesh, "tp")
        return (h @ embed.t()).float()


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor, *,
                mask_prob: float = 0.15,
                mask_id: int = MASK_TOKEN_ID
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLM corruption: ``(masked_tokens, weights)``, where weights
    (f32) mark the positions whose original token must be predicted.
    Each position is masked when a uniform draw from ``generator`` (on
    the generator's device) falls below ``mask_prob``."""
    draw = torch.rand(tuple(tokens.shape), generator=generator,
                      device=generator.device)
    mask = (draw < mask_prob).to(tokens.device)
    masked = torch.where(mask, torch.full_like(tokens, mask_id), tokens)
    return masked, mask.to(torch.float32)
