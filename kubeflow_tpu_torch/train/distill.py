"""Draft acquisition for speculative decoding: layer-truncate the target,
then distill it toward the target's next-token distribution.

PyTorch port of ``kubeflow_tpu/train/distill.py``:

1. :func:`truncate_draft` keeps ``np.unique(np.linspace(0, L-1, n)
   .round())`` of the target's blocks (first and last always) and shares
   its embedding and final norm, all as COPIES: training the draft never
   moves the target.
2. :func:`distill_draft` trains the draft on ``KL(target || draft)``
   over every next-token position with ``optax.adamw(lr)`` at optax's
   defaults (:class:`~kubeflow_tpu_torch.train.trainer.AdamW`); each
   step's rows come from ``np.random.default_rng(seed)``, as in the
   reference, so a given corpus trains on the same rows in both packages.
3. Export the result with ``export_model(..., draft_of="<model>@<v>")``:
   the serving repository pairs it with its target.

Models are port ``Transformer`` modules (the reference passes a config
and a param tree; here the module carries both). :func:`sample_corpus`
draws its first tokens and its sampling noise with torch, so its tokens
differ from the reference's by design; tests inject the corpus.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.ops.sampling import noise_seed
from kubeflow_tpu_torch.train.trainer import AdamW


def truncate_draft(config: TransformerConfig, model: Transformer,
                   n_layers: int) -> Tuple[TransformerConfig, Transformer]:
    """``(draft_config, draft)``: ``n_layers`` evenly strided blocks of
    ``model`` (always the first and the last), with copies of its
    embedding and final norm, on its device, trainable. Requires
    ``scan_layers=True``, as the reference does (its truncation is one
    gather over the stacked layer axis)."""
    if not config.scan_layers:
        raise ValueError("truncate_draft needs scan_layers=True params "
                         "(stacked block leaves)")
    L = config.n_layers
    if not 1 <= n_layers <= L:
        raise ValueError(f"n_layers must be in [1, {L}], got {n_layers}")
    idx = np.unique(np.linspace(0, L - 1, n_layers).round().astype(int))
    draft_config = dataclasses.replace(config, n_layers=int(idx.size),
                                       remat=False)
    with torch.device(model.token_embed.device):
        draft = Transformer(draft_config)
    # load_state_dict copies values into the draft's own tensors
    with torch.no_grad():
        draft.token_embed.copy_(model.token_embed)
        draft.final_norm.load_state_dict(model.final_norm.state_dict())
        for j, i in enumerate(idx):
            draft.blocks[j].load_state_dict(
                model.blocks[int(i)].state_dict())
    return draft_config, draft.train()


def sample_corpus(config: TransformerConfig, model: Transformer, *,
                  n_seqs: int, seq_len: int, seed: int = 0,
                  temperature: float = 1.0) -> np.ndarray:
    """Self-distillation corpus ``(n_seqs, seq_len)`` int32: one random
    first token a row, then the target's own sampled continuation
    (:func:`~kubeflow_tpu_torch.models.decode.generate` at
    ``temperature``, noise from ``seed``)."""
    from kubeflow_tpu_torch.models.decode import generate

    gen = torch.Generator().manual_seed(noise_seed(seed, 0))
    first = torch.randint(0, config.vocab_size, (n_seqs, 1), generator=gen,
                          dtype=torch.int32)
    rest = generate(model, first.to(model.token_embed.device),
                    max_new_tokens=seq_len - 1, temperature=temperature,
                    seed=seed)
    return np.concatenate([first.numpy(), rest.cpu().numpy()], axis=1)


def distill_draft(target_config: TransformerConfig, target: Transformer,
                  draft_config: TransformerConfig, draft: Transformer,
                  corpus: np.ndarray, *, steps: int = 100, batch: int = 8,
                  lr: float = 1e-3, seed: int = 0
                  ) -> Tuple[Transformer, Dict[str, Any]]:
    """KL-distill ``draft`` (in place) toward the frozen ``target`` on
    ``corpus`` ``(N, S)`` tokens. Loss: ``mean KL(t || d)`` over every
    position, the target's entropy kept (the loss reaches 0 exactly when
    the draft matches). Returns ``(draft, {"first_loss", "last_loss"})``
    with the losses rounded to 4 places, as the reference reports them."""
    del target_config, draft_config  # the modules carry their configs
    corpus = np.asarray(corpus, np.int32)
    if corpus.ndim != 2:
        raise ValueError(f"corpus must be (N, S) tokens, got "
                         f"{corpus.shape}")
    n = corpus.shape[0]
    batch = min(batch, n)
    device = draft.token_embed.device
    tx = AdamW(learning_rate=lr)
    params = [p for p in draft.parameters() if p.requires_grad]
    opt_state = tx.init(params)
    rng = np.random.default_rng(seed)
    first_loss: Optional[torch.Tensor] = None
    loss = torch.zeros((), device=device)
    for _ in range(steps):
        rows = rng.integers(0, n, size=(batch,))
        tokens = torch.as_tensor(corpus[rows], device=device)
        with torch.no_grad():
            t_logits = target(tokens).float()
            t_probs = torch.softmax(t_logits, dim=-1)
            t_logp = torch.log_softmax(t_logits, dim=-1)
        d_logp = torch.log_softmax(draft(tokens).float(), dim=-1)
        loss = (t_probs * (t_logp - d_logp)).sum(dim=-1).mean()
        grads = torch.autograd.grad(loss, params)
        tx.apply(params, grads, opt_state)
        loss = loss.detach()
        if first_loss is None:
            first_loss = loss
    return draft, {
        "first_loss": round(float(first_loss) if first_loss is not None
                            else 0.0, 4),
        "last_loss": round(float(loss), 4)}


def make_draft(config: TransformerConfig, model: Transformer, *,
               n_layers: int, distill_steps: int = 100,
               corpus: Optional[np.ndarray] = None, corpus_seqs: int = 64,
               corpus_len: int = 64, batch: int = 8, lr: float = 1e-3,
               seed: int = 0
               ) -> Tuple[TransformerConfig, Transformer, Dict[str, Any]]:
    """The one-call recipe: truncate, (self-)sample a corpus unless one
    is given, distill. Returns ``(draft_config, draft, stats)``, stats
    ``first_loss``, ``last_loss`` and ``n_layers``."""
    draft_config, draft = truncate_draft(config, model, n_layers)
    if distill_steps > 0:
        if corpus is None:
            corpus_len = min(corpus_len, config.max_seq_len)
            corpus = sample_corpus(config, model, n_seqs=corpus_seqs,
                                   seq_len=corpus_len, seed=seed)
        draft, stats = distill_draft(
            config, model, draft_config, draft, corpus,
            steps=distill_steps, batch=batch, lr=lr, seed=seed)
    else:
        stats = {"first_loss": 0.0, "last_loss": 0.0}
    stats["n_layers"] = draft_config.n_layers
    return draft_config, draft, stats
