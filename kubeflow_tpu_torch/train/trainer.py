"""Training: optimizers, train state, losses, the LM, MLM and image steps.

PyTorch port of ``kubeflow_tpu/train/trainer.py``: ``make_optimizer``
(:73-92), ``next_token_loss`` (:118-123), ``softmax_cross_entropy``
(:126-129), ``chunked_next_token_loss`` (:132-172),
``make_lm_train_step`` (:175-236), ``masked_lm_loss`` (:248-254),
``make_mlm_train_step`` (:257-291) and ``make_image_train_step``
(:338-382, ResNet with its BN statistics, ViT and the MNIST CNN without), with ``optax.sgd`` as :class:`Sgd`. Steps run eagerly on the
device of the state's parameters; there is no mesh yet (data parallelism
is ROADMAP Queue A).

The optimizer is optax's chain written in plain tensor ops, with optax's
numerics (:class:`AdamW` is bare ``optax.adamw``):

- ``clip_by_global_norm``: updates become ``(g / norm) * max_norm`` only
  when ``norm >= max_norm`` (no ``+1e-6`` as in
  ``torch.nn.utils.clip_grad_norm_``);
- ``adamw``: ``eps`` outside the square root, bias correction at the
  incremented count, weight decay on every parameter (optax's default
  mask: the norm scales and the embedding too);
- ``warmup_cosine_decay_schedule`` from 0, read at the update count
  BEFORE it is incremented, so the first update has learning rate 0.

:class:`Sgd` is ``optax.sgd``: the trace ``t = g + momentum * t``
(``optax.trace``, nesterov ``g + momentum * t`` as the update), then the
update ``-lr * t`` added to the parameter.

Parameters, moments and the update are kept in place (the reference
returns new arrays). BN statistics live in the module's buffers, written
by the train-mode forward (the reference's ``mutable=["batch_stats"]``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``clip_by_global_norm`` then ``adamw`` on a warmup-cosine schedule
    (the reference's ``make_optimizer``)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, lr, warmup, decay)``
        at update count ``count``."""
        peak, warm = self.learning_rate, self.warmup_steps
        if count < warm:
            return peak * (count / warm)
        span = self.decay_steps - warm
        t = min(count - warm, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: Dict[str, Any],
              grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` in place from ``grads``; advances
        ``state``. ``grad_norm`` is the global norm of ``grads`` when
        the caller has it."""
        clip = math.isfinite(self.grad_clip)
        if clip and grad_norm is None:
            grad_norm = global_norm(grads)
        keep = grad_norm < self.grad_clip if clip else None
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            if clip:
                g = torch.where(keep, g, (g / grad_norm) * self.grad_clip)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
        state["count"] = count


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    """``optax.adamw(learning_rate)`` at optax's defaults: b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4 on every parameter, a constant
    learning rate and no clipping (the draft distillation's optimizer,
    ``train/distill.py``)."""

    b2: float = 0.999
    weight_decay: float = 1e-4
    grad_clip: float = math.inf

    def schedule(self, count: int) -> float:
        return self.learning_rate


def make_optimizer(learning_rate: float = 3e-4, *, warmup_steps: int = 100,
                   decay_steps: int = 10_000, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> Optimizer:
    """The reference's ``make_optimizer``: same arguments, same
    defaults, ``decay_steps`` raised to at least ``warmup_steps + 1``."""
    return Optimizer(learning_rate=learning_rate, warmup_steps=warmup_steps,
                     decay_steps=max(decay_steps, warmup_steps + 1),
                     weight_decay=weight_decay, b1=b1, b2=b2,
                     grad_clip=grad_clip)


@dataclasses.dataclass(frozen=True)
class Sgd:
    """``optax.sgd(learning_rate, momentum, nesterov)``, with the
    :class:`Optimizer` interface."""

    learning_rate: float
    momentum: Optional[float] = None
    nesterov: bool = False

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"trace": [torch.zeros_like(p) for p in params]
                if self.momentum else []}

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: Dict[str, Any],
              grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` in place; ``grad_norm`` is unused
        (the :class:`Optimizer` signature)."""
        del grad_norm
        step = -self.learning_rate
        for i, (p, g) in enumerate(zip(params, grads)):
            upd = g
            if self.momentum:
                t = state["trace"][i]
                t.mul_(self.momentum).add_(g)
                upd = g + self.momentum * t if self.nesterov else t
            p.add_(upd * step)


def make_sgd(learning_rate: float, momentum: Optional[float] = None,
             nesterov: bool = False) -> Sgd:
    """``optax.sgd``: same arguments, same defaults."""
    return Sgd(learning_rate=learning_rate, momentum=momentum,
               nesterov=nesterov)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every leaf."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclasses.dataclass
class TrainState:
    """The module, the optimizer and its state, and the step count."""

    module: nn.Module
    tx: Any
    opt_state: Dict[str, Any]
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, tx) -> "TrainState":
        params = [p for p in module.parameters() if p.requires_grad]
        return cls(module=module, tx=tx, opt_state=tx.init(params))

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for p in self.module.parameters() if p.requires_grad]

    @property
    def batch_stats(self) -> Optional[Dict[str, torch.Tensor]]:
        """The module's BN statistics by buffer name, or None for a
        module without any (as the reference's ``batch_stats=None``)."""
        stats = dict(self.module.named_buffers())
        return stats or None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def apply_gradients(self, grads: Sequence[torch.Tensor],
                        grad_norm: Optional[torch.Tensor] = None
                        ) -> "TrainState":
        self.tx.apply(self.params, grads, self.opt_state, grad_norm)
        self.step += 1
        return self


def create_train_state(config, params: Mapping[str, Any], tx: Optimizer, *,
                       device=None, return_hidden: bool = False
                       ) -> TrainState:
    """A :class:`TrainState` over a trainable port ``Transformer`` loaded
    from a JAX-layout param tree, on ``device`` (CUDA unless ``"cpu"``
    is asked for)."""
    from kubeflow_tpu_torch.models import convert

    model = convert.to_trainable(config, params, device=device,
                                 return_hidden=return_hidden)
    return TrainState.create(model, tx)


def create_bert_train_state(config, params: Mapping[str, Any],
                            tx: Optimizer, *, device=None) -> TrainState:
    """A :class:`TrainState` over a trainable port ``Bert`` loaded from a
    JAX-layout param tree, on ``device`` (CUDA unless ``"cpu"`` is asked
    for)."""
    from kubeflow_tpu_torch.models import convert

    return TrainState.create(
        convert.bert_to_trainable(config, params, device=device), tx)


def create_image_train_state(config, variables: Mapping[str, Any], tx, *,
                             device=None) -> TrainState:
    """A :class:`TrainState` over a trainable port ``ResNet`` loaded from
    JAX-layout variables (``params`` + ``batch_stats``), on ``device``
    (CUDA unless ``"cpu"`` is asked for)."""
    from kubeflow_tpu_torch.models import convert

    model = convert.resnet_to_trainable(config, variables, device=device)
    return TrainState.create(model, tx)


def create_vit_train_state(config, params: Mapping[str, Any], tx, *,
                           device=None) -> TrainState:
    """A :class:`TrainState` over a trainable port ``ViT`` loaded from a
    JAX-layout param tree (no ``batch_stats``: the image train step runs
    it unchanged, as the reference's serves both), on ``device`` (CUDA
    unless ``"cpu"`` is asked for)."""
    from kubeflow_tpu_torch.models import convert

    return TrainState.create(
        convert.vit_to_trainable(config, params, device=device), tx)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer ``labels`` under f32 ``logits``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def next_token_loss(logits: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Causal LM loss: predict ``tokens[:, 1:]`` from ``logits[:, :-1]``."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].mean()


def _chunk_ll(h: torch.Tensor, embed: torch.Tensor, tgt: torch.Tensor,
              softcap: float) -> torch.Tensor:
    logits = (h @ embed.to(h.dtype).t()).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, tgt[..., None]).sum()


def chunked_next_token_loss(hidden: torch.Tensor, embed: torch.Tensor,
                            tokens: torch.Tensor, *, chunk: int = 4096,
                            softcap: float = 0.0) -> torch.Tensor:
    """:func:`next_token_loss` from HIDDEN states, with the vocab
    projection done per ``chunk`` positions and recomputed in the
    backward (``torch.utils.checkpoint``), so only ``(B, chunk, V)``
    logits live at once. The head's math: tied-embedding product in
    the activation dtype, f32 softmax, optional softcap. The last chunk
    is short where the reference pads it and masks the padding out;
    the sum is the same."""
    B, S, _ = hidden.shape
    n = S - 1
    tgt = tokens[:, 1:].long()
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        total = total + checkpoint(_chunk_ll, hidden[:, c0:c1], embed,
                                   tgt[:, c0:c1], softcap,
                                   use_reentrant=False)
    return -total / (B * n)


def make_lm_train_step(*, moe_aux_weight: float = 0.01,
                       loss_chunk: Optional[int] = None,
                       logits_softcap: float = 0.0):
    """The LM train step: ``step(state, tokens) -> (state, metrics)``.

    ``metrics`` holds ``loss`` (the LM loss, a 0-dim tensor on the
    device), ``grad_norm`` (the global norm of the raw gradients, before
    clipping) and ``step`` (the count after this update). ``tokens`` go
    to the device of the state's parameters.

    ``loss_chunk``: long-context mode. The module must return
    post-final-norm hidden states (``Transformer(config,
    return_hidden=True)``) and the loss projects to the vocab per chunk
    (:func:`chunked_next_token_loss`); pass the model's
    ``logits_softcap`` here, as the hidden-states model never applies
    it. The gradient is that of ``loss + moe_aux_weight * aux``, ``aux``
    the MoE layers' summed load-balance loss (0 without MoE); ``loss``
    in the metrics is the LM loss alone, as the reference reports it.
    """

    def step(state: TrainState, tokens) -> Tuple[TrainState, Dict[str, Any]]:
        model = state.module
        tokens = torch.as_tensor(tokens, device=state.device)
        if loss_chunk and not getattr(model, "return_hidden", False):
            raise ValueError("loss_chunk needs a model that returns hidden "
                             "states (return_hidden=True)")
        params = state.params
        out, aux = model(tokens, return_aux=True)
        if loss_chunk:
            embed = dict(model.named_parameters())["token_embed"]
            loss = chunked_next_token_loss(out, embed, tokens,
                                           chunk=loss_chunk,
                                           softcap=logits_softcap)
        else:
            loss = next_token_loss(out, tokens)
        grads = torch.autograd.grad(loss + moe_aux_weight * aux, params)
        grad_norm = global_norm(grads)
        state.apply_gradients(grads, grad_norm)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                       "step": state.step}

    return step


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """The MLM objective: cross-entropy at the weighted positions, over
    ``max(sum(weights), 1)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -(ll * weights).sum() / weights.sum().clamp_min(1.0)


def make_mlm_train_step():
    """The masked-LM train step: ``step(state, tokens, labels, weights)
    -> (state, metrics)``. ``tokens`` are the corrupted inputs,
    ``labels`` the originals and ``weights`` mark the masked positions;
    all go to the device of the state's parameters. ``metrics`` holds
    ``loss``, ``grad_norm`` (of the raw gradients) and ``step``, as in
    :func:`make_lm_train_step`."""

    def step(state: TrainState, tokens, labels, weights
             ) -> Tuple[TrainState, Dict[str, Any]]:
        dev = state.device
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        weights = torch.as_tensor(weights, device=dev, dtype=torch.float32)
        params = state.params
        loss = masked_lm_loss(state.module(tokens), labels, weights)
        grads = torch.autograd.grad(loss, params)
        grad_norm = global_norm(grads)
        state.apply_gradients(grads, grad_norm)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm,
                       "step": state.step}

    return step


def make_image_train_step():
    """The classifier train step: ``step(state, images, labels) ->
    (state, metrics)``, with BN statistics updated by the train-mode
    forward when the module has any. ``metrics`` holds ``loss`` and
    ``accuracy`` (0-dim tensors on the device) and ``step`` (the count
    after this update). ``images`` and ``labels`` go to the device of
    the state's parameters."""

    def step(state: TrainState, images, labels
             ) -> Tuple[TrainState, Dict[str, Any]]:
        images = torch.as_tensor(images, device=state.device)
        labels = torch.as_tensor(labels, device=state.device).long()
        params = state.params
        logits = state.module(images, train=True)
        loss = softmax_cross_entropy(logits, labels)
        with torch.no_grad():
            acc = (logits.argmax(dim=-1) == labels).float().mean()
        grads = torch.autograd.grad(loss, params)
        state.apply_gradients(grads)
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "step": state.step}

    return step
