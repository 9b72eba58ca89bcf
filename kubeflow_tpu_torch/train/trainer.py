"""Training: optimizers, train state, losses, the LM, MLM and image steps.

PyTorch port of ``kubeflow_tpu/train/trainer.py``: ``make_optimizer``
(:73-92), ``next_token_loss`` (:118-123), ``softmax_cross_entropy``
(:126-129), ``chunked_next_token_loss`` (:132-172),
``make_lm_train_step`` (:175-236), ``masked_lm_loss`` (:248-254),
``make_mlm_train_step`` (:257-291), ``make_pipelined_lm_train_step``
(:294-330) and ``make_image_train_step`` (:338-382, ResNet with its BN
statistics, ViT and the MNIST CNN without), with ``optax.sgd`` as
:class:`Sgd`, and
``state_partition_specs``, ``state_shardings`` and
``create_sharded_state`` (:39-115). Steps run eagerly on the device of
the state's parameters.

With a ``mesh`` (``parallel/mesh.py``) the LM and MLM steps take the
GLOBAL batch, as the reference's do, and each rank trains on its rows of
it (the ``batch`` rule: ``("dcn", "dp")``). The gradients, with the
loss for the metrics, are averaged over those axes by ONE all-reduce of
one flat buffer (every training path of the port is host-bound, so one
launch, not one per tensor). Under tensor parallelism the loss is
vocab-parallel (the max, the sum of exponentials and the target logit
are all-reduced over ``tp``), and the global norm counts a split
gradient's squares summed over every axis it is split on (``tp``; a
pipeline stage's over ``pp``; MoE experts' over ``dp``) and a replicated
one once. An expert's gradient arrives summed over ``dp`` already (the
dispatch's exchange), so it skips that axis of the all-reduce. Under
context parallelism (``attention_impl`` ring or Ulysses over
``config.seq_axis``, any mesh axis) each rank's loss covers its
positions, the rows split over the batch rule's other axes, and the
gradients sum over the sequence's axis in the same all-reduce. An axis
that splits neither the rows, the sequence nor a parameter (``pp``
under the MLM and image steps, as the reference's unpipelined leaves
carry no ``stage``) replicates the step. The pipelined LM step and the
image step over the data axes are :func:`make_pipelined_lm_train_step`
and :func:`make_image_train_step`.

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
import torch.distributed as tdist
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.ops.collectives import copy_to
from kubeflow_tpu_torch.parallel import mesh as pmesh


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

    @property
    def mesh(self):
        """The mesh the module was built over, or None."""
        return getattr(self.module, "mesh", None)

    @property
    def param_specs(self) -> List[Any]:
        """Each of :attr:`params`'s PartitionSpec over :attr:`mesh`
        (None off a mesh)."""
        specs = getattr(self.module, "param_specs", {})
        return [specs.get(name) for name, p in self.module.named_parameters()
                if p.requires_grad]

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


def state_partition_specs(state: TrainState, rules=pmesh.DEFAULT_RULES,
                          *, pipelined: bool = False) -> Dict[str, Any]:
    """A PartitionSpec for every leaf of a train state, in the tree
    ``train/checkpoint.py`` saves (``{"module": {name: spec},
    "opt_state": {...}, "step": spec}``): a parameter's from the rules
    table, its optimizer moments the same, everything else replicated.
    ``pipelined``: a block's leaf gets the ``stage`` axis in front, the
    spec of the layer stack it is one layer of (``spec[0] == "pp"``, as
    the reference's scanned leaf has)."""
    from kubeflow_tpu_torch.models.transformer import leaf_logical_axes

    def spec(name, t):
        return pmesh.logical_to_mesh_axes(
            leaf_logical_axes(name, t.dim(), pipelined=pipelined), rules)

    return _state_tree(state, spec)


def state_shardings(state: TrainState, mesh, rules=pmesh.DEFAULT_RULES,
                    *, pipelined: bool = False) -> Dict[str, Any]:
    """:func:`state_partition_specs` fitted to ``mesh`` (axes it lacks
    dropped, dims it cannot divide replicated): what each rank holds.
    A module built over ``mesh`` answers with its own ``param_specs``
    (a stage leaf's leading with ``"pp"`` where ``pp > 1``; with
    ``pipelined`` at any ``pp``)."""
    own = getattr(state.module, "param_specs", {})
    if own and state.mesh is mesh:
        def mine(name, t):
            spec = own.get(name, pmesh.PartitionSpec())
            if pipelined and name.startswith("blocks.") and \
                    not pmesh.is_stage_spec(spec):
                spec = pmesh.PartitionSpec("pp", *spec)
            return spec

        return _state_tree(state, mine)
    specs = state_partition_specs(state, rules, pipelined=pipelined)

    def fit(name, t):
        key = name if name in specs["module"] else None
        spec = specs["module"][key] if key else pmesh.PartitionSpec()
        shape = tuple(t.shape)
        if pmesh.is_stage_spec(spec):   # the layer stack's leading axis
            L = state.module.config.n_layers
            shape = (L,) + shape
        return pmesh.shape_aware_spec(pmesh.spec_for_mesh(spec, mesh),
                                      shape, mesh)

    return _state_tree(state, fit)


def _state_tree(state: TrainState, spec) -> Dict[str, Any]:
    """``spec(name, tensor)`` over the module's state dict, and the same
    per parameter for each optimizer list that follows the parameters
    (``mu``, ``nu``, ``trace``)."""
    module = {name: spec(name, t) for name, t in
              state.module.state_dict(keep_vars=True).items()}
    names = [n for n, p in state.module.named_parameters() if p.requires_grad]
    opt = {}
    for key, val in state.opt_state.items():
        if isinstance(val, list) and len(val) == len(names):
            opt[key] = [module[n] for n in names]
        else:
            opt[key] = pmesh.PartitionSpec()
    return {"module": module, "opt_state": opt, "step": pmesh.PartitionSpec()}


def create_sharded_state(config, params: Mapping[str, Any], tx, mesh, *,
                         device=None, return_hidden: bool = False,
                         pipelined: bool = False
                         ) -> Tuple[TrainState, Dict[str, Any]]:
    """A :class:`TrainState` over a port ``Transformer`` built over
    ``mesh``, holding this rank's blocks of the full JAX-layout
    ``params``, and its :func:`state_shardings`. ``pipelined``: the
    stage leaves' specs name ``pp`` and, where ``pp > 1``, each rank
    holds its stage's layers, as the reference's ``pipelined=True``;
    else every layer on every rank, replicated over ``pp``, as the
    reference's unpipelined state."""
    from kubeflow_tpu_torch.models import convert

    model = convert.to_trainable(config, params, device=device,
                                 return_hidden=return_hidden, mesh=mesh,
                                 pipelined=pipelined)
    state = TrainState.create(model, tx)
    return state, state_shardings(state, mesh, pipelined=pipelined)


def create_bert_train_state(config, params: Mapping[str, Any],
                            tx: Optimizer, *, device=None,
                            mesh=None) -> TrainState:
    """A :class:`TrainState` over a trainable port ``Bert`` loaded from a
    JAX-layout param tree, on ``device`` (CUDA unless ``"cpu"`` is asked
    for); with ``mesh``, built over it (this rank's blocks)."""
    from kubeflow_tpu_torch.models import convert

    return TrainState.create(
        convert.bert_to_trainable(config, params, device=device, mesh=mesh),
        tx)


def create_image_train_state(config, variables: Mapping[str, Any], tx, *,
                             device=None) -> TrainState:
    """A :class:`TrainState` over a trainable port ``ResNet`` loaded from
    JAX-layout variables (``params`` + ``batch_stats``), on ``device``
    (CUDA unless ``"cpu"`` is asked for)."""
    from kubeflow_tpu_torch.models import convert

    model = convert.resnet_to_trainable(config, variables, device=device)
    return TrainState.create(model, tx)


def create_vit_train_state(config, params: Mapping[str, Any], tx, *,
                           device=None, mesh=None) -> TrainState:
    """A :class:`TrainState` over a trainable port ``ViT`` loaded from a
    JAX-layout param tree (no ``batch_stats``: the image train step runs
    it unchanged, as the reference's serves both), on ``device`` (CUDA
    unless ``"cpu"`` is asked for); with ``mesh``, built over it (this
    rank's blocks)."""
    from kubeflow_tpu_torch.models import convert

    return TrainState.create(
        convert.vit_to_trainable(config, params, device=device, mesh=mesh),
        tx)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer ``labels`` under f32 ``logits``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def _take_target(logp: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(logp, tgt[..., None], -1)[..., 0]``: a
    target in ``[-V, 0)`` wraps, any other outside ``[0, V)`` reads NaN
    (never an out-of-range gather on the card)."""
    V = logp.shape[-1]
    t = tgt.long()
    t = torch.where(t < 0, t + V, t)
    bad = (t < 0) | (t >= V)
    ll = torch.gather(logp, -1, t.clamp(0, V - 1)[..., None])[..., 0]
    return ll.masked_fill(bad, float("nan"))


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token negative log-likelihood of logits split over the
    vocabulary: the row max, the sum of exponentials and the target's
    logit are all-reduced over the group; the backward is local
    (``softmax - onehot`` on this rank's block)."""

    @staticmethod
    def forward(ctx, logits, tgt, vocab_size, group):
        x = logits.float()
        Vl = x.shape[-1]
        start = tdist.get_group_rank(group, tdist.get_rank()) * Vl
        m = x.amax(dim=-1)
        tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        se = e.sum(dim=-1)
        t = tgt.long()
        t = torch.where(t < 0, t + vocab_size, t)
        bad = (t < 0) | (t >= vocab_size)
        local = t - start
        mine = (local >= 0) & (local < Vl)
        tl = torch.gather(x, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
        tl = torch.where(mine, tl, torch.zeros_like(tl))
        both = torch.stack([se, tl])
        tdist.all_reduce(both, group=group)
        se, tl = both[0], both[1]
        nll = (m + torch.log(se)) - tl
        ctx.save_for_backward(e / se[..., None], local, mine)
        ctx.dtype = logits.dtype
        return nll.masked_fill(bad, float("nan"))

    @staticmethod
    def backward(ctx, g):
        probs, local, mine = ctx.saved_tensors
        grad = probs * g[..., None]
        hit = torch.where(mine, -g, torch.zeros_like(g))
        grad.scatter_add_(-1, local.clamp(0, probs.shape[-1] - 1)[..., None],
                          hit[..., None])
        return grad.to(ctx.dtype), None, None, None


def _token_ll(logits: torch.Tensor, tgt: torch.Tensor,
              mesh=None, vocab_size: int = 0) -> torch.Tensor:
    """Log-likelihood of each target under f32 softmax of ``logits``;
    with ``mesh``, ``logits`` is this rank's block of a vocabulary of
    ``vocab_size`` split over ``tp``."""
    if mesh is None:
        return _take_target(torch.log_softmax(logits.float(), dim=-1), tgt)
    return -_VocabParallelNLL.apply(logits, tgt, vocab_size,
                                    pmesh.axis_group(mesh, "tp"))


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                    mesh=None) -> torch.Tensor:
    """Causal LM loss: predict ``tokens[:, 1:]`` from ``logits[:, :-1]``.
    With ``mesh``, ``logits`` is this rank's block of a vocabulary split
    evenly over the mesh's ``tp`` axis (vocab-parallel)."""
    V = logits.shape[-1] * (pmesh.axis_size(mesh, "tp") if mesh else 1)
    return -_token_ll(logits[:, :-1], tokens[:, 1:], mesh, V).mean()


def _chunk_ll(h: torch.Tensor, embed: torch.Tensor, tgt: torch.Tensor,
              softcap: float, mesh, vocab_size: int) -> torch.Tensor:
    logits = (h @ embed.to(h.dtype).t()).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return _token_ll(logits, tgt, mesh, vocab_size).sum()


def _chunked_ll_sum(hidden: torch.Tensor, embed: torch.Tensor,
                    tgt: torch.Tensor, chunk: int, softcap: float,
                    mesh=None) -> torch.Tensor:
    """The summed log-likelihood of ``tgt`` (one per position of
    ``hidden``) with the vocab projection per ``chunk`` positions,
    recomputed in the backward."""
    V = embed.shape[0] * (pmesh.axis_size(mesh, "tp") if mesh else 1)
    if mesh is not None:
        hidden = copy_to(hidden, mesh, "tp")
    total = hidden.new_zeros((), dtype=torch.float32)
    n = tgt.shape[1]
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        total = total + checkpoint(_chunk_ll, hidden[:, c0:c1], embed,
                                   tgt[:, c0:c1], softcap, mesh, V,
                                   use_reentrant=False)
    return total


def chunked_next_token_loss(hidden: torch.Tensor, embed: torch.Tensor,
                            tokens: torch.Tensor, *, chunk: int = 4096,
                            softcap: float = 0.0, mesh=None) -> torch.Tensor:
    """:func:`next_token_loss` from HIDDEN states, with the vocab
    projection done per ``chunk`` positions and recomputed in the
    backward (``torch.utils.checkpoint``), so only ``(B, chunk, V)``
    logits live at once. The head's math: tied-embedding product in
    the activation dtype, f32 softmax, optional softcap. The last chunk
    is short where the reference pads it and masks the padding out;
    the sum is the same. With ``mesh``, ``embed`` is this rank's block
    of a vocabulary split over ``tp`` and the loss is vocab-parallel."""
    B, S, _ = hidden.shape
    total = _chunked_ll_sum(hidden[:, :-1], embed, tokens[:, 1:], chunk,
                            softcap, mesh)
    return -total / (B * (S - 1))


def _batch_axes(rules) -> Tuple[str, ...]:
    return pmesh.batch_axes(rules)


def _row_axes(model, rules) -> Tuple[str, ...]:
    """The axes a model's rows split over: the batch rule's, less the
    sequence's axis of a context-parallel model built over a mesh."""
    sp = getattr(model, "split", None)
    return sp.data_axes if sp is not None else _batch_axes(rules)


def _lm_loss(model, out, tokens, mesh, loss_chunk, softcap):
    """``next_token_loss`` (chunked with ``loss_chunk``) of ``out``, the
    model's logits or hidden states for this rank's ``tokens``: its
    vocabulary block under ``tp``; under context parallelism its block
    of the positions, each predicting the next token (the sequence's
    last position predicts none), over the whole rows' count."""
    sp = getattr(model, "split", None)
    vocab = mesh if sp is not None and sp.tp > 1 and sp.vocab_sharded \
        else None
    embed = (dict(model.named_parameters())["token_embed"]
             if loss_chunk else None)
    if sp is not None and sp.seq:
        B, S = tokens.shape
        n = S // sp.seq
        tgt = tokens[:, sp.seq_rank * n + 1:(sp.seq_rank + 1) * n + 1]
        h = out[:, :tgt.shape[1]]
        total = (_chunked_ll_sum(h, embed, tgt, loss_chunk, softcap, vocab)
                 if loss_chunk else _token_ll(
                     h, tgt, vocab, h.shape[-1] * (sp.tp if vocab else 1))
                 .sum())
        return -total / (B * (S - 1))
    if loss_chunk:
        return chunked_next_token_loss(out, embed, tokens, chunk=loss_chunk,
                                       softcap=softcap, mesh=vocab)
    return next_token_loss(out, tokens, mesh=vocab)


def _my_rows(x, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """This rank's rows of a global batch, split over ``axes``; a
    :class:`~kubeflow_tpu_torch.parallel.mesh.RankRows` (``device_feed``
    over the mesh) holds them already and gives them up as they are."""
    if isinstance(x, pmesh.RankRows):
        return x.rows
    x = torch.as_tensor(x)
    n = pmesh.axis_size(mesh, axes)
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not divide over "
                         f"{n} data-parallel ranks")
    return pmesh.local_block(x, pmesh.PartitionSpec(axes), mesh)


def _reduce(grads: Sequence[torch.Tensor], specs: Sequence[Any],
            extra: torch.Tensor, mesh, axes: Tuple[str, ...], divide: int):
    """Sum each gradient over the axes of ``axes`` it is not split on,
    and the f32 vector ``extra`` over all of them, then divide by
    ``divide``; returns the new gradients and ``extra``.

    One all-reduce of one flat buffer a distinct set of axes: the
    replicated and tensor-split leaves (and ``extra``) over ``axes``;
    expert leaves, split over ``dp``, whose gradient the dispatch's
    reduce-scatter has already summed over ``dp``, over the rest (none
    within one slice). A set of size 1 sends nothing."""
    split = [set(pmesh.spec_axes(sp)) for sp in specs]
    groups: Dict[Tuple[str, ...], List[int]] = {tuple(axes): []}
    for i, own in enumerate(split):
        groups.setdefault(tuple(a for a in axes if a not in own),
                          []).append(i)
    out: List[Any] = [None] * len(grads)
    for over, idx in groups.items():
        main = over == tuple(axes)
        parts = [grads[i].reshape(-1).float() for i in idx]
        if main:
            parts.append(extra.reshape(-1).float())
        if not parts:
            continue
        flat = torch.cat(parts)
        if pmesh.axis_size(mesh, over) > 1:
            tdist.all_reduce(flat, group=pmesh.axis_group(mesh, over))
        flat.div_(divide)
        off = 0
        for i in idx:
            g = grads[i]
            out[i] = flat[off:off + g.numel()].view_as(g).to(g.dtype)
            off += g.numel()
        if main:
            extra = flat[off:]
    return out, extra


def _split_norm(grads: Sequence[torch.Tensor], specs: Sequence[Any],
                mesh) -> torch.Tensor:
    """The global norm of a model split over the mesh: a gradient's
    squares summed over every axis it is split on (``tp`` for the
    tensor-split leaves, ``pp`` for a stage's, ``dp`` for the experts'),
    a replicated one's counted once. The squares are summed by split
    pattern, then one all-reduce an axis: a pattern without the axis
    adds only its axis-rank-0 value, so a replicated sum passes exactly."""
    zero = grads[0].new_zeros((), dtype=torch.float32)
    buckets: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, sp in zip(grads, specs):
        key = tuple(a for a in pmesh.MESH_AXES if a in pmesh.spec_axes(sp)
                    and pmesh.axis_size(mesh, a) > 1)
        buckets[key] = buckets.get(key, zero) + g.float().square().sum()
    keys = sorted(buckets)
    sums = torch.stack([buckets[k] for k in keys])
    for axis in pmesh.MESH_AXES:
        if not any(axis in k for k in keys):
            continue
        mine = torch.tensor([axis in k for k in keys], device=sums.device)
        if pmesh.axis_index(mesh, axis) != 0:
            sums = torch.where(mine, sums, torch.zeros_like(sums))
        tdist.all_reduce(sums, group=pmesh.axis_group(mesh, axis))
    return torch.sqrt(sums.sum())


def _check_mesh(state: TrainState, mesh) -> None:
    """A module built over a mesh trains only in a step over that mesh
    (its collectives and loss must agree); a whole module trains in any."""
    if state.mesh is not None and state.mesh is not mesh:
        raise ValueError("the step's mesh is not the one the model was "
                         "built over")


def make_lm_train_step(mesh=None, rules=pmesh.DEFAULT_RULES, *,
                       moe_aux_weight: float = 0.01,
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

    ``mesh``: ``tokens`` is the global batch and the state's module is
    built over ``mesh`` (:func:`create_sharded_state`) or is whole on
    every rank; see the module docstring for what the step exchanges.
    """
    def step(state: TrainState, tokens) -> Tuple[TrainState, Dict[str, Any]]:
        model = state.module
        if loss_chunk and not getattr(model, "return_hidden", False):
            raise ValueError("loss_chunk needs a model that returns hidden "
                             "states (return_hidden=True)")
        _check_mesh(state, mesh)
        axes = _row_axes(model, rules)
        if mesh is not None:
            tokens = _my_rows(tokens, mesh, axes)
        tokens = torch.as_tensor(tokens, device=state.device)
        params = state.params
        out, aux = model(tokens, return_aux=True)
        loss = _lm_loss(model, out, tokens, mesh, loss_chunk,
                        logits_softcap)
        sp = model.split if mesh is not None else None
        if sp is not None and sp.seq:
            # each sequence rank's loss is a share of its rows', but each
            # holds the whole batch's aux: it adds its share of that
            aux = aux / sp.seq
        grads = torch.autograd.grad(loss + moe_aux_weight * aux, params)
        loss = loss.detach()
        if mesh is None:
            grad_norm = global_norm(grads)
        else:
            # summed over the rows' axes and, under context parallelism,
            # the sequence's; averaged over the rows'
            grads, extra = _reduce(grads, state.param_specs, loss, mesh,
                                   sp.token_axes if sp is not None else axes,
                                   pmesh.axis_size(mesh, axes))
            loss = extra[0]
            grad_norm = _split_norm(grads, state.param_specs, mesh)
        state.apply_gradients(grads, grad_norm)
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "step": state.step}

    return step


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """The MLM objective: cross-entropy at the weighted positions, over
    ``max(sum(weights), 1)``."""
    return _masked_ll(logits, labels, weights) / weights.sum().clamp_min(1.0)


def _masked_ll(logits, labels, weights, mesh=None) -> torch.Tensor:
    """Minus the weighted sum of the labels' log-likelihoods; with
    ``mesh``, ``logits`` is this rank's block of a vocabulary split over
    ``tp`` (vocab-parallel, as :func:`next_token_loss`)."""
    if mesh is not None:
        V = logits.shape[-1] * pmesh.axis_size(mesh, "tp")
        return -(_token_ll(logits, labels, mesh, V) * weights).sum()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -(ll * weights).sum()


def _split_model(state: TrainState):
    """The state's model split over ``tp``: its ``_Split``, else None."""
    sp = getattr(state.module, "split", None)
    return sp if sp is not None and sp.tp > 1 else None


def make_mlm_train_step(mesh=None, rules=pmesh.DEFAULT_RULES):
    """The masked-LM train step: ``step(state, tokens, labels, weights)
    -> (state, metrics)``. ``tokens`` are the corrupted inputs,
    ``labels`` the originals and ``weights`` mark the masked positions;
    all go to the device of the state's parameters. ``metrics`` holds
    ``loss``, ``grad_norm`` (of the raw gradients) and ``step``, as in
    :func:`make_lm_train_step`.

    ``mesh``: the inputs are the global batch, each rank trains on its
    rows, and the loss's denominator is the global batch's weight sum
    (one all-reduce before the forward). The model is whole on every
    rank, or built over the mesh (``create_bert_train_state(...,
    mesh=)``): under ``tp`` the loss is vocab-parallel where the
    vocabulary is split, the gradients are averaged as in
    :func:`make_lm_train_step` and the norm counts each split leaf's
    squares over ``tp``. Over ``pp`` > 1 every stage rank computes its
    data rank's rows, as the reference's step replicates over ``pp``
    (no leaf of the encoders carries the ``stage`` axis there)."""
    axes = _batch_axes(rules)

    def step(state: TrainState, tokens, labels, weights
             ) -> Tuple[TrainState, Dict[str, Any]]:
        dev = state.device
        if mesh is not None:
            tokens, labels, weights = (_my_rows(x, mesh, axes)
                                       for x in (tokens, labels, weights))
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        weights = torch.as_tensor(weights, device=dev, dtype=torch.float32)
        params = state.params
        sp = _split_model(state)
        if sp is not None:
            _check_mesh(state, mesh)
        logits = state.module(tokens)
        if mesh is None:
            loss = masked_lm_loss(logits, labels, weights)
        else:
            dp = pmesh.axis_size(mesh, axes)
            wsum = weights.sum()
            tdist.all_reduce(wsum, group=pmesh.axis_group(mesh, axes))
            vocab = mesh if sp is not None and sp.vocab_sharded else None
            # the dp average of these terms is the global batch's loss
            loss = _masked_ll(logits, labels, weights, vocab) * dp \
                / wsum.clamp_min(1.0)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if mesh is None:
            grad_norm = global_norm(grads)
        else:
            specs = state.param_specs
            grads, extra = _reduce(grads, specs, loss, mesh, axes, dp)
            loss = extra[0]
            grad_norm = (global_norm(grads) if sp is None
                         else _split_norm(grads, specs, mesh))
        state.apply_gradients(grads, grad_norm)
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "step": state.step}

    return step


def _pipeline_rows(tokens, mesh, axes: Tuple[str, ...],
                   n_microbatches: int) -> torch.Tensor:
    """This rank's rows of a global ``(B, S)`` batch for the pipeline,
    microbatch-major: microbatch ``m`` is the reference's, global rows
    ``[m B/M, (m+1) B/M)``, and each data-parallel rank takes its block
    of every microbatch, so a microbatch's tokens in rank order are the
    reference's in order. A rank's contiguous rows (``device_feed``
    over the mesh) are not its block of every microbatch, so they are
    refused at dp > 1; at dp = 1 they are the global batch."""
    n = pmesh.axis_size(mesh, axes)
    if isinstance(tokens, pmesh.RankRows):
        if n > 1:
            raise ValueError(
                f"the pipelined step takes the global batch: a rank's rows "
                f"from device_feed over the mesh are not its block of each "
                f"microbatch at {n} data-parallel ranks; feed it "
                f"device_feed(loader, device)")
        tokens = tokens.rows
    x = torch.as_tensor(tokens)
    B, M = x.shape[0], n_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if (B // M) % n:
        raise ValueError(f"microbatch of {B // M} rows does not divide over "
                         f"{n} data-parallel ranks")
    x = x.reshape(M, B // M, *x.shape[1:])
    x = pmesh.local_block(x, pmesh.PartitionSpec(None, axes), mesh)
    return x.reshape(-1, *x.shape[2:])


def make_pipelined_lm_train_step(mesh, *, n_microbatches: int,
                                 rules=pmesh.DEFAULT_RULES):
    """The LM train step with the block stack pipelined over ``pp``
    (``parallel/pipeline.py``): ``step(state, tokens) -> (state,
    metrics)``, the reference's ``make_pipelined_lm_train_step``.

    ``tokens`` is the global batch; the state's module is built over
    ``mesh`` (:func:`create_sharded_state`, ``pipelined=True``), so each
    rank holds its stage. The loss is ``next_token_loss`` over the
    reassembled logits (vocab-parallel under ``tp``); MoE load-balance
    losses are not collected on this path, as the reference's docstring
    says. A model under ring/Ulysses is refused, as the reference's step
    fails on it (its forward runs: ``parallel/pipeline.py``).
    ``metrics`` are ``loss``, ``grad_norm`` and ``step``, as in
    :func:`make_lm_train_step`. The gradients (with the loss) are
    averaged over the data axes as there; a stage's leaves count their
    squares over ``pp`` in the norm, the replicated leaves once."""

    def step(state: TrainState, tokens) -> Tuple[TrainState, Dict[str, Any]]:
        from kubeflow_tpu_torch.parallel.pipeline import (
            make_pipelined_lm_forward,
        )

        model = state.module
        _check_mesh(state, mesh)
        if model.split is not None and model.split.seq:
            raise NotImplementedError(
                "ring/ulysses inside the pipelined train step: the "
                "reference's step fails to lower it (its ring or all-to-all "
                "in a shard_map nested in the pipeline's), so the port "
                "refuses it too (ROADMAP, Found in the reference); the "
                "pipelined forward runs it")
        axes = _row_axes(model, rules)
        tokens = torch.as_tensor(
            _pipeline_rows(tokens, mesh, axes, n_microbatches),
            device=state.device)
        params = state.params
        fwd = make_pipelined_lm_forward(model, mesh,
                                        n_microbatches=n_microbatches)
        loss = _lm_loss(model, fwd(tokens), tokens, mesh, None, 0.0)
        grads = torch.autograd.grad(loss, params)
        specs = state.param_specs
        grads, extra = _reduce(grads, specs, loss.detach(), mesh, axes,
                               pmesh.axis_size(mesh, axes))
        grad_norm = _split_norm(grads, specs, mesh)
        state.apply_gradients(grads, grad_norm)
        return state, {"loss": extra[0], "grad_norm": grad_norm,
                       "step": state.step}

    return step


def make_image_train_step(mesh=None, rules=pmesh.DEFAULT_RULES):
    """The classifier train step: ``step(state, images, labels) ->
    (state, metrics)``, with BN statistics updated by the train-mode
    forward when the module has any. ``metrics`` holds ``loss``,
    ``accuracy`` and ``grad_norm`` (the global norm of the averaged
    gradients, which clipping reads; 0-dim tensors on the device) and
    ``step`` (the count after this update). ``images`` and ``labels`` go to the device of
    the state's parameters.

    ``mesh``: the inputs are the global batch, and each rank trains on
    its rows (the ``batch`` rule: ``("dcn", "dp")``), as the reference's
    step does under GSPMD. BatchNorm takes its statistics over the
    global batch (``models/resnet.py:global_batch_stats``), so the
    running statistics come out equal on every rank; one all-reduce of
    one flat buffer over the data axes averages the gradients, the loss
    and the accuracy. ViT and the MNIST CNN have no cross-row state and
    need nothing more. Under ``tp`` a ViT built over the mesh
    (``create_vit_train_state(..., mesh=)``) holds its blocks' heads and
    MLP split, as the reference's rules assign them; its gradients are
    averaged as in :func:`make_lm_train_step` and the clipping norm
    counts each split leaf's squares over ``tp``. ResNet's and the MNIST
    CNN's leaf names take no split in those rules, so they stay whole
    and each ``tp`` rank runs its data rank's rows; so does each ``pp``
    rank (the reference replicates the step over ``pp``)."""
    from kubeflow_tpu_torch.models.resnet import global_batch_stats

    axes = _batch_axes(rules)

    def step(state: TrainState, images, labels
             ) -> Tuple[TrainState, Dict[str, Any]]:
        if mesh is not None:
            images, labels = (_my_rows(x, mesh, axes)
                              for x in (images, labels))
        images = torch.as_tensor(images, device=state.device)
        labels = torch.as_tensor(labels, device=state.device).long()
        params = state.params
        sp = _split_model(state)
        if sp is not None:
            _check_mesh(state, mesh)
        if mesh is None:
            logits = state.module(images, train=True)
        else:
            with global_batch_stats(mesh, axes):
                logits = state.module(images, train=True)
        loss = softmax_cross_entropy(logits, labels)
        with torch.no_grad():
            acc = (logits.argmax(dim=-1) == labels).float().mean()
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if mesh is not None:
            grads, extra = _reduce(
                grads, state.param_specs, torch.stack([loss, acc]), mesh,
                axes, pmesh.axis_size(mesh, axes))
            loss, acc = extra[0], extra[1]
        grad_norm = (global_norm(grads) if sp is None
                     else _split_norm(grads, state.param_specs, mesh))
        state.apply_gradients(grads, grad_norm)
        return state, {"loss": loss, "accuracy": acc,
                       "grad_norm": grad_norm, "step": state.step}

    return step
