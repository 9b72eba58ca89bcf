"""Capacity-based MoE dispatch (GShard/Switch style), on one device or
with the experts split over a mesh axis.

PyTorch port of ``kubeflow_tpu/ops/moe.py``: tokens are scattered into
per-expert buffers of static capacity ``C``, the experts run their FFN
once over ``(E, C, D)``, and the results combine back weighted by the
router gates. Dispatch and combine are one-hot tensors built exactly as
the reference builds them; tokens past an expert's capacity are dropped
(they contribute zero).

Over a mesh (``mesh=``) each rank holds its rows of the global batch,
split over the data axes (``("dcn", "dp")``), and the reference's
program is global: ``C`` comes from the global token count, and slots
fill in the global token order (rank-major over the data axes), all
first choices before any second choice. So each rank all-gathers every
rank's per-round, per-expert counts (``k × E`` numbers), offsets its
slot positions by the counts of the ranks below it and of the earlier
rounds, and builds its share of the ``(E, C, D)`` buffer (zeros in the
slots of other ranks' tokens). With the experts split over ``ep_axis``
(the ``expert`` rule: ``dp``), one reduce-scatter over that axis sums
the shares onto the experts' owners (``E / dp`` a rank; across slices a
further all-reduce over ``dcn`` adds the other slices' tokens), the
local experts run, and one all-gather brings the outputs back for the
local combine. Both exchanges are differentiable
(``ops/collectives.py``). The buffers are dense, as the reference's
are: the reduce-scatter moves ``(dp - 1) / dp`` of ``E · C · D``
elements a rank and layer, filled slots or not; an all-to-all of the
filled slots alone would move fewer, and is not built here.

The load-balance loss is the reference's global one: ``E · Σ density ·
mean_prob`` with both means over the global batch, from sums
all-reduced (differentiably) over the data axes before the product.

These are plain PyTorch products and collectives, as the reference's
are XLA einsums: no Pallas kernel stands behind them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.ops import collectives as col
from kubeflow_tpu_torch.parallel import mesh as pmesh

DATA_AXES = ("dcn", "dp")


def expert_capacity(n_tokens: int, n_experts: int, k: int,
                    capacity_factor: float, *, multiple_of: int = 8) -> int:
    """Static per-expert buffer size: cf · (tokens·k / E), padded up."""
    c = int(capacity_factor * n_tokens * k / n_experts) + 1
    return -(-c // multiple_of) * multiple_of


def global_mean(sums: torch.Tensor, count: int, mesh,
                axes: Sequence[str] = DATA_AXES) -> torch.Tensor:
    """The mean over the global batch from this rank's ``sums`` over its
    ``count`` rows: summed over ``axes`` (differentiably), over ``count``
    times their size (every rank holds as many rows)."""
    n = pmesh.axis_size(mesh, tuple(axes))
    return col.all_reduce_grad(sums, mesh, tuple(axes)) / (count * n)


def _counts_around(counts: torch.Tensor, mesh, axes
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(below, total)``: the ``(k, E)`` counts of the ranks below this
    one along ``axes`` (rank-major), and of every rank."""
    if mesh is None or pmesh.axis_size(mesh, tuple(axes)) == 1:
        return torch.zeros_like(counts), counts
    every = col.all_gather(counts[None], mesh, tuple(axes))  # (n, k, E)
    me = pmesh.axis_index(mesh, tuple(axes))
    return every[:me].sum(dim=0), every.sum(dim=0)


def capacity_dispatch(gate_logits: torch.Tensor, k: int, capacity: int, *,
                      mesh=None, axes: Sequence[str] = DATA_AXES
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dispatch (G, E, C) f32, combine (G, E, C) f32, aux)`` for top-k
    capacity routing of ``(G, E)`` router logits.

    Token ``t`` goes to its k chosen experts at the next free slot of
    each; slots past ``capacity`` drop. All first choices are placed
    before any second choice, lower tokens first (GShard's order). With
    ``mesh``, ``gate_logits`` are this rank's tokens of a global batch
    split over ``axes``: slots and ``aux`` are the global batch's."""
    G, E = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)            # (G, K)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehots = [torch.nn.functional.one_hot(idx[:, j], E).float()
               for j in range(k)]
    below, total = _counts_around(
        torch.stack([oh.sum(dim=0) for oh in onehots]), mesh, axes)
    slots = torch.arange(capacity, device=dev)
    dispatch = torch.zeros((G, E, capacity), device=dev)
    combine = torch.zeros((G, E, capacity), device=dev)
    used = torch.zeros((E,), device=dev)   # slots every rank used so far
    for j, onehot in enumerate(onehots):
        pos = torch.cumsum(onehot, dim=0) - onehot + (used + below[j])[None]
        keep = (pos < capacity).float() * onehot
        # one_hot of an index past C is all zeros, as jax.nn.one_hot's
        slot = (pos.to(torch.int32)[..., None] == slots).float()
        dispatch = dispatch + keep[..., None] * slot
        combine = combine + (keep * weights[:, j:j + 1])[..., None] * slot
        used = used + total[j]
    if mesh is None:
        density = onehots[0].mean(dim=0)
        mean_prob = probs.mean(dim=0)
    else:
        density, mean_prob = global_mean(
            torch.stack([onehots[0].sum(dim=0), probs.sum(dim=0)]), G, mesh,
            axes)
    aux = E * (density * mean_prob).sum()
    return dispatch, combine, aux


def capacity_moe(x: torch.Tensor, gate_logits: torch.Tensor,
                 expert_fn: Callable[[torch.Tensor], torch.Tensor], *,
                 k: int, capacity_factor: float = 1.25,
                 capacity: Optional[int] = None, mesh=None,
                 axes: Sequence[str] = DATA_AXES,
                 ep_axis: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``(G, D)`` tokens → ``expert_fn`` over ``(E, C, D)`` buffers
    → combine. Returns ``(y (G, D'), aux)``.

    With ``mesh`` (the module docstring), ``x`` is this rank's tokens of
    a global batch split over ``axes``, and ``expert_fn`` runs this
    rank's experts: ``E / n`` of them, block ``i`` for rank ``i`` of
    ``ep_axis`` (size ``n``), or all ``E`` where ``ep_axis`` is None."""
    G = x.shape[0]
    E = gate_logits.shape[-1]
    axes = tuple(axes)
    n_data = pmesh.axis_size(mesh, axes) if mesh is not None else 1
    C = capacity if capacity is not None else expert_capacity(
        G * n_data, E, k, capacity_factor)
    dispatch, combine, aux = capacity_dispatch(gate_logits, k, C,
                                               mesh=mesh, axes=axes)
    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(x.dtype), x)
    if mesh is not None:
        rest = axes
        if ep_axis is not None:
            expert_in = col.reduce_scatter_grad(expert_in, mesh, ep_axis)
            rest = tuple(a for a in axes if a != ep_axis)
        if pmesh.axis_size(mesh, rest) > 1:
            expert_in = col.all_reduce_grad(expert_in, mesh, rest)
    expert_out = expert_fn(expert_in)
    if mesh is not None and ep_axis is not None:
        expert_out = col.all_gather_grad(expert_out, mesh, ep_axis)
    y = torch.einsum("gec,ecd->gd", combine.to(expert_out.dtype),
                     expert_out)
    return y, aux
