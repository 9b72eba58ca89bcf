"""Capacity-based MoE dispatch (GShard/Switch style), on one device or
with the experts split over a mesh axis.

PyTorch port of ``kubeflow_tpu/ops/moe.py``: tokens are scattered into
per-expert buffers of static capacity ``C``, the experts run their FFN
once over ``(E, C, D)``, and the results combine back weighted by the
router gates. Dispatch and combine are one-hot tensors built exactly as
the reference builds them; tokens past an expert's capacity are dropped
(they contribute zero).

Over a mesh (``mesh=``) each rank holds its rows of the global batch,
split over the data axes (``("dcn", "dp")``), and under context
parallelism only its block of each row's positions, split over
``seq_axis``. The reference's program is global: ``C`` comes from the
global token count, and slots fill in the global order of the
flattened ``(b, s)`` tokens, all first choices before any second
choice. Under context parallelism that order interleaves the sequence
ranks row by row, so the counts are exchanged per row: each rank
all-gathers every token-holding rank's per-row, per-round, per-expert
counts (``rows × k × E`` numbers), offsets each row's slot positions by
the counts of every (row, sequence block) before it and of the earlier
rounds, and builds its share of the ``(E, C, D)`` buffer (zeros in the
slots of other ranks' tokens). With the experts split over ``ep_axis``
(the ``expert`` rule: ``dp``), one reduce-scatter over that axis sums
the shares onto the experts' owners (``E / dp`` a rank; a further
all-reduce over the other token axes, ``dcn`` across slices and the
sequence's axis, adds the other ranks' tokens), the local experts run,
and one all-gather brings the outputs back for the local combine. Both exchanges are differentiable
(``ops/collectives.py``). The buffers are dense, as the reference's
are: the reduce-scatter moves ``(dp - 1) / dp`` of ``E · C · D``
elements a rank and layer, filled slots or not; an all-to-all of the
filled slots alone would move fewer, and is not built here.

The load-balance loss is the reference's global one: ``E · Σ density ·
mean_prob`` with both means over the global batch, from sums
all-reduced (differentiably) over the token axes before the product.

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


def _counts_around(counts: torch.Tensor, mesh, axes,
                   seq_axis: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(below, total)`` from this rank's ``(R, k, E)`` counts of its
    ``R`` rows (one block of rows where ``seq_axis`` is None): for each
    row, the counts of every token before the row's block in the global
    order of the flattened ``(b, s)`` tokens (rows split over ``axes``,
    each row's positions over ``seq_axis``), and the ``(k, E)`` counts
    of every token."""
    tok = pmesh.mesh_order(tuple(axes) + ((seq_axis,) if seq_axis else ()))
    if mesh is None or pmesh.axis_size(mesh, tok) == 1:
        below = torch.cumsum(counts, dim=0) - counts
        return below, counts.sum(dim=0)
    R = counts.shape[0]
    every = col.all_gather(counts[None], mesh, tok)     # (n, R, k, E)
    sizes = [pmesh.axis_size(mesh, a) for a in tok]
    data = [a for a in tok if a != seq_axis]
    Q = pmesh.axis_size(mesh, seq_axis) if seq_axis else 1
    D = pmesh.axis_size(mesh, tuple(data))
    # order the gathered blocks as the tokens: (data rank, row, seq rank)
    grid = every.reshape(*sizes, R, *counts.shape[1:])
    perm = [tok.index(a) for a in data]
    perm += [len(tok)] + ([tok.index(seq_axis)] if seq_axis else [])
    perm += [len(tok) + 1, len(tok) + 2]
    flat = grid.permute(*perm).reshape(D * R * Q, *counts.shape[1:])
    before = torch.cumsum(flat, dim=0) - flat
    d = pmesh.axis_index(mesh, tuple(data)) if data else 0
    q = pmesh.axis_index(mesh, seq_axis) if seq_axis else 0
    rows = (d * R + torch.arange(R, device=counts.device)) * Q + q
    return before[rows], flat.sum(dim=0)


def capacity_dispatch(gate_logits: torch.Tensor, k: int, capacity: int, *,
                      mesh=None, axes: Sequence[str] = DATA_AXES,
                      rows: int = 1, seq_axis: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dispatch (G, E, C) f32, combine (G, E, C) f32, aux)`` for top-k
    capacity routing of ``(G, E)`` router logits.

    Token ``t`` goes to its k chosen experts at the next free slot of
    each; slots past ``capacity`` drop. All first choices are placed
    before any second choice, lower tokens first (GShard's order). With
    ``mesh``, ``gate_logits`` are this rank's tokens of a global batch,
    ``rows`` rows of ``G / rows`` positions each, the rows split over
    ``axes`` and each row's positions over ``seq_axis`` (None: every
    position here): slots and ``aux`` are the global batch's."""
    G, E = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)            # (G, K)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehots = [torch.nn.functional.one_hot(idx[:, j], E).float()
               for j in range(k)]
    R = rows if seq_axis else 1        # blocks of consecutive tokens
    below, total = _counts_around(
        torch.stack([oh.reshape(R, -1, E).sum(dim=1) for oh in onehots],
                    dim=1), mesh, axes, seq_axis)          # (R, k, E)
    slots = torch.arange(capacity, device=dev)
    dispatch = torch.zeros((G, E, capacity), device=dev)
    combine = torch.zeros((G, E, capacity), device=dev)
    used = torch.zeros((E,), device=dev)   # slots every rank used so far
    for j, onehot in enumerate(onehots):
        blocks = onehot.reshape(R, -1, E)
        pos = (torch.cumsum(blocks, dim=1) - blocks
               + (used[None] + below[:, j])[:, None]).reshape(G, E)
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
            pmesh.mesh_order(tuple(axes) + ((seq_axis,) if seq_axis
                                            else ())))
    aux = E * (density * mean_prob).sum()
    return dispatch, combine, aux


def capacity_moe(x: torch.Tensor, gate_logits: torch.Tensor,
                 expert_fn: Callable[[torch.Tensor], torch.Tensor], *,
                 k: int, capacity_factor: float = 1.25,
                 capacity: Optional[int] = None, mesh=None,
                 axes: Sequence[str] = DATA_AXES,
                 ep_axis: Optional[str] = None, rows: int = 1,
                 seq_axis: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``(G, D)`` tokens → ``expert_fn`` over ``(E, C, D)`` buffers
    → combine. Returns ``(y (G, D'), aux)``.

    With ``mesh`` (the module docstring), ``x`` is this rank's tokens of
    a global batch, ``rows`` rows split over ``axes`` with their
    positions split over ``seq_axis`` (:func:`capacity_dispatch`), and
    ``expert_fn`` runs this rank's experts: ``E / n`` of them, block
    ``i`` for rank ``i`` of ``ep_axis`` (size ``n``), or all ``E`` where
    ``ep_axis`` is None."""
    G = x.shape[0]
    E = gate_logits.shape[-1]
    axes = pmesh.mesh_order(tuple(axes) + ((seq_axis,) if seq_axis
                                           else ()))
    n_tok = pmesh.axis_size(mesh, axes) if mesh is not None else 1
    C = capacity if capacity is not None else expert_capacity(
        G * n_tok, E, k, capacity_factor)
    dispatch, combine, aux = capacity_dispatch(
        gate_logits, k, C, mesh=mesh,
        axes=tuple(a for a in axes if a != seq_axis), rows=rows,
        seq_axis=seq_axis)
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
