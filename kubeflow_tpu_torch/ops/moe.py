"""Capacity-based MoE dispatch (GShard/Switch style) on one device.

PyTorch port of ``kubeflow_tpu/ops/moe.py``: tokens are scattered into
per-expert buffers of static capacity ``C``, the experts run their FFN
once over ``(E, C, D)``, and the results combine back weighted by the
router gates. Dispatch and combine are one-hot tensors built exactly as
the reference builds them; tokens past an expert's capacity are dropped
(they contribute zero). There is no expert-parallel axis yet: the
reference's AllToAll over the ``ep`` group is ROADMAP Queue A 2.2.

These are plain PyTorch products, as the reference's are XLA einsums:
no Pallas kernel stands behind them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def expert_capacity(n_tokens: int, n_experts: int, k: int,
                    capacity_factor: float, *, multiple_of: int = 8) -> int:
    """Static per-expert buffer size: cf · (tokens·k / E), padded up."""
    c = int(capacity_factor * n_tokens * k / n_experts) + 1
    return -(-c // multiple_of) * multiple_of


def capacity_dispatch(gate_logits: torch.Tensor, k: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dispatch (G, E, C) f32, combine (G, E, C) f32, aux)`` for top-k
    capacity routing of ``(G, E)`` router logits.

    Token ``t`` goes to its k chosen experts at the next free slot of
    each; slots past ``capacity`` drop. All first choices are placed
    before any second choice, lower tokens first (GShard's order)."""
    G, E = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)            # (G, K)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    slots = torch.arange(capacity, device=dev)
    dispatch = torch.zeros((G, E, capacity), device=dev)
    combine = torch.zeros((G, E, capacity), device=dev)
    used = torch.zeros((E,), dtype=torch.int32, device=dev)
    for j in range(k):
        onehot = torch.nn.functional.one_hot(idx[:, j], E).float()
        pos = torch.cumsum(onehot, dim=0) - onehot + used[None, :].float()
        keep = (pos < capacity).float() * onehot
        # one_hot of an index past C is all zeros, as jax.nn.one_hot's
        slot = (pos.to(torch.int32)[..., None] == slots).float()
        dispatch = dispatch + keep[..., None] * slot
        combine = combine + (keep * weights[:, j:j + 1])[..., None] * slot
        used = used + onehot.sum(dim=0).to(torch.int32)
    density = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * (density * probs.mean(dim=0)).sum()
    return dispatch, combine, aux


def capacity_moe(x: torch.Tensor, gate_logits: torch.Tensor,
                 expert_fn: Callable[[torch.Tensor], torch.Tensor], *,
                 k: int, capacity_factor: float = 1.25,
                 capacity: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``(G, D)`` tokens → ``expert_fn`` over ``(E, C, D)`` buffers
    → combine. Returns ``(y (G, D'), aux)``."""
    G = x.shape[0]
    E = gate_logits.shape[-1]
    C = capacity if capacity is not None else expert_capacity(
        G, E, k, capacity_factor)
    dispatch, combine, aux = capacity_dispatch(gate_logits, k, C)
    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(x.dtype), x)
    expert_out = expert_fn(expert_in)
    y = torch.einsum("gec,ecd->gd", combine.to(expert_out.dtype),
                     expert_out)
    return y, aux
