"""Pipeline parallelism: the SPMD microbatch pipeline over the ``pp`` axis.

PyTorch port of ``kubeflow_tpu/parallel/pipeline.py``: ``split_stages``
(:43), ``merge_stages`` (:55), ``pipeline_apply`` (:61) and
``make_pipelined_lm_forward`` (:135), under the reference's names and
contracts. The reference is one program, manual over ``pp`` only; here
each rank is one process that holds its own stage and passes it in, as
every collective of the port takes and returns a rank's own block
(``ops/collectives.py``).

The schedule is the reference's tick loop (``pipeline.py:95-118``). For
``M`` microbatches over ``S`` stages there are ``M + S - 1`` ticks; at
tick ``t``:

- stage 0 takes microbatch ``min(t, M - 1)`` (the ticks past ``M`` run
  the last one again: wasted work, never written);
- every stage applies its layers to what it holds;
- the last stage writes microbatch ``t - (S - 1)`` once that is >= 0;
- the activations move one hop along the ring (``ppermute``, shift 1).

Every rank builds the same autograd graph: the choices that depend on
the rank (stage 0's feed, the last stage's writes) are ``torch.where``
on a rank-valued tensor, as the reference's ``jnp.where``, so each
rank's backward issues the same exchanges in the same order, and none
waits on a partner that skipped its half. The last tick's hop, which
nothing reads on any rank, is not sent.

The gradients of what lies outside the stages follow from two
collectives. The microbatches enter through ``copy_to(..., "pp")``, the
transpose of the reference's replicated ``in_specs=P()``: stage 0 alone
reads them, and the backward sums over ``pp``, so each rank gets stage
0's cotangent. The outputs leave through ``reduce_from`` of the last
stage's masked writes (the reference's ``psum(out * mask)``), whose
backward is the identity. So the leaves outside the pipeline
(embedding, final norm, unembedding), replicated over ``pp``, get the
same whole gradient on every rank, and a stage's leaves get theirs on
its own rank.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from kubeflow_tpu_torch.ops import collectives as col
from kubeflow_tpu_torch.parallel import mesh as pmesh

# stage_fn(stage_params, x) -> y: one stage's layers on one microbatch
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """Reshape the leading layer axis ``L`` to ``(n_stages, L /
    n_stages)`` on every leaf of a tensor tree."""

    def reshape(leaf):
        L = leaf.shape[0]
        if L % n_stages:
            raise ValueError(f"layers {L} not divisible by stages "
                             f"{n_stages}")
        return leaf.reshape(n_stages, L // n_stages, *leaf.shape[1:])

    return _tree_map(reshape, stacked_params)


def merge_stages(staged_params: Any) -> Any:
    """The inverse of :func:`split_stages`."""
    return _tree_map(lambda leaf: leaf.reshape(-1, *leaf.shape[2:]),
                     staged_params)


def pipeline_apply(stage_fn: StageFn, stage_params: Any,
                   microbatches: torch.Tensor, *, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """Run ``(M, mb, ...)`` microbatches through the stage pipeline over
    ``axis``; returns the ``(M, mb, ...)`` outputs, the same on every
    rank of the axis. ``stage_params`` is this rank's stage (block ``r``
    of :func:`split_stages`' output on rank ``r``); ``microbatches`` are
    the same on every rank (stage 0 reads them)."""
    n = pmesh.axis_size(mesh, axis)
    rank = pmesh.axis_index(mesh, axis)
    dev = microbatches.device
    M = microbatches.shape[0]
    first = torch.tensor(rank == 0, device=dev)
    last = torch.tensor(rank == n - 1, device=dev)
    total = M + n - 1
    state = torch.zeros_like(microbatches[0])
    outs = [None] * M
    for t in range(total):
        x = torch.where(first, microbatches[min(t, M - 1)], state)
        y = stage_fn(stage_params, x)
        done = t - (n - 1)
        if done >= 0:
            outs[done] = torch.where(last, y, torch.zeros_like(y))
        if n > 1 and t < total - 1:
            state = col.ppermute(y, mesh, axis, 1)
    return col.reduce_from(torch.stack(outs), mesh, axis)


def make_pipelined_lm_forward(model, mesh, *, n_microbatches: int,
                              axis: str = "pp"):
    """``forward(tokens) -> logits`` for a ``Transformer`` built over
    ``mesh``, with its block stack pipelined over ``axis``.

    ``tokens`` are this rank's rows (those of its data-parallel block);
    they split into ``n_microbatches`` microbatches of consecutive rows.
    The embedding, final norm and unembedding run on every rank of the
    axis; the stage is the model's own blocks (``run_blocks``, with
    ``config.remat``: the reference rematerialises every block). MoE
    layers' load-balance losses are not collected on this path, as in
    the reference. The logits are this rank's vocabulary block under
    tensor parallelism. Under context parallelism (ring/Ulysses) each
    rank embeds its block of the positions, the stages hand on ``(B/M,
    S/n, D)`` between the ranks of one sequence coordinate (the ``pp``
    axis' ring), attention inside a stage exchanges K/V over the
    sequence's axis, and the logits are this rank's positions."""
    from kubeflow_tpu_torch.models.transformer import run_blocks

    c, sp = model.config, model.split
    M = n_microbatches
    n = pmesh.axis_size(mesh, axis)
    if n > 1 and (sp is None or sp.pp != n):
        raise ValueError(f"the model is not built over the mesh's {n} "
                         "stages")

    def forward(tokens: torch.Tensor) -> torch.Tensor:
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        table = model.embed_table()
        x, sin, cos = model.embed(tokens, table)
        S = x.shape[1]          # this rank's positions (its sequence block)

        def stage_fn(blocks, h):
            return run_blocks(blocks, h, sin, cos, remat=c.remat)

        mbs = col.copy_to(x.reshape(M, B // M, S, x.shape[-1]), mesh, axis)
        y = pipeline_apply(stage_fn, model.blocks, mbs, mesh=mesh, axis=axis)
        return model.head(y.reshape(B, S, -1), table)

    return forward
