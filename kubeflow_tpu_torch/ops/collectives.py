"""Collectives over one mesh axis, their differentiable forms, and the
bus-bandwidth microbenchmark.

PyTorch port of ``kubeflow_tpu/ops/collectives.py``. The reference takes
the full array and partitions it with ``shard_map``; here every rank
passes its own block and gets its own block back, in the reference's
layouts (``collectives.py:38-59``), over the process group of ``axis``
(``parallel/mesh.py:axis_group``), of size ``n``:

- :func:`all_reduce`: the sum of every rank's tensor;
- :func:`all_gather`: the ranks' tensors concatenated on dim 0, in rank
  order;
- :func:`reduce_scatter`: the sum of every rank's tensor, and rank ``i``
  keeps row block ``i`` of it;
- :func:`all_to_all`: each rank's tensor split into ``n`` blocks along
  ``split_axis``, block ``j`` sent to rank ``j``, the blocks received
  concatenated along ``concat_axis`` in rank order (the reference's
  ``split_axis=1, concat_axis=0`` by default: the MoE dispatch);
- :func:`ppermute_shift`: the tensor of rank ``(i - shift) % n``. At
  ``n = 1`` (or a shift that is a whole turn) the permutation is the
  identity ``[(0, 0)]``, and a copy is what it does: there is nothing to
  send.

The model's collectives are differentiable: :func:`copy_to` (identity
forward, all-reduce backward: Megatron's f) and :func:`reduce_from`
(all-reduce forward, identity backward: its g), :func:`ppermute` (the
backward rotates the other way), :func:`all_to_all_grad` (the
backward is the inverse exchange), :func:`all_reduce_grad` (a sum every
rank uses: all-reduce both ways, the transpose of ``psum``),
:func:`all_gather_grad` (reduce-scatter backward: MoE's dense dispatch
gathers the expert shards) and :func:`reduce_scatter_grad` (all-gather
backward: the capacity dispatch sums its ``(E, C, D)`` buffers onto the
owners of the experts).

Gloo carries all-reduce, all-gather and broadcast on CUDA tensors, but
not point-to-point sends, all-to-all or reduce-scatter (its TCP
transport is handed the device pointer). Those three stage a CUDA
tensor through host memory on a gloo group (:func:`_staged`): the way
two ranks time-share one card, where NCCL refuses them.

:func:`bench_collective` times one collective on a ``size_mb`` buffer
per rank (for ``all_gather``, the gathered output) and reports the
algorithmic bandwidth and the NCCL-tests bus bandwidth; at ``n = 1`` no
byte crosses a link and the bus bandwidth is None.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as tdist

from kubeflow_tpu_torch.parallel.mesh import axis_group, axis_size


def _group(mesh, axis: str):
    return axis_group(mesh, axis), axis_size(mesh, axis)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through host memory for a point-to-point,
    all-to-all or reduce-scatter exchange on ``group``: a CUDA tensor
    on a gloo group."""
    return x.is_cuda and tdist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """Sum over the axis; every rank returns the sum."""
    group, _ = _group(mesh, axis)
    out = x.clone()
    tdist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    tdist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    if _staged(x, group):
        return _scatter(x.cpu(), group, n).to(x.device)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    tdist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    return _gather(x, *_group(mesh, axis))


def reduce_scatter(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    return _scatter(x, *_group(mesh, axis))


def _exchange(x: torch.Tensor, group, n: int, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    if _staged(send, group):
        host = torch.empty_like(send, device="cpu")
        tdist.all_to_all_single(host, send.cpu(), group=group)
        recv.copy_(host)
    else:
        tdist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def all_to_all(x: torch.Tensor, mesh, axis: str = "dp", *,
               split_axis: int = 1, concat_axis: int = 0) -> torch.Tensor:
    """The tiled all-to-all (the reference's ``jax.lax.all_to_all(...,
    tiled=True)``): ``x``'s size along ``split_axis`` must divide by
    ``n``."""
    group, n = _group(mesh, axis)
    return _exchange(x, group, n, split_axis, concat_axis)


def _rotate(x: torch.Tensor, group, n: int, shift: int) -> torch.Tensor:
    shift %= n
    if shift == 0:
        return x.clone()
    if _staged(x, group):
        return _rotate(x.cpu(), group, n, shift).to(x.device)
    me = tdist.get_group_rank(group, tdist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [tdist.P2POp(tdist.isend, x, tdist.get_global_rank(
               group, (me + shift) % n), group),
           tdist.P2POp(tdist.irecv, out, tdist.get_global_rank(
               group, (me - shift) % n), group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return out


def ppermute_shift(x: torch.Tensor, mesh, axis: str = "dp",
                   shift: int = 1) -> torch.Tensor:
    """Ring rotation by ``shift`` hops: rank ``i`` sends to ``(i +
    shift) % n`` and returns what ``(i - shift) % n`` sent."""
    group, n = _group(mesh, axis)
    return _rotate(x, group, n, shift)


# -- differentiable forms -----------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, shift):
        ctx.args = (group, n, shift)
        return _rotate(x, group, n, shift)

    @staticmethod
    def backward(ctx, g):
        group, n, shift = ctx.args
        return _rotate(g, group, n, -shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _exchange(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return (_exchange(g.contiguous(), group, n, concat_axis, split_axis),
                None, None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        return _scatter(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the axis.
    Marks a replicated tensor that each rank uses for its share of a
    sharded computation. An axis of size 1 is the identity."""
    group, n = _group(mesh, axis)
    return x if n == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """All-reduce forward (the partial sums of a sharded product become
    the whole); identity backward. An axis of size 1 is the identity."""
    group, n = _group(mesh, axis)
    return x if n == 1 else _ReduceFrom.apply(x, group)


def ppermute(x: torch.Tensor, mesh, axis: str = "dp",
             shift: int = 1) -> torch.Tensor:
    """:func:`ppermute_shift` with a gradient: the backward rotates the
    cotangent by ``-shift``."""
    group, n = _group(mesh, axis)
    return _Ppermute.apply(x, group, n, shift)


def all_to_all_grad(x: torch.Tensor, mesh, axis: str = "dp", *,
                    split_axis: int = 1,
                    concat_axis: int = 0) -> torch.Tensor:
    """:func:`all_to_all` with a gradient: the backward is the inverse
    exchange (split along ``concat_axis``, concatenate along
    ``split_axis``)."""
    group, n = _group(mesh, axis)
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def all_reduce_grad(x: torch.Tensor, mesh, axis="dp") -> torch.Tensor:
    """The sum over the axis (a name or a tuple of names), which every
    rank then uses: the backward sums the cotangents over the axis too.
    BatchNorm's and the MoE load-balance loss's global-batch sums. An
    axis of size 1 is the identity."""
    return copy_to(reduce_from(x, mesh, axis), mesh, axis)


def all_gather_grad(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """:func:`all_gather` with a gradient: the backward reduce-scatters
    the cotangent, so each rank's block gets the sum of every rank's
    gradient for it (already summed over the axis). An axis of size 1 is
    the identity."""
    group, n = _group(mesh, axis)
    return x if n == 1 else _AllGather.apply(x, group, n)


def reduce_scatter_grad(x: torch.Tensor, mesh,
                        axis: str = "dp") -> torch.Tensor:
    """:func:`reduce_scatter` with a gradient: the backward all-gathers
    the cotangent. An axis of size 1 is the identity."""
    group, n = _group(mesh, axis)
    return x if n == 1 else _ReduceScatter.apply(x, group, n)


# -- microbenchmark -----------------------------------------------------------


@dataclasses.dataclass
class CollectiveResult:
    op: str
    size_mb: float
    n_devices: int
    mean_s: float
    # bytes of the collective's size (NCCL-tests: the buffer each rank
    # reduces; all_gather's gathered output) over the mean time
    alg_gb_s: float
    # alg_gb_s times the bus factor; None at n = 1, where no byte moves
    bus_gb_s: Optional[float]


_BUS_FACTOR = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}

_OPS: Dict[str, Callable] = {
    "all_reduce": all_reduce,
    "all_gather": all_gather,
    "reduce_scatter": reduce_scatter,
    "all_to_all": all_to_all,
    "ppermute": ppermute_shift,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_collective(op: str, mesh, axis: str = "dp", *,
                     size_mb: float = 64.0, iters: int = 10,
                     warmup: int = 2, device=None) -> CollectiveResult:
    """Mean seconds of ``op`` over ``iters`` calls after ``warmup``, on
    f32 buffers of ``size_mb`` (decimal MB) on ``device`` (the mesh's
    device type by default), with a device sync at both ends."""
    n = axis_size(mesh, axis)
    device = torch.device(device or (
        f"cuda:{torch.cuda.current_device()}"
        if mesh.device_type == "cuda" else "cpu"))
    # (n*n, cols) with n | cols: every op's splits are whole
    cols = int(size_mb * 1e6 / 4) // (n ** 3) * n
    n_elem = n * n * cols
    x = torch.arange(n_elem, dtype=torch.float32, device=device).reshape(
        n * n, cols)
    if op == "all_gather":
        x = x[:n]
    fn = _OPS[op]
    for _ in range(warmup):
        fn(x, mesh, axis)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x, mesh, axis)
    _sync(device)
    mean_s = (time.perf_counter() - t0) / iters
    payload = n_elem * 4
    alg = payload / mean_s / 1e9
    bus = alg * _BUS_FACTOR[op](n) if n > 1 else None
    return CollectiveResult(op, payload / 1e6, n, mean_s, alg, bus)


def bench_all(mesh, axis: str = "dp", *, size_mb: float = 64.0,
              iters: int = 10, device=None) -> List[CollectiveResult]:
    return [bench_collective(op, mesh, axis, size_mb=size_mb, iters=iters,
                             device=device)
            for op in _OPS]
