"""Topology remap: rebuild the mesh, re-derive the specs, restore into them.

PyTorch port of ``kubeflow_tpu/elastic/reshard.py``. The sharding rules
are *logical*: ``train/trainer.py:state_partition_specs`` maps every
leaf of a train state to a :class:`PartitionSpec` by its logical axes
(``parallel/mesh.py:DEFAULT_RULES``), a function of the leaf's role and
never of the rank count. Going from topology A to topology B:

1. rebuild the mesh for the new slice count (:func:`mesh_for_slices`:
   the ``MeshConfig(dcn=slices, ...)`` factoring of
   ``parallel/distributed.py:multislice_mesh``) over the process group
   that stands after the re-init;
2. re-apply the same specs on the new mesh (:func:`shardings_for`: an
   axis the mesh lacks drops out, a dim it cannot divide replicates);
3. restore the checkpoint into a state built over the new mesh
   (:func:`restore_resharded`): the port's checkpoint holds the whole
   state (``train/checkpoint.py``), and each rank copies in its block of
   every split tensor, bit for bit.

The port's mesh is one process per device, so where the reference
passes ``jax.eval_shape(init_fn, rng)`` as the abstract state, the port
builds the state on the meta device: its global shapes are the oracle
:func:`validate_global_shapes` holds the checkpoint to, before any
tensor is copied. The ``init_fn`` contract becomes::

    init_fn(mesh, device) -> TrainState

a fresh state over ``mesh`` (None: the whole model) on ``device``; on
``torch.device("meta")`` it builds the module and the optimizer state
without weights. :func:`lm_init_fn` makes one for an LM from a
JAX-layout param tree.

A workload whose slices all live in one process (the Podracer example's
actors and learner) names a slice by its devices:
``mesh_for_slices(n, devices=...)`` returns a :class:`DeviceSlice`, and
:func:`shard_put` places a live tree on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Optional, Sequence, Tuple

import torch

from kubeflow_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    MESH_AXES,
    AxisRules,
    MeshConfig,
    PartitionSpec,
    axis_size,
    create_mesh,
    local_block,
    logical_to_mesh_axes,
    shape_aware_spec,
    spec_axes,
    spec_for_mesh,
)


class ReshardMismatchError(ValueError):
    """Global shapes/dtypes disagree across the topology remap."""


@dataclasses.dataclass(frozen=True)
class DeviceSlice:
    """A mesh over devices of this one process: ``config``'s ranks are
    ``devices``, not processes, so it carries no process group and a
    leaf is placed whole (a split over an axis of size > 1 refuses in
    :func:`shard_put`). It answers :func:`~kubeflow_tpu_torch.parallel.
    mesh.axis_size` as a ``DeviceMesh`` does."""

    devices: Tuple[torch.device, ...]
    config: MeshConfig
    mesh_dim_names: ClassVar[Tuple[str, ...]] = MESH_AXES

    def size(self, dim: int) -> int:
        return self.config.axis_sizes()[dim]


def mesh_for_slices(n_slices: int, *,
                    devices: Optional[Sequence[Any]] = None, pp: int = 1,
                    tp: int = 1, device_type: str = "cuda"):
    """The training mesh for ``n_slices`` slices over the ranks of the
    process group that stands (``dcn = n_slices``, each slice's ranks
    into ``dp × pp × tp``), with the reference's checks: ranks that do
    not divide into the slices, and ``pp*tp`` that does not divide a
    slice, raise ``ValueError``. This is the reshard path: the slice
    count comes from the spec edit, not from the env this process booted
    with. With ``devices``, the same factoring over those devices of
    this process, as a :class:`DeviceSlice`."""
    import torch.distributed as tdist

    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if devices is not None:
        world = len(devices)
    else:
        world = tdist.get_world_size() if tdist.is_initialized() else 1
    if world % n_slices:
        raise ValueError(
            f"{world} devices do not divide into {n_slices} slices")
    per_slice = world // n_slices
    if per_slice % (pp * tp):
        raise ValueError(
            f"pp*tp={pp * tp} does not divide slice size {per_slice}")
    config = MeshConfig(dcn=n_slices, dp=per_slice // (pp * tp), pp=pp,
                        tp=tp)
    if devices is not None:
        return DeviceSlice(tuple(torch.device(d) for d in devices), config)
    return create_mesh(config, device_type=device_type)


# -- trees --------------------------------------------------------------------


def _map(fn: Callable[[Tuple[Any, ...], Any], Any], tree: Any,
         path: Tuple[Any, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaves(tree: Any, path: Tuple[Any, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _keystr(path: Tuple[Any, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def shardings_for(abstract_state: Any, mesh, rules: AxisRules = DEFAULT_RULES,
                  *, axes_fn: Any = None) -> Any:
    """A :class:`PartitionSpec` for every leaf of ``abstract_state``,
    fitted to ``mesh``: the topology-independent half of the remap.

    A train state without ``axes_fn`` takes the trainer's specs
    (``train/trainer.py:state_shardings``: each parameter's from the
    rules table, its optimizer moments the same, the rest replicated),
    in the tree its checkpoint saves. Otherwise the logical axes come
    from ``axes_fn(path, leaf)`` (default: the transformer's
    ``leaf_logical_axes`` of the dotted path), so a workload with its own
    parameter naming (the Podracer policy) rides the same path."""
    from kubeflow_tpu_torch.train.trainer import (
        TrainState,
        _state_tree,
        state_shardings,
    )

    def fit(logical, shape):
        spec = spec_for_mesh(logical_to_mesh_axes(logical, rules), mesh)
        return shape_aware_spec(spec, tuple(shape), mesh)

    if isinstance(abstract_state, TrainState):
        if axes_fn is None:
            return state_shardings(abstract_state, mesh, rules)
        return _state_tree(abstract_state, lambda name, t: fit(
            axes_fn((name,), t), t.shape))
    if axes_fn is None:
        from kubeflow_tpu_torch.models.transformer import leaf_logical_axes

        def axes_fn(path, leaf):  # noqa: ANN001
            return leaf_logical_axes(".".join(map(str, path)), leaf.dim())

    def shard(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return PartitionSpec()
        return fit(axes_fn(path, leaf), leaf.shape)

    return _map(shard, abstract_state)


def _leaf_sig(leaf: Any) -> tuple:
    """``(global shape, dtype name)``: the remap-invariant view."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return (tuple(getattr(leaf, "shape", ())),
            str(getattr(leaf, "dtype", type(leaf).__name__)))


def validate_global_shapes(expected: Any, actual: Any) -> None:
    """Raise :class:`ReshardMismatchError` unless every leaf's global
    shape and dtype agree across the remap: ``expected`` from the model
    being resumed (a state on the meta device), ``actual`` the
    checkpoint's whole tree (or any tree; train states compare as the
    trees their checkpoints save)."""
    from kubeflow_tpu_torch.train.checkpoint import _tree

    want, got = _tree(expected), _tree(actual)
    if _structure(want) != _structure(got):
        paths_w = {_keystr(p) for p, _ in _leaves(want)}
        paths_g = {_keystr(p) for p, _ in _leaves(got)}
        raise ReshardMismatchError(
            f"state structure changed across reshard: "
            f"{sorted(paths_w - paths_g)[:4]} only expected, "
            f"{sorted(paths_g - paths_w)[:4]} only restored")
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        if _leaf_sig(w) != _leaf_sig(g):
            raise ReshardMismatchError(
                f"global shape changed across reshard at {_keystr(path)}: "
                f"expected {_leaf_sig(w)}, got {_leaf_sig(g)}")


def _empty_on(tree: Any, device: torch.device) -> Any:
    return _map(lambda _, t: torch.empty_like(t, device=device)
                if isinstance(t, torch.Tensor) else t, tree)


def abstract_target(init_fn: Callable[..., Any], mesh,
                    device) -> Any:
    """The restore target: the state ``init_fn`` builds over ``mesh`` on
    the meta device, given uninitialised memory on ``device`` (the
    restore then writes every tensor of it). A module with a buffer its
    state dict does not hold refuses, as no checkpoint could fill it."""
    state = init_fn(mesh, torch.device("meta"))
    saved = set(state.module.state_dict())
    unsaved = [n for n, _ in state.module.named_buffers() if n not in saved]
    if unsaved:
        raise ValueError(f"buffers no checkpoint holds: {unsaved[:4]}")
    state.module.to_empty(device=device)
    state.opt_state = _empty_on(state.opt_state, device)
    return state


def restore_resharded(manager: Any, init_fn: Callable[..., Any], mesh, *,
                      step: Optional[int] = None, device=None) -> Any:
    """Restore a checkpoint into a state built over the new ``mesh``.

    ``manager`` is a :class:`~kubeflow_tpu_torch.train.checkpoint.
    CheckpointManager`; ``init_fn`` the module docstring's contract. The
    checkpoint's global shapes are held to ``init_fn(None, meta)``'s
    before a tensor is copied (:class:`ReshardMismatchError` on a wrong
    model); then each rank copies its block of every leaf, cut by the
    specs the model built over ``mesh`` holds (the rules table's, as
    :func:`shardings_for` derives them). Returns the restored state."""
    from kubeflow_tpu_torch.utils.device import resolve_device

    abstract = init_fn(None, torch.device("meta"))
    step, saved = manager.read(step)
    validate_global_shapes(abstract, saved)
    target = abstract_target(init_fn, mesh, resolve_device(device))
    return manager.restore(target, step, saved=saved)


def lm_init_fn(config, params: Any, tx) -> Callable[..., Any]:
    """The ``init_fn`` of an LM train state (the module docstring's
    contract) from a JAX-layout param tree: a ``Transformer`` built over
    ``mesh`` holding this rank's blocks of ``params``
    (``train/trainer.py:create_sharded_state``), or on the meta device
    its shapes alone."""
    def init_fn(mesh, device):
        from kubeflow_tpu_torch.models import convert
        from kubeflow_tpu_torch.models.transformer import Transformer
        from kubeflow_tpu_torch.train.trainer import TrainState

        if torch.device(device).type == "meta":
            with torch.device("meta"):
                model = Transformer(config, mesh=mesh)
            return TrainState.create(model.train(), tx)
        return TrainState.create(convert.to_trainable(
            config, params, device=device, mesh=mesh), tx)

    return init_fn


def _mesh_device(mesh) -> torch.device:
    if isinstance(mesh, DeviceSlice):
        return mesh.devices[0]
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_put(tree: Any, mesh, rules: AxisRules = DEFAULT_RULES, *,
              axes_fn: Any = None) -> Any:
    """A copy of the live ``tree`` placed on ``mesh`` through the same
    spec derivation the restore uses: the no-checkpoint reshard (the
    Podracer actors re-place the learner's current parameters this way
    when the actor slice count changes). Over a ``DeviceMesh`` each rank
    keeps its block of every leaf on its device; over a
    :class:`DeviceSlice` each leaf lands whole on the slice's device, a
    copy (the learner updates its own in place)."""
    specs = shardings_for(tree, mesh, rules, axes_fn=axes_fn)
    device = _mesh_device(mesh)
    local = isinstance(mesh, DeviceSlice)

    def put(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if local:
            split = [a for a in spec_axes(spec) if axis_size(mesh, a) > 1]
            if split:
                raise ValueError(
                    f"a slice of one process's devices cannot split a leaf "
                    f"of shape {tuple(leaf.shape)} over {split}")
        else:
            leaf = local_block(leaf, spec, mesh)
        return leaf.detach().to(device=device, copy=True,
                                memory_format=torch.contiguous_format)

    def zip_map(t, s):
        if isinstance(t, dict):
            return {k: zip_map(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(zip_map(v, w) for v, w in zip(t, s))
        return put(t, s)

    return zip_map(tree, specs)
