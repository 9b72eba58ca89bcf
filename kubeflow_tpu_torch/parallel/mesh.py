"""Device mesh and logical-axis sharding rules.

PyTorch port of ``kubeflow_tpu/parallel/mesh.py``. The physical mesh
axes are the reference's ``("dcn", "dp", "pp", "tp")``: cross-slice
data, in-slice data, pipeline stage and tensor. Models name their
dimensions with logical axes (``"batch"``, ``"heads"``, ``"mlp"``,
``"vocab"``, ...) and :data:`DEFAULT_RULES` maps them onto mesh axes, as
in the reference, so one table decides what a rank holds.

Where the reference is one program over many devices, the port is one
process per device:

- :func:`create_mesh` returns a ``torch.distributed.device_mesh.
  DeviceMesh`` over the ranks of the default process group, laid out
  dcn-major (rank ``r`` sits at ``np.unravel_index(r, (dcn, dp, pp,
  tp))``), as the reference lays out devices off the TPU
  (``mesh.py:141-146``). Each mesh axis has its process group
  (:func:`axis_group`); the groups over ``("dcn", "dp")`` (the gradient
  average) and ``("dcn", "dp", "tp")`` (the same under context
  parallelism) are made with the mesh, because every rank must create a
  group in the same order.
- A :class:`PartitionSpec` says which dims of a full array a rank holds
  a block of; :func:`local_block` cuts that block out of the full array
  and :func:`gather_block` puts the full array back together (an
  all-gather over each sharded dim's group).
- The ``stage`` rule names ``pp`` on a layer stack's leading axis, as
  in the reference. The port keeps one tensor a layer, so a rank built
  over ``pp > 1`` holds its stage's layers whole, and their specs lead
  with ``"pp"`` for that stacked axis (:func:`is_stage_spec`): the spec
  of the layer stack the tensor is one layer of. :func:`tensor_spec`
  gives the tensor's own.
- :func:`parse_serving_mesh` reads ``KFTPU_SERVING_MESH`` (``"tp=4"``,
  ``"dp=2,tp=4"``) into a mesh over the process group, with the
  reference server's errors.
- ``shard_constraint`` and ``mesh_context`` are not ported: they feed
  GSPMD, which derives the collectives from the shardings. The port's
  model issues each collective itself
  (``models/transformer.py``, ``ops/collectives.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MESH_AXES = ("dcn", "dp", "pp", "tp")

AxisRules = Tuple[Tuple[str, Optional[Union[str, Tuple[str, ...]]]], ...]

DEFAULT_RULES: AxisRules = (
    ("batch", ("dcn", "dp")),  # per-example batch dim: outer-dp over DCN × dp
    ("stage", ("pp",)),        # stacked pipeline-stage dim
    ("embed", None),           # d_model dim of activations: replicated in tp
    ("seq", ("tp",)),          # sequence-parallel regions
    ("heads", ("tp",)),        # attention heads
    ("kv", None),              # per-head dim
    ("mlp", ("tp",)),          # ffn hidden
    ("vocab", ("tp",)),        # embedding/unembedding vocab dim
    ("expert", ("dp",)),       # MoE experts ride the dp axis (EP-on-DP)
    ("expert_mlp", ("tp",)),   # within-expert ffn hidden
)



class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec`` as the port needs it: entry ``i``
    is None (dim ``i`` whole on every rank), a mesh axis name, or a tuple
    of names (dim ``i`` split over their product, the first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Shape of the device mesh. Product must equal the rank count.

    ``dcn`` is the number of slices joined over the data-center network
    (outer data parallelism); ``dp``/``pp``/``tp`` describe the
    per-slice layout."""

    dp: int = 1
    pp: int = 1
    tp: int = 1
    dcn: int = 1

    @property
    def size(self) -> int:
        return self.dcn * self.dp * self.pp * self.tp

    @property
    def slice_size(self) -> int:
        """Ranks per slice."""
        return self.dp * self.pp * self.tp

    def axis_sizes(self) -> Tuple[int, int, int, int]:
        return (self.dcn, self.dp, self.pp, self.tp)


def auto_mesh_config(n_devices: int, *, pp: int = 1,
                     tp: Optional[int] = None) -> MeshConfig:
    """Pick a mesh shape for ``n_devices``: pure data parallelism with
    tp = 2 when the count allows (the reference's default), unless
    ``tp`` is given."""
    if n_devices % pp:
        raise ValueError(f"pp={pp} does not divide device count {n_devices}")
    rem = n_devices // pp
    if tp is None:
        tp = 2 if rem % 2 == 0 and rem > 1 else 1
    if rem % tp:
        raise ValueError(f"tp={tp} does not divide {rem}")
    return MeshConfig(dp=rem // tp, pp=pp, tp=tp)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def create_mesh(config: Optional[MeshConfig] = None, *,
                device_type: str = "cuda"):
    """A ``DeviceMesh`` with dims ``("dcn", "dp", "pp", "tp")`` over
    every rank of the default process group, dcn-major.

    A single-process job has no process group
    (``distributed.initialize`` leaves it alone); here it gets a
    one-rank group over an in-process store (NCCL on the card, gloo on
    the CPU), so the mesh path issues its collectives through the same
    backend at any world size."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh

    if not tdist.is_initialized():
        tdist.init_process_group(_backend(device_type),
                                 store=tdist.HashStore(), rank=0,
                                 world_size=1)
    world = tdist.get_world_size()
    if config is None:
        config = auto_mesh_config(world)
    if config.size != world:
        raise ValueError(
            f"mesh {config.axis_sizes()} needs {config.size} devices, "
            f"have {world}")
    ranks = torch.arange(world).reshape(config.axis_sizes())
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)
    me = tdist.get_rank()
    groups: Dict[Tuple[str, ...], object] = {}
    live = [a for a, n in zip(MESH_AXES, config.axis_sizes()) if n > 1]
    flat = [axes for r in range(2, len(live) + 1)
            for axes in itertools.combinations(live, r)]
    for axes in flat:
        keep = [MESH_AXES.index(a) for a in axes]
        rest = [i for i in range(4) if i not in keep]
        grid = ranks.permute(*rest, *keep).reshape(-1, int(
            np.prod([config.axis_sizes()[i] for i in keep])))
        for row in grid.tolist():       # every rank makes every group
            group = tdist.new_group(row)
            if me in row:
                groups[axes] = group
    mesh._kftpu_groups = groups
    return mesh


def parse_serving_mesh(raw: Optional[str], *, device_type: str = "cuda"):
    """``"tp=4"`` / ``"dp=2,tp=4"`` → a mesh over every rank of the
    process group (None when unset): the env-facing twin of
    :class:`MeshConfig` that ``KFTPU_SERVING_MESH`` names, with the
    reference's errors (``kubeflow_tpu/serving/server.py:376-399``)."""
    if not raw:
        return None
    kw: Dict[str, int] = {}
    for part in raw.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in MESH_AXES:
            raise ValueError(f"KFTPU_SERVING_MESH axis {k!r} (want "
                             "dcn/dp/pp/tp)")
        if k in kw:
            raise ValueError(f"KFTPU_SERVING_MESH repeats axis {k!r}")
        try:
            kw[k] = int(v)
        except ValueError:
            raise ValueError(
                f"KFTPU_SERVING_MESH axis {k!r} needs an integer size, "
                f"got {v.strip()!r} (format: 'tp=4' or 'dp=2,tp=4')"
            ) from None
    return create_mesh(MeshConfig(**kw), device_type=device_type)


def axis_size(mesh, axis: Union[str, Sequence[str]]) -> int:
    """Ranks along one mesh axis, or the product over several (an axis
    the mesh lacks has size 1)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    names = mesh.mesh_dim_names
    n = 1
    for a in axes:
        if a in names:
            n *= mesh.size(names.index(a))
    return n


def axis_index(mesh, axis: Union[str, Sequence[str]]) -> int:
    """This rank's index along one axis, or along several flattened
    (the first major)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        if a in names:
            i = names.index(a)
            idx = idx * mesh.size(i) + coord[i]
    return idx


def axis_group(mesh, axis: Union[str, Sequence[str]]):
    """The process group of the ranks that differ from this one only
    along ``axis`` (a name or a tuple of names, in the mesh's order).
    Axes of size 1 drop out."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    live = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if len(live) <= 1:
        return mesh.get_group(live[0] if live else axes[0])
    if live not in mesh._kftpu_groups:
        raise ValueError(f"no process group over mesh axes {axes}")
    return mesh._kftpu_groups[live]


def mesh_order(axes: Sequence[str]) -> Tuple[str, ...]:
    """``axes`` without repeats, in the mesh's order (``MESH_AXES``):
    the order of a group's ranks, so the first is the major one in
    :func:`axis_index` and in an all-gather over them."""
    return tuple(a for a in MESH_AXES if a in axes)


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]],
                         rules: AxisRules = DEFAULT_RULES
                         ) -> PartitionSpec:
    """Map a tuple of logical axis names (None = replicated) to a
    PartitionSpec."""
    table = dict(rules)
    out = []
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        if name not in table:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        mesh_axes = table[name]
        if mesh_axes is None:
            out.append(None)
        elif isinstance(mesh_axes, str):
            out.append(mesh_axes)
        elif len(mesh_axes) == 1:
            out.append(mesh_axes[0])
        else:
            out.append(tuple(mesh_axes))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def data_parallel_size(mesh) -> int:
    """Global batch-sharding width: product of the dcn and dp axis
    sizes."""
    return axis_size(mesh, ("dcn", "dp"))


def _filter_spec(spec: PartitionSpec, keep) -> PartitionSpec:
    """Rebuild ``spec`` keeping only axis names where ``keep(name)``,
    collapsing emptied entries to None and trimming trailing Nones."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(entry)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if keep(a))
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def batch_axes(rules: AxisRules = DEFAULT_RULES) -> Tuple[str, ...]:
    """The mesh axes the ``batch`` rule splits a global batch over."""
    spec = logical_to_mesh_axes(("batch",), rules)
    entry = spec[0] if spec else ()
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def spec_axes(spec: Optional[PartitionSpec]) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` names, in order."""
    out = []
    for entry in spec or ():
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def is_stage_spec(spec: Optional[PartitionSpec]) -> bool:
    """Whether ``spec`` is a pipeline stage leaf's: its leading entry is
    ``pp``, the stacked layer axis (the ``stage`` rule)."""
    return bool(spec) and spec[0] == "pp"


def tensor_spec(spec: Optional[PartitionSpec]) -> Optional[PartitionSpec]:
    """The spec of the tensor a rank holds: a stage leaf's without its
    leading ``pp`` (the layer axis the port's one-tensor-a-layer
    parameters do not have), any other unchanged."""
    return PartitionSpec(*spec[1:]) if is_stage_spec(spec) else spec


@dataclasses.dataclass(frozen=True)
class RankRows:
    """This rank's rows of a global batch, as
    ``data/loader.py:device_feed`` over a mesh yields each leaf: a train
    step over the mesh takes ``rows`` as they are instead of cutting its
    rows from a global batch. The wrapper is explicit so that the mark
    cannot be lost: a tensor made from ``rows`` is a global batch again
    to the step."""

    rows: torch.Tensor


def spec_for_mesh(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop axis names ``mesh`` does not have (exact: an absent axis has
    size 1, and sharding over it is replication)."""
    names = set(mesh.mesh_dim_names)
    return _filter_spec(spec, names.__contains__)


def shape_aware_spec(spec: PartitionSpec, shape: Tuple[int, ...],
                     mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh cannot divide evenly, so one rules
    table serves models whose small dims (GQA kv heads) do not divide a
    large tp axis: those dims replicate."""
    out = []
    padded = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, axis in zip(shape, padded):
        if axis is None:
            out.append(None)
            continue
        out.append(axis if dim % axis_size(mesh, axis) == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def validate_mesh_for_model(config: MeshConfig, *, n_heads: int, d_ff: int,
                            n_experts: int = 0) -> None:
    """Fail fast when a mesh shape cannot shard a model's dimensions."""
    if n_heads % config.tp:
        raise ValueError(f"tp={config.tp} must divide n_heads={n_heads}")
    if d_ff % config.tp:
        raise ValueError(f"tp={config.tp} must divide d_ff={d_ff}")
    if n_experts and n_experts % config.dp != 0:
        raise ValueError(
            f"dp={config.dp} must divide n_experts={n_experts} "
            f"(experts shard over the dp axis)")


def mesh_config(mesh) -> MeshConfig:
    """The :class:`MeshConfig` of a mesh :func:`create_mesh` made."""
    return MeshConfig(**{a: axis_size(mesh, a) for a in MESH_AXES})


def is_sharded(spec: Optional[PartitionSpec]) -> bool:
    return bool(spec) and any(e is not None for e in spec)


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a full array of ``shape``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= axis_size(mesh, entry)
    return tuple(out)


def local_block(full: torch.Tensor, spec: PartitionSpec,
                mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = axis_size(mesh, entry)
        size = full.shape[d] // n
        full = full.narrow(d, axis_index(mesh, entry) * size, size)
    return full


def gather_block(local: torch.Tensor, spec: Optional[PartitionSpec],
                 mesh) -> torch.Tensor:
    """The full array from every rank's block under ``spec``: one
    all-gather over each sharded dim's group (a collective: every rank
    of those groups calls it). Not differentiable."""
    import torch.distributed as tdist

    out = local.detach()
    for d, entry in enumerate(spec or ()):
        if entry is None or axis_size(mesh, entry) == 1:
            continue
        n = axis_size(mesh, entry)
        moved = out.movedim(d, 0).contiguous()
        buf = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        tdist.all_gather_into_tensor(buf, moved,
                                     group=axis_group(mesh, entry))
        out = buf.movedim(0, d)
    return out.contiguous()

