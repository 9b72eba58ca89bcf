"""The port's mesh and process-group start-up against the JAX package.

The pure functions of ``kubeflow_tpu_torch/parallel/mesh.py`` take the
same inputs as ``kubeflow_tpu.parallel.mesh``'s and must give the same
answers and errors. ``create_mesh`` and ``multislice_mesh`` run in a
4-rank gloo gang (``tests/torch_gang.py``, suite ``mesh``): each rank's
place in the mesh must be the device's place in the JAX package's mesh
over the 8 virtual CPU devices, and each axis's process group the ranks
along that axis.
"""

import jax
import numpy as np
import pytest

from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel.distributed import multislice_mesh as jax_multislice
from kubeflow_tpu.parallel.distributed import from_env as jax_from_env
from kubeflow_tpu_torch.parallel import distributed as dist
from kubeflow_tpu_torch.parallel import mesh as pmesh
from torch_gang import Gang


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("mesh", 4, tmp_path_factory.mktemp("mesh-gang"))


class _Mesh:
    """Axis names and sizes: all the pure functions read of a mesh."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = tuple(names)
        self._sizes = tuple(sizes)

    def size(self, i):
        return self._sizes[i]


def _jax_mesh(names, sizes):
    n = int(np.prod(sizes))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(sizes),
                             tuple(names))


@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(pp=2, tp=2)), (8, dict(pp=3)), (1, {}), (2, {}),
    (4, dict(tp=1)), (6, dict(tp=4)), (1, dict(tp=2)), (12, dict(pp=2)),
])
def test_auto_mesh_config_matches_jax(n, kw):
    """Every case of ``tests/test_mesh.py:20`` and the launcher's: the
    same shape, or the same error."""
    try:
        want = jmesh.auto_mesh_config(n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pmesh.auto_mesh_config(n, **kw)
        assert str(err.value) == str(e)
        return
    got = pmesh.auto_mesh_config(n, **kw)
    assert got.axis_sizes() == want.axis_sizes() and got.size == want.size
    assert got.slice_size == want.slice_size


@pytest.mark.parametrize("axes", [
    *[(name,) for name, _ in jmesh.DEFAULT_RULES],
    ("batch", None, "mlp"), ("expert", "embed", "expert_mlp"),
    ("embed", "heads", "kv"), ("batch", "seq"), (None, None),
])
def test_logical_to_mesh_axes_matches_jax(axes):
    assert pmesh.DEFAULT_RULES == jmesh.DEFAULT_RULES
    assert tuple(pmesh.logical_to_mesh_axes(axes)) == tuple(
        jmesh.logical_to_mesh_axes(axes))


def test_logical_to_mesh_axes_unknown_name():
    with pytest.raises(KeyError) as want:
        jmesh.logical_to_mesh_axes(("nonsense",))
    with pytest.raises(KeyError) as got:
        pmesh.logical_to_mesh_axes(("nonsense",))
    assert str(got.value) == str(want.value)


SPECS = [(("dcn", "dp"), "tp"), ("dp", None, "tp"), (None, ("dp", "tp")),
         ("pp",), (("dcn", "dp"),), ()]
MESHES = [(("dcn", "dp", "pp", "tp"), (1, 2, 1, 4)), (("dp", "tp"), (2, 4)),
          (("dp",), (8,)), (("dcn", "dp", "pp", "tp"), (2, 2, 1, 2))]


@pytest.mark.parametrize("names,sizes", MESHES)
def test_spec_for_mesh_matches_jax(names, sizes):
    jm, pm = _jax_mesh(names, sizes), _Mesh(names, sizes)
    for spec in SPECS:
        want = jmesh.spec_for_mesh(jax.sharding.PartitionSpec(*spec), jm)
        got = pmesh.spec_for_mesh(pmesh.PartitionSpec(*spec), pm)
        assert tuple(got) == tuple(want), spec


@pytest.mark.parametrize("names,sizes", MESHES)
def test_shape_aware_spec_matches_jax(names, sizes):
    jm, pm = _jax_mesh(names, sizes), _Mesh(names, sizes)
    shapes = [(64, 2, 16), (64, 8, 16), (6, 12), (3,), (8, 4, 2)]
    for spec in SPECS:
        for shape in shapes:
            if len(spec) > len(shape):
                continue
            js = jmesh.spec_for_mesh(jax.sharding.PartitionSpec(*spec), jm)
            want = jmesh.shape_aware_spec(js, shape, jm)
            got = pmesh.shape_aware_spec(pmesh.spec_for_mesh(
                pmesh.PartitionSpec(*spec), pm), shape, pm)
            assert tuple(got) == tuple(want), (spec, shape)


@pytest.mark.parametrize("cfg,kw", [
    (dict(tp=3), dict(n_heads=4, d_ff=12)),
    (dict(tp=2), dict(n_heads=4, d_ff=7)),
    (dict(dp=3), dict(n_heads=4, d_ff=8, n_experts=4)),
    (dict(dp=2, tp=2), dict(n_heads=4, d_ff=8, n_experts=4)),
])
def test_validate_mesh_for_model_matches_jax(cfg, kw):
    try:
        jmesh.validate_mesh_for_model(jmesh.MeshConfig(**cfg), **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pmesh.validate_mesh_for_model(pmesh.MeshConfig(**cfg), **kw)
        assert str(err.value) == str(e)
        return
    pmesh.validate_mesh_for_model(pmesh.MeshConfig(**cfg), **kw)


def _device_ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()


def _groups(ranks, axes):
    """The ranks along ``axes`` (mesh dims) from each rank: the process
    group the rank must be in."""
    arr = np.asarray(ranks)
    keep = [("dcn", "dp", "pp", "tp").index(a) for a in axes]
    rest = [i for i in range(4) if i not in keep]
    rows = arr.transpose(rest + keep).reshape(-1, int(
        np.prod([arr.shape[i] for i in keep])))
    return {int(r): row.tolist() for row in rows for r in row}


@pytest.mark.parametrize("case,cfg", [
    ("dp2_tp2", dict(dp=2, tp=2)), ("dcn2_tp2", dict(dcn=2, tp=2))])
def test_create_mesh_over_four_ranks(gang, case, cfg):
    """Each rank's mesh: the ranks laid out as the JAX package lays out
    the first four devices (dcn-major), the axis sizes, and each axis's
    (and the dp average's) process group."""
    want = jmesh.create_mesh(jmesh.MeshConfig(**cfg),
                             devices=jax.devices()[:4])
    for rank, got in enumerate(gang.case(case)):
        assert got["ranks"] == _device_ids(want)
        assert got["sizes"] == list(want.devices.shape)
        assert got["dp_size"] == jmesh.data_parallel_size(want)
        assert np.asarray(got["ranks"])[tuple(got["coord"])] == rank
        for key, members in got["groups"].items():
            assert members == _groups(got["ranks"], key.split("/"))[rank], key


def test_multislice_mesh_from_env(gang):
    """``MEGASCALE_NUM_SLICES=2`` maps onto ``dcn``, as
    ``tests/test_distributed.py:101`` holds the reference's."""
    want = jax_multislice(jax_from_env({"MEGASCALE_NUM_SLICES": "2"}), tp=2,
                          devices=jax.devices()[:4])
    for got in gang.case("multislice"):
        assert got["sizes"] == list(want.devices.shape) == [2, 1, 1, 2]
        assert got["ranks"] == _device_ids(want)


def test_create_mesh_refuses_a_wrong_size(gang):
    with pytest.raises(ValueError) as want:
        jmesh.create_mesh(jmesh.MeshConfig(dp=8), devices=jax.devices()[:4])
    assert gang.case("wrong_size") == [str(want.value)] * 4


def test_gather_block_inverts_local_block(gang):
    for got in gang.case("gather"):
        assert got == {"tp": True, "dp_tp": True, "batch": True}


def test_initialize_single_process_noop():
    penv = dist.initialize(dist.ProcessEnv(None, 1, 0))
    assert penv.num_processes == 1


def test_initialize_distributed_requires_coordinator():
    from kubeflow_tpu.parallel.distributed import ProcessEnv as JaxEnv
    from kubeflow_tpu.parallel.distributed import initialize as jax_init

    with pytest.raises(RuntimeError) as want:
        jax_init(JaxEnv(None, 2, 1), timeout_s=1)
    with pytest.raises(RuntimeError, match="KFTPU_COORDINATOR_ADDRESS") as got:
        dist.initialize(dist.ProcessEnv(None, 2, 1), timeout_s=1)
    assert str(got.value) == str(want.value)


def test_every_rank_leaves_its_process_group(gang):
    """Each rank ends the suite at a barrier and tears its gloo group
    down itself (``torch_gang.leave_group``). Left to the interpreter's
    teardown, the group aborted a rank whose peers were still leaving
    (rc -6, "terminate called without an active exception"), which
    failed every test of the gang under ``-n 6``."""
    assert gang.left() == [True] * 4
