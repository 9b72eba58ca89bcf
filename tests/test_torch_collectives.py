"""The port's collectives (``kubeflow_tpu_torch/ops/collectives.py``)
against the JAX package's on its mesh.

A 4-rank gloo gang (``tests/torch_gang.py``, suite ``collectives``)
first runs the collective-check workload, then gives each collective
its rank's block of one full array, over ``dp`` of a ``dp=4`` mesh and
over ``tp`` and ``dp`` of a ``dp=2 × tp=2`` mesh. The blocks that come
back must be the blocks of what ``kubeflow_tpu.ops.collectives`` returns
for the full array on the same mesh over the 8 virtual CPU devices,
gradients included.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.ops import collectives as jcol
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu_torch.ops import collectives as col
from torch_gang import (
    COLLECTIVE_AXES,
    COLLECTIVE_MESHES,
    COLLECTIVE_OPS,
    COLLECTIVE_SPECS,
    Gang,
    block,
    collective_input,
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("collectives", 4, tmp_path_factory.mktemp("col-gang"))


def _jax_mesh(name):
    return create_mesh(MeshConfig(**COLLECTIVE_MESHES[name]),
                       devices=jax.devices()[:4])


def _rank_index(mesh, axis, rank):
    """The index along ``axis`` of rank ``rank`` (rank = device id in the
    first four devices, dcn-major)."""
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    where = np.argwhere(ids == rank)[0]
    return int(where[list(mesh.axis_names).index(axis)])


def test_collective_check_prints_ok_on_every_rank(gang):
    gang.results()
    for rank, out in enumerate(gang.stdout):
        line = json.loads(out.strip().splitlines()[-1])
        assert line["ok"] and line["processes"] == 4
        assert line["process_id"] == rank and line["backend"] == "gloo"
        assert all(line["collectives"].values())
    assert all(r["collective_check"] == 0 for r in gang.results())


@pytest.mark.parametrize("mesh_name,axis", COLLECTIVE_AXES,
                         ids=[f"{m}-{a}" for m, a in COLLECTIVE_AXES])
@pytest.mark.parametrize("op", COLLECTIVE_OPS)
def test_collective_matches_jax(gang, mesh_name, axis, op):
    mesh = _jax_mesh(mesh_name)
    n = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    full = jnp.asarray(collective_input())
    _, spec_out = COLLECTIVE_SPECS[op]
    shifts = {"ppermute1": 1, "ppermute3": 3} if op == "ppermute" else {
        op: None}
    for key, shift in shifts.items():
        want = np.asarray(
            jcol.ppermute_shift(full, mesh, axis, shift) if shift
            else getattr(jcol, op)(full, mesh, axis))
        # the moves are exact; a sum of n f32 terms may round in another
        # order than XLA's
        tol = 1e-6 if op in ("all_reduce", "reduce_scatter") else 0
        for rank, got in enumerate(gang.case(f"{mesh_name}/{axis}")):
            i = _rank_index(mesh, axis, rank)
            np.testing.assert_allclose(
                got[key].numpy(), block(want, spec_out, n, i), rtol=tol,
                atol=tol, err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("mesh_name,axis", COLLECTIVE_AXES,
                         ids=[f"{m}-{a}" for m, a in COLLECTIVE_AXES])
@pytest.mark.parametrize("op", ["ppermute", "all_to_all"])
def test_collective_gradient_matches_jax(gang, mesh_name, axis, op):
    """``ppermute``'s backward rotates the other way; ``all_to_all``'s is
    the inverse exchange: the gradients of ``sum(op(x) * ct)``."""
    mesh = _jax_mesh(mesh_name)
    n = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    ct = jnp.asarray(collective_input(1))
    fn = ((lambda x: jcol.ppermute_shift(x, mesh, axis, 1))
          if op == "ppermute" else (lambda x: jcol.all_to_all(x, mesh, axis)))
    want = np.asarray(jax.grad(lambda x: jnp.sum(fn(x) * ct))(
        jnp.asarray(collective_input())))
    for rank, got in enumerate(gang.case(f"{mesh_name}/{axis}")):
        i = _rank_index(mesh, axis, rank)
        np.testing.assert_allclose(got[f"{op}_grad"].numpy(),
                                   block(want, "rows", n, i), atol=0,
                                   rtol=0)


@pytest.mark.parametrize("mesh_name,axis", COLLECTIVE_AXES,
                         ids=[f"{m}-{a}" for m, a in COLLECTIVE_AXES])
def test_megatron_f_and_g(gang, mesh_name, axis):
    """``reduce_from`` sums over the axis forward and passes the
    cotangent back; ``copy_to`` passes forward and sums the cotangents
    back: row ``i`` of the inputs is the rank at index ``i``'s."""
    mesh = _jax_mesh(mesh_name)
    full, ct = collective_input(), collective_input(1)
    for rank, got in enumerate(gang.case(f"{mesh_name}/{axis}")):
        i = _rank_index(mesh, axis, rank)
        peers = [_rank_index(mesh, axis, r) for r in range(4)
                 if all(_rank_index(mesh, a, r) == _rank_index(mesh, a, rank)
                        for a in mesh.axis_names if a != axis)]
        np.testing.assert_allclose(got["reduce_from"].numpy(),
                                   full[peers].sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["reduce_from_grad"].numpy(), ct[i])
        np.testing.assert_array_equal(got["copy_to"].numpy(), full[i])
        np.testing.assert_allclose(got["copy_to_grad"].numpy(),
                                   ct[peers].sum(0), rtol=1e-6)


@pytest.mark.parametrize("mesh_name,axis", COLLECTIVE_AXES,
                         ids=[f"{m}-{a}" for m, a in COLLECTIVE_AXES])
@pytest.mark.parametrize("op", ["all_gather_grad", "reduce_scatter_grad",
                                "all_reduce_grad"])
def test_differentiable_gather_scatter_and_sum(gang, mesh_name, axis, op):
    """Rank ``i``'s input and cotangent are scaled by ``i + 1`` (``S`` the
    sum of the scales): ``all_gather_grad``'s backward reduce-scatters
    (row block ``i`` of ``S · ct``), ``reduce_scatter_grad``'s
    all-gathers (every rank's cotangent block, ``ct``), and
    ``all_reduce_grad``'s sums the cotangents (``S · ct``)."""
    mesh = _jax_mesh(mesh_name)
    n = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    full, ct = collective_input(), collective_input(1)
    S = n * (n + 1) / 2
    for rank, got in enumerate(gang.case(f"{mesh_name}/{axis}")):
        i = _rank_index(mesh, axis, rank)
        want = {"all_gather_grad": (full, S * block(ct, "rows", n, i)),
                "reduce_scatter_grad": (S * block(full, "rows", n, i), ct),
                "all_reduce_grad": (S * full, S * ct)}[op]
        for have, w in zip(got[op], want):
            np.testing.assert_allclose(have.numpy(), w, rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {rank}")


def test_bench_collective_uses_the_reference_bus_factors(gang):
    """Positive bandwidth for every op at n = 4, the bus bandwidth the
    algorithmic one times the reference's NCCL-tests factor."""
    rows = gang.case("bench")
    for got in rows:
        assert [r["op"] for r in got] == list(COLLECTIVE_OPS)
        for r in got:
            assert r["n"] == 4 and r["alg"] > 0 and r["mean_s"] > 0
            assert r["bus"] == pytest.approx(
                r["alg"] * jcol._BUS_FACTOR[r["op"]](4), rel=1e-12)
    assert col._BUS_FACTOR.keys() == jcol._BUS_FACTOR.keys()
    for op in col._BUS_FACTOR:
        for n in (2, 4, 8):
            assert col._BUS_FACTOR[op](n) == jcol._BUS_FACTOR[op](n)
