"""MoE over a mesh (expert parallelism) against the JAX package.

A 4-rank gloo gang (``tests/torch_gang.py``, suite ``moe_mesh``) builds
``tiny_config(n_experts=4)`` models over ``dp = 2 × tp = 2``: the
experts split over ``dp`` by their ``expert`` axis and over ``tp`` by
their ``expert_mlp`` axis. Three steps of ``make_lm_train_step(mesh)``
on the global batch hold the loss, ``grad_norm`` and the gathered
parameters to the JAX package's ``make_lm_train_step`` on its CPU mesh of
the same shape within 1e-5 (and each parameter's movement within
``MOVED_LIMIT``), from the same numpy-seeded weights, for the dense
dispatch, the capacity dispatch (factor 1.25), and a factor so low that
tokens drop (capacity 16 of each of 4 experts for 128 choices) with a
binding ``grad_clip``: there the global slot order shows, and a
per-rank dispatch (its own capacity, its own order) would fail. The
load-balance loss, global over the batch, is the JAX model's sown sum,
and each rank's logits the JAX model's rows and vocabulary block. The
dense and capacity steps run across two slices too (dcn = 2 × dp = 2:
the experts replicated over dcn, so their gradients sum over it), and
the dp = 2 × tp = 2 checkpoint restores bit for bit at one rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import tiny_config as jax_tiny
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.parallel.mesh import mesh_context
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import Transformer, tiny_config
from kubeflow_tpu_torch.ops.moe import expert_capacity
from test_torch_mesh_train import _check, _jax_run
from torch_gang import (
    LR,
    MOE_CASES,
    MOE_EXPERTS,
    MOE_MESH,
    OPT,
    Gang,
    block,
    logit_tokens,
    train_tokens,
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("moe_mesh", 4, tmp_path_factory.mktemp("moe-gang"))


def _mesh(case="dense"):
    cfg = MOE_CASES[case].get("mesh", MOE_MESH)
    return create_mesh(MeshConfig(**cfg), devices=jax.devices()[:4])


def _cfg_kw(case):
    return dict(n_experts=MOE_EXPERTS, **MOE_CASES[case].get("cfg", {}))


def _jax_params(pc):
    return jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))


def test_drops_case_drops_tokens():
    """The ``drops`` case's capacity, from the global token count, holds
    fewer slots than the choices; a per-rank dispatch would size it from
    half the tokens."""
    G = 4 * 16
    cf = MOE_CASES["drops"]["cfg"]["moe_capacity_factor"]
    C = expert_capacity(G, MOE_EXPERTS, 2, cf)
    assert C * MOE_EXPERTS < G * 2
    assert expert_capacity(G // 2, MOE_EXPERTS, 2, cf) != C


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_train_step_matches_jax(gang, case):
    from kubeflow_tpu.train import make_lm_train_step as jax_step
    from kubeflow_tpu.train import make_optimizer as jax_optimizer

    pc = tiny_config(**_cfg_kw(case))
    mesh = _mesh(case)
    want, want_params = _jax_run(
        JaxTransformer(jax_tiny(**_cfg_kw(case))), _jax_params(pc),
        jax_optimizer(LR, **OPT, **MOE_CASES[case].get("opt", {})), mesh,
        jax_step(mesh), (jnp.asarray(train_tokens("default",
                                                  pc.vocab_size)),))
    assert all(np.isfinite(w[0]) for w in want)
    if case == "drops":      # the clip binds on every update
        assert all(w[1] > 0.05 for w in want)
    _check(gang.case(f"train/{case}"), want, want_params, Transformer(pc),
           convert.unflatten(convert.random_params(pc, 0)))


@pytest.mark.parametrize("case", ["dense", "capacity"])
def test_aux_loss_and_logits_match_jax(gang, case):
    """The summed load-balance loss of the global batch on every rank,
    and each rank's block of the logits (its rows over dp, its
    vocabulary block over tp), against the JAX model's on its mesh."""
    pc = tiny_config(**_cfg_kw(case))
    model = JaxTransformer(jax_tiny(**_cfg_kw(case)))
    mesh = _mesh()
    toks = jnp.asarray(logit_tokens(pc.vocab_size))
    with mesh_context(mesh):
        logits, mut = jax.jit(lambda p, t: model.apply(
            {"params": p}, t, mutable=["losses"]))(_jax_params(pc), toks)
    aux = float(sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(mut)))
    logits = np.asarray(logits)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for rank, got in enumerate(gang.case(f"aux/{case}")):
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        _, dp, _, tp = np.argwhere(ids == rank)[0]
        rows = block(logits, "rows", 2, dp)
        np.testing.assert_allclose(
            got["logits"].numpy(), np.split(rows, 2, axis=-1)[tp],
            atol=1e-5, rtol=0, err_msg=f"rank {rank}")


def test_moe_checkpoint_restores_at_one_rank(gang):
    """The dp = 2 × tp = 2 MoE checkpoint, written gathered (experts over
    dp, their columns over tp), restores bit for bit at the same layout
    on every rank and into a whole model with no mesh."""
    from kubeflow_tpu_torch.train import create_train_state, make_optimizer
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    got = gang.case("train/dense")
    assert all(g["restored"] for g in got)
    pc = tiny_config(**_cfg_kw("dense"))
    state = create_train_state(pc, convert.random_params(pc, 1),
                               make_optimizer(LR, **OPT), device="cpu")
    CheckpointManager(f"{gang.out}/ckpt-moe").restore(state)
    for name, p in state.module.named_parameters():
        assert torch.equal(p.detach(), got[0]["params"][name]), name
