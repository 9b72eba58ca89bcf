"""The port's pipeline (``kubeflow_tpu_torch.parallel.pipeline``) and the
pipelined LM train step against the JAX package's.

The port's counterpart of every case of ``tests/test_pipeline.py``. A
4-rank gloo gang (``tests/torch_gang.py``, suite ``pipeline``) runs the
rank side while the JAX package computes its answers here on its CPU
mesh, from the same numpy-seeded weights (carried across by the
converter) and inputs:

- ``split_stages``/``merge_stages`` round-trip and refuse a ragged split;
- ``pipeline_apply`` at pp = 4 against the sequential stack, outputs
  (1e-6) and gradients (1e-5), with more microbatches than stages too;
- the pipelined transformer's logits at pp = 4 against the unpipelined
  JAX model's (1e-5 at f32), and its refusal of a ragged batch;
- three steps of ``make_pipelined_lm_train_step`` at dp = 2 × pp = 2 and
  at pp = 2 × tp = 2 against the JAX package's, loss, ``grad_norm`` and
  the gathered parameters within 1e-5 and each parameter's movement
  within ``MOVED_LIMIT`` (``tests/test_torch_mesh_train.py``); the stage
  leaves' specs name ``pp`` as the reference's do;
- the dp = 2 × pp = 2 checkpoint restores bit for bit at the same layout
  and at pp = 1;
- an 8-rank gang (suite ``full_mesh``) trains the reference's
  ``test_train_step_full_mesh`` (dp 2 × pp 2 × tp 2, MoE with capacity
  dispatch): its first loss is the JAX package's within 1e-5, the
  losses fall, and every rank reports the same ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import tiny_config as jax_tiny
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from kubeflow_tpu.parallel.pipeline import split_stages as jax_split
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu.train import make_pipelined_lm_train_step as jax_pipe_step
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import Transformer, tiny_config
from kubeflow_tpu_torch.parallel.pipeline import merge_stages, split_stages
from test_torch_mesh_train import _check
from torch_gang import (
    FULL_CFG,
    FULL_OPT,
    FULL_STEPS,
    LR,
    OPT,
    PIPE_APPLY,
    PIPE_L,
    PIPE_LAYERS,
    PIPE_LOGIT_M,
    PIPE_M,
    PIPE_MESHES,
    STEPS,
    Gang,
    full_mesh_tokens,
    pipe_microbatches,
    pipe_stack,
    pipe_tokens,
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("pipeline", 4, tmp_path_factory.mktemp("pipeline-gang"))


@pytest.fixture(scope="module")
def full_gang(tmp_path_factory):
    return Gang("full_mesh", 8, tmp_path_factory.mktemp("full-mesh-gang"))


def _mesh(**cfg):
    n = int(np.prod(list(cfg.values())))
    return create_mesh(MeshConfig(**cfg), devices=jax.devices()[:n])


def _sequential(ws, x_mb):
    def seq(x):
        for i in range(PIPE_L):
            x = jnp.tanh(x @ ws[i])
        return x

    return jax.vmap(seq)(x_mb)


def _jax_stage(stage_params, x):
    def layer(x, w):
        return jnp.tanh(x @ w), None

    x, _ = jax.lax.scan(layer, x, stage_params)
    return x


class TestSplitStages:
    def test_roundtrip(self):
        ws = torch.from_numpy(pipe_stack())
        staged = split_stages(ws, 4)
        assert staged.shape == (4, 2, 16, 16)
        np.testing.assert_array_equal(
            staged.numpy(), np.asarray(jax_split(jnp.asarray(pipe_stack()),
                                                 4)))
        assert torch.equal(merge_stages(staged), ws)
        tree = {"a": ws, "b": [ws[:, :1]]}
        back = merge_stages(split_stages(tree, 2))
        assert torch.equal(back["a"], ws) and torch.equal(back["b"][0],
                                                          ws[:, :1])

    def test_rejects_ragged(self):
        with pytest.raises(ValueError, match="not divisible"):
            split_stages(torch.from_numpy(pipe_stack()), 3)


class TestPipelineApply:
    @pytest.mark.parametrize("shape", list(PIPE_APPLY),
                             ids=["matches_sequential",
                                  "more_microbatches_than_stages"])
    def test_matches_sequential(self, gang, shape):
        """Every rank returns the stack's output, the JAX package's
        sequential one and its own pipeline's within 1e-6."""
        ws = jnp.asarray(pipe_stack())
        x = jnp.asarray(pipe_microbatches(*PIPE_APPLY[shape]))
        want = np.asarray(_sequential(ws, x))
        ref = np.asarray(jax_pipeline(_jax_stage, jax_split(ws, 4), x,
                                      mesh=_mesh(pp=4)))
        np.testing.assert_allclose(ref, want, atol=1e-6)
        for rank, got in enumerate(gang.case(f"apply/{shape}")):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                       err_msg=f"rank {rank}")

    def test_gradients_match_sequential(self, gang):
        """Rank r's stage gradient is block r of the sequential stack's."""
        ws = jnp.asarray(pipe_stack())
        x = jnp.asarray(pipe_microbatches(*PIPE_APPLY["4x6"]))
        want = np.asarray(jax.grad(
            lambda w: jnp.sum(_sequential(w, x) ** 2))(ws)).reshape(
                4, PIPE_L // 4, 16, 16)
        for rank, got in enumerate(gang.case("apply/grad")):
            np.testing.assert_allclose(got.numpy(), want[rank], atol=1e-5,
                                       err_msg=f"rank {rank}")


def _jax_params(pc):
    return jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))


class TestPipelinedTransformer:
    def test_forward_matches_unpipelined(self, gang):
        pc = tiny_config(n_layers=PIPE_LAYERS)
        toks = jnp.asarray(pipe_tokens(pc.vocab_size))
        jmodel = JaxTransformer(jax_tiny(n_layers=PIPE_LAYERS))
        want = np.asarray(jmodel.apply({"params": _jax_params(pc)}, toks))
        for rank, got in enumerate(gang.case("logits")):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0,
                                       err_msg=f"rank {rank}")
        assert PIPE_LOGIT_M == 4

    def test_rejects_ragged_batch(self, gang):
        for got in gang.case("ragged"):
            assert "not divisible" in got and "microbatches 4" in got

    @pytest.mark.parametrize("layout", list(PIPE_MESHES))
    def test_train_step_matches_jax(self, gang, layout):
        pc = tiny_config(n_layers=PIPE_LAYERS)
        params = _jax_params(pc)
        mesh = _mesh(**PIPE_MESHES[layout])
        model = JaxTransformer(jax_tiny(n_layers=PIPE_LAYERS))
        tx = jax_optimizer(LR, **OPT)

        def init_fn(rng):
            return JaxState.create(apply_fn=model.apply, params=params,
                                   tx=tx)

        state, _ = create_sharded_state(init_fn, jax.random.key(0), mesh,
                                        pipelined=True)
        step = jax_pipe_step(model, mesh, n_microbatches=PIPE_M)
        toks = jnp.asarray(pipe_tokens(pc.vocab_size))
        want = []
        for _ in range(STEPS):
            state, m = step(state, toks)
            want.append((float(m["loss"]), float(m["grad_norm"]),
                         int(m["step"])))
        want_params = jax.tree_util.tree_map(np.asarray, state.params)
        got = gang.case(f"train/{layout}")
        _check(got, want, want_params, Transformer(pc),
               convert.unflatten(convert.random_params(pc, 0)))

    def test_stage_axis_sharded_over_pp(self, gang):
        """The stage leaves' specs from ``create_sharded_state(...,
        pipelined=True)`` are the reference's: ``spec[0] == "pp"``, the
        rest the layer's own."""
        pc = tiny_config(n_layers=PIPE_LAYERS)
        params = _jax_params(pc)
        mesh = _mesh(**PIPE_MESHES["dp2pp2"])
        model = JaxTransformer(jax_tiny(n_layers=PIPE_LAYERS))

        def init_fn(rng):
            return JaxState.create(apply_fn=model.apply, params=params,
                                   tx=jax_optimizer(LR))

        _, shardings = create_sharded_state(init_fn, jax.random.key(0), mesh,
                                            pipelined=True)
        for rank, got in enumerate(gang.case("train/dp2pp2")):
            specs = got["specs"]
            stage = rank % 2          # ranks lie (dcn, dp, pp, tp)
            assert specs[f"blocks.{2 * stage}.attn.q_proj"][0] == "pp"
            for name in got["held"]:
                parts = name.split(".")
                tree = shardings.params
                for part in (["blocks"] + parts[2:] if parts[0] == "blocks"
                             else parts):
                    tree = tree[part]
                assert specs[name] == tuple(tree.spec), (rank, name)
            # each rank holds its stage's layers under their global names
            assert f"blocks.{2 * stage}.attn.q_proj" in got["held"]
            assert len([n for n in got["held"] if n.endswith("q_proj")]) == 2


def test_checkpoint_restores_at_pp1(gang):
    """The dp = 2 × pp = 2 checkpoint, written gathered by rank 0, restores
    bit for bit into a whole model at pp = 1 (moments in the whole
    model's order), as it did at dp = 2 × pp = 2 on every rank."""
    from kubeflow_tpu_torch.train import create_train_state, make_optimizer
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    got = gang.case("train/dp2pp2")
    assert all(g["restored"] for g in got)
    pc = tiny_config(n_layers=PIPE_LAYERS)
    state = create_train_state(pc, convert.random_params(pc, 1),
                               make_optimizer(LR, **OPT), device="cpu")
    CheckpointManager(f"{gang.out}/ckpt-pipe").restore(state)
    assert state.step == STEPS and state.opt_state["count"] == STEPS
    names = [n for n, _ in state.module.named_parameters()]
    for name, p in state.module.named_parameters():
        assert torch.equal(p.detach(), got[0]["params"][name]), name
    for name, mu in zip(names, state.opt_state["mu"]):
        assert torch.equal(mu, got[0]["mu"][name]), name


def test_pipelined_step_and_device_feed_rows(gang):
    """The pipelined step's microbatches are the global batch's, which
    a rank's contiguous rows from ``device_feed(loader, mesh)`` are not
    at dp > 1: at dp = 2 x pp = 2 it refuses them on every rank; at
    pp = 2 x tp = 2 (dp = 1) they are the global batch, and the metrics
    are those of the batch passed whole."""
    for msg in gang.case("feed/dp2pp2"):
        assert "takes the global batch" in msg and "2 data-parallel" in msg
    want = gang.case("train/pp2tp2")
    for rank, (w, g) in enumerate(zip(want, gang.case("feed/pp2tp2"))):
        assert g == w["metrics"], f"rank {rank}"


def test_train_step_full_mesh(full_gang):
    """dp = 2 × pp = 2 × tp = 2 with MoE (experts over dp, capacity 2.0):
    four pipelined steps (2 microbatches) on 8 ranks. The first loss is
    the JAX package's on its 8-device mesh from the same weights (the
    global slot order inside each microbatch); the losses are finite,
    fall, and are the same on every rank."""
    pc = tiny_config(**FULL_CFG)
    model = JaxTransformer(jax_tiny(**FULL_CFG))
    mesh = _mesh(dp=2, pp=2, tp=2)
    tx = jax_optimizer(FULL_OPT["learning_rate"], warmup_steps=1,
                       decay_steps=FULL_OPT["decay_steps"])
    params = _jax_params(pc)

    def init_fn(rng):
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    state, _ = create_sharded_state(init_fn, jax.random.key(0), mesh,
                                    pipelined=True)
    step = jax_pipe_step(model, mesh, n_microbatches=2)
    _, m = step(state, jnp.asarray(full_mesh_tokens(pc.vocab_size)))
    got = full_gang.case("full")
    losses = got[0]["losses"]
    assert len(losses) == FULL_STEPS and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], float(m["loss"]), atol=1e-5,
                               rtol=0)
    assert losses[-1] < losses[0]
    for rank, g in enumerate(got):
        assert g["losses"] == losses, f"rank {rank}"


def test_pipelined_state_specs_match_jax():
    """``state_partition_specs(..., pipelined=True)`` and
    ``state_shardings(..., pipelined=True)`` of a whole model give every
    leaf the reference's spec of its stacked leaf (``"pp"`` on the
    layer axis), fitted to a dp 2 × pp 2 × tp 2 mesh."""
    from kubeflow_tpu.train import state_partition_specs as jax_specs
    from kubeflow_tpu.train import state_shardings as jax_shardings
    from kubeflow_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        state_partition_specs,
        state_shardings,
    )

    class Mesh:   # the port reads a mesh's axis names and sizes
        mesh_dim_names = ("dcn", "dp", "pp", "tp")

        def size(self, i):
            return (1, 2, 2, 2)[i]

    pc = tiny_config(n_layers=PIPE_LAYERS, n_experts=4)
    params = convert.unflatten(convert.random_params(pc, 0))
    jstate = JaxState.create(apply_fn=None, params=params,
                             tx=jax_optimizer(LR))
    want = jax_specs(jstate, pipelined=True)
    want_fit = jax_shardings(jstate, _mesh(dp=2, pp=2, tp=2),
                             pipelined=True)
    state = create_train_state(pc, params, make_optimizer(LR), device="cpu")
    got = state_partition_specs(state, pipelined=True)
    got_fit = state_shardings(state, Mesh(), pipelined=True)
    for name, _ in state.module.named_parameters():
        key, _ = convert._source_key(name, convert.flatten(params))
        w, wf = want.params, want_fit.params
        for part in key.split("/"):
            w, wf = w[part], wf[part]
        assert tuple(got["module"][name]) == tuple(w), name
        assert tuple(got_fit["module"][name]) == tuple(wf.spec), name
    assert tuple(got["module"]["blocks.3.moe.gate_proj"]) == (
        "pp", "dp", None, "tp")
