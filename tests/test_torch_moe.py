"""Port MoE (``MoeMlp``, ``ops/moe.py``, the aux-weighted LM step)
against the JAX package.

The same numpy-seeded weights and tokens go through
``kubeflow_tpu.models.Transformer`` with ``n_experts > 0`` and the
port's module on the CPU at f32: logits within 1e-5 in both layer
layouts and both dispatches, the summed load-balance loss within 1e-6,
the capacity dispatch and combine one-hots equal to the reference's
(overflowing tokens dropped), and three ``make_lm_train_step`` steps
with ``moe_aux_weight`` within 1e-5. Router weights are random f32, so
no two router logits of a token tie (``top_k`` tie-breaks may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import tiny_config as jax_tiny
from kubeflow_tpu.ops import moe as jax_moe
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.serving.model_store import transformer_export_config
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.ops import moe
from kubeflow_tpu_torch.train import (
    create_train_state,
    make_lm_train_step,
    make_optimizer,
)

torch.set_num_threads(2)


def _configs(**overrides):
    jc = jax_tiny(n_experts=4, experts_per_token=2, **overrides)
    pc = TransformerConfig(**{**transformer_export_config(jc),
                              "moe_capacity_factor":
                              jc.moe_capacity_factor,
                              "remat": jc.remat})
    return jc, pc


def _toks(seed, jc, shape=(2, 12)):
    return np.random.default_rng(seed).integers(
        0, jc.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("capacity", [0.0, 1.0], ids=["dense", "capacity"])
@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_moe_logits_and_aux_match_jax(capacity, scan_layers):
    jc, pc = _configs(scan_layers=scan_layers,
                      moe_capacity_factor=capacity)
    toks = _toks(0, jc)
    params = JaxTransformer(jc).init(jax.random.key(0), toks)["params"]
    want, mut = JaxTransformer(jc).apply({"params": params}, toks,
                                         mutable=["losses"])
    want_aux = sum(float(jnp.sum(v))
                   for v in jax.tree_util.tree_leaves(mut))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.to_module(pc, tree, device="cpu")
    assert len(model.blocks) == jc.n_layers and hasattr(model.blocks[0],
                                                        "moe")
    got, aux = model(torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert want_aux > 0
    np.testing.assert_allclose(float(aux), want_aux, atol=1e-6, rtol=0)
    # without return_aux the forward returns the logits alone
    np.testing.assert_array_equal(model(torch.from_numpy(toks)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("G,E,k,cf", [(24, 4, 2, 0.5), (16, 8, 1, 1.25),
                                      (40, 4, 2, 2.0)],
                         ids=["overflow", "top1", "roomy"])
def test_capacity_dispatch_matches_jax(G, E, k, cf):
    """Dispatch and combine equal the reference's one-hots, including
    the tokens an expert drops past its capacity; the aux loss and the
    routed output of ``capacity_moe`` within 1e-6."""
    rng = np.random.default_rng(G + E)
    logits = rng.standard_normal((G, E)).astype(np.float32) * 2.0
    C = jax_moe.expert_capacity(G, E, k, cf)
    assert moe.expert_capacity(G, E, k, cf) == C
    jd, jcb, jaux = jax_moe.capacity_dispatch(jnp.asarray(logits), k, C)
    d, cb, aux = moe.capacity_dispatch(torch.from_numpy(logits), k, C)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(cb.numpy(), np.asarray(jcb), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    if cf < 1.0:   # some token lost a slot it chose
        routed = np.asarray(jd).sum(axis=(1, 2))
        assert (routed < k).any()
    x = rng.standard_normal((G, 6)).astype(np.float32)
    w = rng.standard_normal((E, 6, 6)).astype(np.float32)
    jy, _ = jax_moe.capacity_moe(
        jnp.asarray(x), jnp.asarray(logits),
        lambda xe: jnp.einsum("ecd,edf->ecf", xe, jnp.asarray(w)),
        k=k, capacity_factor=cf)
    y, _ = moe.capacity_moe(
        torch.from_numpy(x), torch.from_numpy(logits),
        lambda xe: torch.einsum("ecd,edf->ecf", xe, torch.from_numpy(w)),
        k=k, capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)


def test_moe_train_step_matches_jax():
    """Three steps of ``make_lm_train_step`` with ``n_experts = 4`` (the
    optimized loss carries ``moe_aux_weight`` · aux): loss, grad_norm
    and every parameter within 1e-5 of JAX's on a one-device mesh. lr
    1e-5: AdamW's m/sqrt(v) turns f32 summation-order noise on
    near-zero gradient entries into steps of ~lr."""
    jc, pc = _configs()
    toks = _toks(3, jc, (4, 16))
    model = JaxTransformer(jc)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    tx = jax_optimizer(1e-5, warmup_steps=1, decay_steps=50)

    def init_fn(rng):
        params = model.init(rng, toks)["params"]
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    jstate, _ = create_sharded_state(init_fn, jax.random.key(1), mesh)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax_step(mesh, moe_aux_weight=0.5)
    state = create_train_state(pc, params0, make_optimizer(
        1e-5, warmup_steps=1, decay_steps=50), device="cpu")
    step = make_lm_train_step(moe_aux_weight=0.5)
    for i in range(3):
        jstate, jm = jstep(jstate, toks)
        state, m = step(state, toks)
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    ref = Transformer(pc)
    convert.load_params(ref, jax.tree_util.tree_map(np.asarray,
                                                    jstate.params))
    got = dict(state.module.named_parameters())
    assert any("moe.router" in n for n in got)
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_aux_weight_reaches_the_router():
    """The router's gradient comes from the aux term as well as the LM
    loss: from the same state, two steps with weight 0 and two with
    weight 10 report the same first LM loss but leave different
    routers."""
    jc, pc = _configs()
    toks = _toks(5, jc, (2, 16))
    params = convert.random_params(pc, seed=2)
    routers = []
    for w in (0.0, 10.0):
        state = create_train_state(pc, params, make_optimizer(
            1e-3, warmup_steps=1, decay_steps=50), device="cpu")
        state, m = make_lm_train_step(moe_aux_weight=w)(state, toks)
        state, m2 = make_lm_train_step(moe_aux_weight=w)(state, toks)
        routers.append((float(m["loss"]), state.module.blocks[0].moe.router
                        .detach().clone()))
    assert routers[0][0] == routers[1][0]   # the reported LM loss
    assert not torch.equal(routers[0][1], routers[1][1])
