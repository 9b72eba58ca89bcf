"""Port LM training (``kubeflow_tpu_torch.train``) against the JAX package.

The same numpy-seeded weights, gradients and tokens go through
``kubeflow_tpu.train`` (optax, flax, a CPU mesh) and the port on the
CPU: the optimizer update by update, both next-token losses with their
gradients, and the whole train step over three steps, with remat on and
off. A bf16-compute, f32-param model must give every parameter a
gradient (the compute-dtype cast stays in the autograd graph).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import tiny_config as jax_tiny
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu.train.trainer import chunked_next_token_loss as jax_chunked
from kubeflow_tpu.train.trainer import next_token_loss as jax_loss
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import Transformer, tiny_config
from kubeflow_tpu_torch.train import (
    TrainState,
    chunked_next_token_loss,
    create_train_state,
    make_lm_train_step,
    make_optimizer,
    next_token_loss,
)

torch.set_num_threads(2)

SHAPES = {"embed": (5, 3), "dense/kernel": (3, 4), "norm/scale": (4,)}


@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax(clip):
    """Six updates of a small tree: lr 0 on the first (warmup from 0,
    read before the count advances), warmup, cosine decay past its end,
    clipping on and off, decay on the norm scale too."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(6)]
    kw = dict(warmup_steps=2, decay_steps=5, weight_decay=0.1,
              grad_clip=clip)
    jtx = jax_optimizer(0.1, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tx = make_optimizer(0.1, **kw)
    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    tstate = tx.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.apply(tp, [torch.from_numpy(g[k]) for k in SHAPES], tstate)
        for name, t in zip(SHAPES, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[name]),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} after update {i}")
        if i == 0:
            np.testing.assert_array_equal(tp[2].numpy(), params["norm/scale"])
    assert tstate["count"] == 6
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 5)
    for n in range(8):
        assert tx.schedule(n) == pytest.approx(float(sched(n)), abs=1e-8)


def _logits_and_tokens(B=2, S=9, V=11, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, V)).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32))


def test_next_token_loss_and_grad_match_jax():
    logits, toks = _logits_and_tokens()
    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits),
                                                jnp.asarray(toks))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = next_token_loss(t, torch.from_numpy(toks))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("chunk,softcap", [(4, 0.0), (3, 2.0), (16, 1.5)])
def test_chunked_loss_and_grads_match_jax(chunk, softcap):
    """Chunks that leave a padded tail (S - 1 = 8 by 3), a single chunk
    larger than the sequence, and the softcap."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 9, 6)).astype(np.float32)
    embed = rng.standard_normal((11, 6)).astype(np.float32)
    toks = rng.integers(0, 11, (2, 9)).astype(np.int32)
    want, (gh, ge) = jax.value_and_grad(
        lambda h, e: jax_chunked(h, e, jnp.asarray(toks), chunk=chunk,
                                 softcap=softcap), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(embed))
    th = torch.from_numpy(hidden).requires_grad_(True)
    te = torch.from_numpy(embed).requires_grad_(True)
    got = chunked_next_token_loss(th, te, torch.from_numpy(toks),
                                  chunk=chunk, softcap=softcap)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), atol=1e-6,
                               rtol=0)
    if softcap == 0.0:   # the unchunked loss over the same head
        logits = (torch.from_numpy(hidden) @ torch.from_numpy(embed).t())
        np.testing.assert_allclose(
            next_token_loss(logits, torch.from_numpy(toks)).item(),
            float(want), atol=1e-6, rtol=0)


def _jax_train(jc, toks, lr, n_steps):
    """JAX's train step over the CPU mesh of ``tests/test_checkpoint.py``;
    returns the initial params, per-step metrics and the final params."""
    model = JaxTransformer(jc)
    mesh = create_mesh(MeshConfig(dp=2, pp=1, tp=4))
    tx = jax_optimizer(lr, warmup_steps=1, decay_steps=50)

    def init_fn(rng):
        params = model.init(rng, toks)["params"]
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    state, _ = create_sharded_state(init_fn, jax.random.key(1), mesh)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = jax_step(mesh)
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, toks)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return params0, metrics, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax(remat):
    """Three steps of ``make_lm_train_step`` at ``tiny_config``, flash
    attention, f32: loss within 1e-5, grad_norm, and every parameter
    within 1e-4. lr 1e-3: AdamW's m/sqrt(v) magnifies f32 summation-order
    differences on near-zero gradient entries, so the parameter error of
    one update grows with lr (at 1e-2 a few of ~10^5 entries differ by
    ~3e-4)."""
    jc = jax_tiny(attention_impl="flash", remat=remat)
    toks = np.random.default_rng(3).integers(
        0, jc.vocab_size, (8, 16)).astype(np.int32)
    params0, want, want_params = _jax_train(jc, toks, 1e-3, 3)
    pc = tiny_config(attention_impl="flash", remat=remat)
    state = create_train_state(pc, params0, make_optimizer(
        1e-3, warmup_steps=1, decay_steps=50), device="cpu")
    step = make_lm_train_step()
    for i, (loss, gnorm, n) in enumerate(want):
        state, m = step(state, toks)
        assert m["step"] == n == i + 1
        np.testing.assert_allclose(float(m["loss"]), loss, atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=1e-5)
    ref = Transformer(pc)
    convert.load_params(ref, want_params)
    got = dict(state.module.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_bf16_compute_trains_every_parameter():
    """bf16 activations over f32 params: every parameter, the embedding
    and each projection included, gets a nonzero gradient (the cast to
    the compute dtype stays in the graph), and the loss tracks JAX's
    within the logit tolerance of the bf16 forward test."""
    jc = jax_tiny(attention_impl="flash", dtype=jnp.bfloat16)
    toks = np.random.default_rng(4).integers(
        0, jc.vocab_size, (8, 16)).astype(np.int32)
    params0, want, _ = _jax_train(jc, toks, 1e-3, 2)
    pc = tiny_config(attention_impl="flash", dtype=torch.bfloat16)
    state = create_train_state(pc, params0, make_optimizer(
        1e-3, warmup_steps=1, decay_steps=50), device="cpu")
    model = state.module
    loss = next_token_loss(model(torch.from_numpy(toks)),
                           torch.from_numpy(toks))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32 and g.abs().max() > 0, name
    step = make_lm_train_step()
    for loss_want, gnorm, _ in want:
        state, m = step(state, toks)
        np.testing.assert_allclose(float(m["loss"]), loss_want, atol=5e-2,
                                   rtol=0)
        np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=5e-2)


def test_step_refuses_chunked_loss_without_hidden_states():
    pc = tiny_config()
    state = TrainState.create(
        convert.to_trainable(pc, convert.random_params(pc, 0),
                             device="cpu"), make_optimizer())
    with pytest.raises(ValueError, match="return_hidden"):
        make_lm_train_step(loss_chunk=4)(state, np.zeros((1, 8), np.int32))
    hidden = create_train_state(pc, convert.random_params(pc, 0),
                                make_optimizer(), device="cpu",
                                return_hidden=True)
    _, m = make_lm_train_step(loss_chunk=4)(hidden,
                                            np.ones((1, 8), np.int32))
    assert np.isfinite(float(m["loss"])) and m["step"] == 1
