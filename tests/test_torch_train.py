"""Port training (``kubeflow_tpu_torch.train``) against the JAX package.

The same numpy-seeded weights, gradients, tokens and images go through
``kubeflow_tpu.train`` (optax, flax, a CPU mesh) and the port on the
CPU: both optimizers update by update, the losses with their gradients,
the LM train step over three steps (remat on and off), and the image
train step over three steps of ResNet with BN statistics, fused and
unfused. A bf16-compute, f32-param model must give every parameter a
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
from kubeflow_tpu.models.resnet import ResNet as JaxResNet
from kubeflow_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from kubeflow_tpu.train import make_image_train_step as jax_image_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu.train.trainer import chunked_next_token_loss as jax_chunked
from kubeflow_tpu.train.trainer import next_token_loss as jax_loss
from kubeflow_tpu.train.trainer import softmax_cross_entropy as jax_xent
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.resnet import ResNetConfig
from kubeflow_tpu_torch.models.transformer import Transformer, tiny_config
from kubeflow_tpu_torch.train import (
    TrainState,
    chunked_next_token_loss,
    create_image_train_state,
    create_train_state,
    make_image_train_step,
    make_lm_train_step,
    make_optimizer,
    make_sgd,
    next_token_loss,
    softmax_cross_entropy,
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


@pytest.mark.parametrize("momentum,nesterov", [(None, False), (0.9, False),
                                               (0.9, True)],
                         ids=["plain", "momentum", "nesterov"])
def test_sgd_matches_optax(momentum, nesterov):
    """Five updates of ``make_sgd`` against ``optax.sgd`` from the same
    tree: the trace ``g + momentum * t`` and the ``-lr * t`` update round
    as optax's do, so f32 agrees to the last bit or two."""
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    jtx = optax.sgd(0.1, momentum=momentum, nesterov=nesterov)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tx = make_sgd(0.1, momentum=momentum, nesterov=nesterov)
    tp = [torch.from_numpy(params[k].copy()) for k in SHAPES]
    tstate = tx.init(tp)
    for i in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.apply(tp, [torch.from_numpy(g[k]) for k in SHAPES], tstate)
        for name, t in zip(SHAPES, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[name]),
                                       atol=1e-7, rtol=0,
                                       err_msg=f"{name} after update {i}")
    assert len(tstate["trace"]) == (3 if momentum else 0)


def test_softmax_cross_entropy_and_grad_match_jax():
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((6, 13))).astype(np.float32)
    labels = rng.integers(0, 13, 6).astype(np.int32)
    want, want_g = jax.value_and_grad(jax_xent)(jnp.asarray(logits),
                                                jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = softmax_cross_entropy(t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               atol=1e-7, rtol=0)


def _resnet_variables(cfg, seed):
    """Random variables with bn3's scales random too: at the reference's
    zero no gradient reaches the fused sites on the first step."""
    flat = convert.flatten(convert.random_resnet_params(cfg, seed))
    rng = np.random.default_rng(seed + 1)
    for key in flat:
        if key.endswith("bn3/scale"):
            flat[key] = (0.5 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    return convert.unflatten(flat)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_image_train_step_matches_jax(fused):
    """Three steps of ``make_image_train_step`` (SGD 0.1, momentum 0.9)
    on a ResNet with stages (1, 1), width 128, f32, 8 images of 32x32
    (both fused sites tile, so JAX runs the Pallas kernels in interpret
    mode): loss and accuracy each step, then every parameter and running
    statistic within 1e-5 (measured 3e-7).

    The fused step runs over the dp=8 CPU mesh. The unfused one runs
    over a one-device mesh: over dp=8 the JAX package's unfused gradient
    departs from its own single-device one by up to 5% of a leaf's
    largest entry (stage0_block0/proj_conv/kernel; ROADMAP Queue C),
    while the fused model's stays within 2e-6 on either mesh and the
    port agrees with single-device JAX in both layouts."""
    jc = JaxResNetConfig(stage_sizes=(1, 1), num_classes=10, width=128,
                         dtype=jnp.float32, bn_dtype=jnp.float32,
                         fused_bn_conv=fused)
    pc = ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=128,
                      dtype="float32", bn_dtype="float32",
                      fused_bn_conv=fused)
    variables = _resnet_variables(pc, 7)
    rng = np.random.default_rng(8)
    images = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    mesh = (create_mesh(MeshConfig(dp=8)) if fused else
            create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1]))
    model = JaxResNet(jc)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)

    def init_fn(rng):
        del rng
        return JaxState.create(apply_fn=model.apply, params=jv["params"],
                               batch_stats=jv["batch_stats"],
                               tx=optax.sgd(0.1, momentum=0.9))

    jstate, _ = create_sharded_state(init_fn, jax.random.key(0), mesh)
    jstep = jax_image_step(mesh)
    state = create_image_train_state(pc, variables,
                                     make_sgd(0.1, momentum=0.9),
                                     device="cpu")
    step = make_image_train_step()
    for i in range(3):
        jstate, jm = jstep(jstate, images, labels)
        state, m = step(state, images, labels)
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    want = convert.flatten({
        "params": jax.tree_util.tree_map(np.asarray, jstate.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              jstate.batch_stats)})
    got = convert.flatten(convert.resnet_variables(state.module))
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=1e-5, rtol=0,
                                   err_msg=key)


def test_image_train_step_without_batch_stats():
    """A classifier with no BN statistics (the reference's MNIST path)
    trains through the same step: no buffers, loss falls."""

    class Mlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(12, 5)

        def forward(self, images, train=True):
            return self.fc(images.reshape(images.shape[0], -1))

    torch.manual_seed(0)
    state = TrainState.create(Mlp(), make_sgd(0.5))
    assert state.batch_stats is None
    rng = np.random.default_rng(9)
    images = rng.standard_normal((10, 2, 2, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 10)
    step = make_image_train_step()
    losses = []
    for _ in range(5):
        state, m = step(state, images, labels)
        losses.append(float(m["loss"]))
    assert m["step"] == 5 and losses[-1] < losses[0]
    assert 0.0 <= float(m["accuracy"]) <= 1.0
