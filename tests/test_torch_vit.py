"""The port's ViT and its image train step against the JAX package, on
the CPU.

The same numpy-seeded images and the same weights (carried across by
``models/convert.py``) go through ``kubeflow_tpu.models.ViT`` and
``kubeflow_tpu_torch.models.vit.ViT``: logits at f32 within 1e-5 in both
parameter layouts, remat on and off; the patches in flax's raster
order; the reference's error text for a wrong image size; three image
train steps against the reference's on a one-device mesh; bf16 near
JAX's bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import ViT as JaxViT
from kubeflow_tpu.models.vit import ViTConfig as JaxViTConfig
from kubeflow_tpu.models.vit import vit_base as jax_vit_base
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_image_train_step as jax_image_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.vit import ViT, ViTConfig, vit_base, vit_tiny
from kubeflow_tpu_torch.train import (
    create_vit_train_state,
    make_image_train_step,
    make_optimizer,
)

torch.set_num_threads(2)

B = 2


def _jax_cfg(scan_layers, remat=False, dtype=jnp.float32, **kw):
    return JaxViTConfig(image_size=32, patch_size=8, num_classes=10,
                        d_model=64, n_layers=2, n_heads=4, d_ff=128,
                        dtype=dtype, remat=remat, scan_layers=scan_layers,
                        **kw)


def _port_cfg(scan_layers, remat=False, dtype="float32"):
    return dataclasses.replace(vit_tiny(10), dtype=dtype, remat=remat,
                               scan_layers=scan_layers)


def _jax_params(scan_layers, seed=0):
    model = JaxViT(_jax_cfg(scan_layers))
    params = model.init(jax.random.key(seed),
                        jnp.zeros((B, 32, 32, 3)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _images(seed=1, n=B):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_logits_match_jax(scan_layers, remat):
    """f32 logits within 1e-5 of JAX's from the same weights; with remat
    the port's forward runs under autograd, where the blocks are
    checkpointed, and the gradient reaches every parameter."""
    params = _jax_params(scan_layers)
    x = _images()
    want = np.asarray(JaxViT(_jax_cfg(scan_layers, remat)).apply(
        {"params": params}, x))
    m = convert.vit_to_trainable(_port_cfg(scan_layers, remat), params,
                                 device="cpu")
    got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    grads = torch.autograd.grad(got.square().sum(), list(m.parameters()))
    assert all(g.abs().max() > 0 for g in grads)


def test_patches_are_in_flax_raster_order():
    """A transposed image (H and W swapped) gives other logits, each
    equal to JAX's: a stem flattened column by column would swap them.
    And patch n of the stem's output is the patch at row n // 4, column
    n % 4 of the 4 x 4 grid."""
    params = _jax_params(False)
    jmodel = JaxViT(_jax_cfg(False))
    m = convert.vit_to_module(_port_cfg(False), params, device="cpu")
    x = _images(2)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    got = [m(torch.from_numpy(a)).numpy() for a in (x, xt)]
    for a, g in zip((x, xt), got):
        np.testing.assert_allclose(
            g, np.asarray(jmodel.apply({"params": params}, a)), atol=1e-5,
            rtol=0)
    assert np.abs(got[0] - got[1]).max() > 1e-3
    emb = m.patch_embed(torch.from_numpy(x)).reshape(B, -1, 64)
    kernel = params["patch_embed"]["kernel"]
    for n in (1, 4, 7):
        r, c = divmod(n, 4)
        patch = x[:, 8 * r:8 * r + 8, 8 * c:8 * c + 8]
        want = np.einsum("bhwc,hwcd->bd", patch, kernel) + \
            params["patch_embed"]["bias"]
        np.testing.assert_allclose(emb[:, n].numpy(), want, atol=1e-4,
                                   rtol=0)


def test_wrong_image_size_gives_the_reference_error():
    with pytest.raises(ValueError) as jerr:
        JaxViT(_jax_cfg(False)).init(jax.random.key(0),
                                     jnp.zeros((1, 64, 64, 3)))
    m = convert.vit_to_module(_port_cfg(False), _jax_params(False),
                              device="cpu")
    with pytest.raises(ValueError) as err:
        m(torch.zeros(1, 64, 64, 3))
    assert str(err.value) == str(jerr.value) == "expected 32² input, got 64x64"
    with pytest.raises(ValueError, match="expected 32² input, got 32x16"):
        m(torch.zeros(1, 32, 16, 3))


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_image_train_step_matches_jax(scan_layers):
    """Three steps of ``make_image_train_step`` (the reference's ViT
    path: no ``batch_stats``) against JAX's on a one-device mesh, f32:
    loss and accuracy each step, then every parameter, within 1e-5, at
    the example's learning rate (3e-4) after a one-step warm-up."""
    cfg = _jax_cfg(scan_layers)
    model = JaxViT(cfg)
    x = _images(3, 8)
    labels = np.random.default_rng(4).integers(0, 10, 8).astype(np.int32)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    tx = jax_optimizer(3e-4, warmup_steps=1, decay_steps=50)

    def init_fn(rng):
        params = model.init(rng, x[:2])["params"]
        return JaxState.create(
            apply_fn=lambda v, imgs, train=True: model.apply(v, imgs),
            params=params, tx=tx)

    jstate, _ = create_sharded_state(init_fn, jax.random.key(5), mesh)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax_image_step(mesh)
    state = create_vit_train_state(
        _port_cfg(scan_layers), params0,
        make_optimizer(3e-4, warmup_steps=1, decay_steps=50), device="cpu")
    assert state.batch_stats is None
    step = make_image_train_step()
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(labels))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(labels))
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        assert float(m["accuracy"]) == float(jm["accuracy"])
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = convert.flatten(convert.bert_params(state.module,
                                              scan_layers=scan_layers))
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=1e-5, rtol=0,
                                   err_msg=key)


def test_bf16_compute_is_near_jax():
    """bf16 activations over f32 params (the default): logits near JAX's
    bf16 logits, within a bf16-sized share of their scale, and every
    parameter gets an f32 gradient."""
    params = _jax_params(True)
    x = _images(6)
    want = np.asarray(JaxViT(_jax_cfg(True, dtype=jnp.bfloat16)).apply(
        {"params": params}, x))
    m = convert.vit_to_trainable(_port_cfg(True, remat=True,
                                           dtype="bfloat16"),
                                 params, device="cpu")
    got = m(torch.from_numpy(x))
    scale = float(np.abs(want).max())
    assert float(np.abs(got.detach().numpy() - want).max()) <= 2e-2 * scale
    grads = torch.autograd.grad(got.sum(), list(m.parameters()))
    for (name, _), g in zip(m.named_parameters(), grads):
        assert g.dtype == torch.float32 and g.abs().max() > 0, name


def test_random_params_fit_jax_trees_and_round_trip():
    """``random_vit_params`` gives the JAX tree's keys and shapes in both
    layouts (ViT-B/16's full tree too, by shape only), and
    ``bert_params`` takes a loaded ViT back bit for bit."""
    for scan in (True, False):
        want = convert.flatten(_jax_params(scan))
        rp = convert.random_vit_params(_port_cfg(scan), 0)
        assert {k: v.shape for k, v in rp.items()} == {
            k: v.shape for k, v in want.items()}
        m = convert.vit_to_module(_port_cfg(scan), rp, device="cpu")
        back = convert.flatten(convert.bert_params(m, scan_layers=scan))
        for k, v in rp.items():
            np.testing.assert_array_equal(back[k], v)
    shapes = convert.flatten(jax.eval_shape(
        lambda: JaxViT(jax_vit_base()).init(
            jax.random.key(0), jnp.zeros((1, 224, 224, 3))))["params"])
    with torch.device("meta"):
        base = ViT(vit_base())
    got = {convert._jax_key(n, True)[0]:
           ((12,) if n.startswith("blocks.") else ()) + tuple(p.shape)
           for n, p in base.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in shapes.items()}
    assert sum(p.numel() for p in base.parameters()) == sum(
        int(np.prod(v.shape)) for v in shapes.values())


def test_config_defaults_are_the_reference():
    ours, ref = ViTConfig(), JaxViTConfig()
    for f in dataclasses.fields(JaxViTConfig):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.n_patches == ref.n_patches == 196
    assert ours.dtype == torch.bfloat16
    enc = ours.encoder_config()
    assert enc.attention_impl == ref.encoder_config().attention_impl
    assert not enc.causal
