"""The port's int8 activation compression against the reference's.

The same numpy-seeded inputs go through ``kubeflow_tpu/ops/
act_compress.py`` and ``kubeflow_tpu_torch/ops/act_compress.py`` on the
CPU: the int8 values and scales equal (round half to even in both;
NHWC's last axis there, dim 1 of the port's NCHW view), zero channels
and bf16 inputs included; ``Int8Conv``'s forward and gradients within
1e-5 (of max(1, max-abs)) at f32; ``int8_checkpoint``'s forward exact and its gradients
within the reference's 2% of the exact op's; a thin ResNet with
``act_compress`` held to JAX's at the ResNet step tolerances (PERF.md
§2: loss 1e-5, each gradient 2e-2 of its norm, parameters after an SGD
step 1e-3); and both packages refuse ``act_compress`` with
``fused_bn_conv``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.resnet import ResNet as JaxResNet
from kubeflow_tpu.models.resnet import ResNetConfig as JaxConfig
from kubeflow_tpu.ops import act_compress as jac
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.resnet import Conv, ResNet, ResNetConfig
from kubeflow_tpu_torch.ops import act_compress as ac

torch.set_num_threads(2)

THIN = dict(stage_sizes=(1, 1), num_classes=10, width=16, stem="conv")


def _nhwc(shape=(2, 6, 5, 8), seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """The port's layout of an NHWC array: NCHW-shaped, channels-last."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_values_and_scales_equal_the_reference(dtype):
    x = _nhwc()
    x[..., 3] = 0.0                      # a zero channel
    x[0, 0, 0, 5] = 127.0 * 0.5          # a value on a rounding tie
    x[..., 5] = np.clip(x[..., 5], -1.0, 1.0)
    x[1, 1, 1, 5] = 2.54                 # absmax 2.54: step 0.02, 0.5 ties
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jq, jscale = jac.quantize_int8(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    q, scale = ac.quantize_int8(tx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    # the port's NCHW view, channel_dim=1, holds the same numbers
    qc, sc = ac.quantize_int8(tx.permute(0, 3, 1, 2), channel_dim=1)
    np.testing.assert_array_equal(qc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(sc.reshape(-1).numpy(),
                                  np.asarray(jscale).reshape(-1))
    assert sc.shape == (1, 8, 1, 1) and float(sc[0, 3]) == 0.0
    back = ac.dequantize_int8(q, scale)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jac.dequantize_int8(jq, jscale)))
    assert (back[..., 3] == 0).all()


def test_zero_tensor_dequantizes_to_exact_zeros():
    q, scale = ac.quantize_int8(torch.zeros(2, 3, 3, 4))
    assert (ac.dequantize_int8(q, scale) == 0).all()
    assert (scale == 0).all()


def test_int8_checkpoint_forward_exact_backward_close():
    """The reference's own gate: the forward bit-exact, the gradients
    within 2% (of the norm) of the exact op's."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 8)).astype(
        np.float32)).permute(0, 3, 1, 2).requires_grad_(True)
    k = torch.from_numpy((rng.standard_normal((16, 8, 3, 3)) * 0.1).astype(
        np.float32)).requires_grad_(True)

    def conv(kernel, xx):
        return torch.nn.functional.conv2d(xx, kernel, padding=1)

    wrapped = ac.int8_checkpoint(conv, channel_dim=1)
    assert torch.equal(wrapped(k, x), conv(k, x))
    ge = torch.autograd.grad((conv(k, x) ** 2).sum(), (k, x))
    gc = torch.autograd.grad((wrapped(k, x) ** 2).sum(), (k, x))
    rels = [float((exact - comp).norm() / (exact.norm() + 1e-8))
            for exact, comp in zip(ge, gc)]
    assert all(r < 0.02 for r in rels), rels
    # the kernel's gradient read the int8 input (dx does not need x)
    assert rels[0] > 0, rels


def test_int8_checkpoint_takes_a_sequence_of_params():
    x = torch.randn(3, 4, requires_grad=True)
    w, b = torch.randn(4, 5, requires_grad=True), torch.randn(5,
                                                              requires_grad=True)
    wrapped = ac.int8_checkpoint(lambda p, xx: xx @ p[0] + p[1])
    y = wrapped((w, b), x)
    assert torch.equal(y, x @ w + b)
    gw, gb, gx = torch.autograd.grad(y.sum(), (w, b, x))
    torch.testing.assert_close(gb, torch.full((5,), 3.0))
    torch.testing.assert_close(gx, w.sum(1).expand(3, 4), atol=1e-6, rtol=0)


@pytest.mark.parametrize("ksize,stride", [((1, 1), 1), ((3, 3), 1),
                                          ((3, 3), 2)])
def test_int8conv_forward_and_gradients_match_the_reference(ksize, stride):
    """Same kernel (flax ``(kh, kw, I, O)`` ↔ torch ``(O, I, kh, kw)``),
    same input: forward, dkernel and dx within 1e-5 at f32, of
    max(1, max-abs) (the stride-2 3x3 takes XLA's uneven SAME
    padding)."""
    x = _nhwc((2, 8, 8, 4), seed=3, scale=1.0)
    w = _nhwc((*ksize, 4, 8), seed=4, scale=0.3)
    g = _nhwc((2, 8 // stride, 8 // stride, 8), seed=5, scale=1.0)
    jmod = jac.Int8Conv(features=8, kernel_size=ksize,
                        strides=(stride, stride), dtype=jnp.float32)
    params = {"params": {"kernel": jnp.asarray(w)}}

    def jloss(p, xx):
        return jnp.sum(jmod.apply(p, xx) * jnp.asarray(g))

    jy = jmod.apply(params, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = ac.Int8Conv(4, 8, ksize, stride, dtype=torch.float32,
                      param_dtype=torch.float32)
    with torch.no_grad():
        mod.kernel.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
    tx = _nchw(x).contiguous(memory_format=torch.channels_last)
    tx.requires_grad_(True)
    y = mod(tx)
    (y * _nchw(g)).sum().backward()
    for got, want in ((y.detach().permute(0, 2, 3, 1), jy),
                      (mod.kernel.grad.permute(2, 3, 1, 0),
                       jgp["params"]["kernel"]),
                      (tx.grad.permute(0, 2, 3, 1), jgx)):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=0)


def test_int8conv_keeps_the_conv_parameter():
    """Checkpoints swap between the compressed and the plain configs:
    one ``kernel`` of one shape, and the same forward."""
    mod = ac.Int8Conv(4, 8, (3, 3), dtype=torch.float32,
                      param_dtype=torch.float32)
    plain = Conv(4, 8, (3, 3), dtype=torch.float32,
                 param_dtype=torch.float32)
    assert [n for n, _ in mod.named_parameters()] == ["kernel"]
    assert mod.kernel.shape == plain.kernel.shape
    plain.load_state_dict(mod.state_dict())
    x = torch.randn(2, 4, 8, 8)
    torch.testing.assert_close(mod(x), plain(x), atol=2e-5, rtol=2e-5)


def _randomized(variables, seed):
    """BN scales near one (bn3's too, which the reference zeroes: a zero
    bn3 would cut every conv's gradient), small biases and means."""
    rng = np.random.default_rng(seed)
    flat = convert.flatten(variables)
    for key, arr in flat.items():
        if key.endswith("/scale"):
            arr = 1.0 + 0.2 * rng.standard_normal(arr.shape)
        elif key.endswith("/bias") or key.endswith("/mean"):
            arr = 0.1 * rng.standard_normal(arr.shape)
        elif key.endswith("/var"):
            arr = 0.5 + rng.random(arr.shape)
        flat[key] = np.asarray(arr, np.float32)
    return convert.unflatten(flat)


def _loss_and_grads_jax(variables, images, labels):
    model = JaxResNet(JaxConfig(**THIN, dtype=jnp.float32,
                                bn_dtype=jnp.float32, act_compress=True))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(p):
        logits, _ = model.apply({"params": p,
                                 "batch_stats": jv["batch_stats"]},
                                jnp.asarray(images), train=True,
                                mutable=["batch_stats"])
        one = jax.nn.one_hot(jnp.asarray(labels), 10)
        return -jnp.mean(jnp.sum(one * jax.nn.log_softmax(logits), -1))

    loss, grads = jax.value_and_grad(loss_fn)(jv["params"])
    return loss.item(), convert.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": grads}))


def test_thin_resnet_step_with_act_compress_matches_jax():
    cfg = ResNetConfig(**THIN, dtype="float32", bn_dtype="float32",
                       act_compress=True)
    variables = _randomized(convert.random_resnet_params(cfg, 7), 8)
    rng = np.random.default_rng(9)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(4,))
    want_loss, want = _loss_and_grads_jax(variables, images, labels)

    model = convert.resnet_to_trainable(cfg, variables, device="cpu")
    assert type(model.stage0_block0.conv2).__name__ == "Int8Conv"
    assert type(model.stage1_block0.proj_conv).__name__ == "Int8Conv"
    logits = model(torch.from_numpy(images))
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(labels).long())
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - want_loss) < 1e-5
    got = convert.flatten(convert.resnet_grads(model, grads))
    assert set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        denom = max(float(np.linalg.norm(w)), 1e-12)
        err = float(np.linalg.norm(g - w)) / denom
        assert err < 2e-2, (key, err)
    # an SGD step (lr 0.1) from the two gradient sets: params within 1e-3
    for (name, p), g in zip(model.named_parameters(), grads):
        key = f"params/{name.replace('.', '/')}"
        mine = convert._to_jax(name, (p - 0.1 * g).detach()).numpy()
        ref = convert.flatten(variables)[key] - 0.1 * want[key]
        np.testing.assert_allclose(mine, ref, atol=1e-3, rtol=0)


def test_act_compress_with_fused_bn_conv_refused_by_both():
    images = jnp.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="cannot combine"):
        JaxResNet(JaxConfig(**THIN, act_compress=True,
                            fused_bn_conv=True)).init(
            jax.random.key(0), images, train=True)
    with pytest.raises(ValueError, match="cannot combine"):
        ResNet(ResNetConfig(**THIN, act_compress=True, fused_bn_conv=True))


def test_plain_conv_unchanged_without_act_compress():
    model = ResNet(ResNetConfig(**THIN))
    assert type(model.stage0_block0.conv1) is Conv
