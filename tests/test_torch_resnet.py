"""The port's ResNet (``kubeflow_tpu_torch.models.resnet``) against JAX.

The same numpy-seeded variables (``convert.random_resnet_params`` with
every BN scale, bias and running statistic randomised, bn3 included)
and images go through ``kubeflow_tpu.models.resnet.ResNet.apply`` and
the port on the CPU: logits and the new ``batch_stats`` of a train-mode
forward, and eval-mode logits from the running statistics. At stage
sizes (1, 1), width 128, 32x32 images, both fused sites tile ((128,
128, 512) and (32, 256, 1024)), so JAX runs the Pallas kernels in
interpret mode. Also: the parameter tree and count of full ResNet-50,
the converter's round trip, XLA's ``SAME`` padding, flax's BatchNorm.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.resnet import ResNet as JaxResNet
from kubeflow_tpu.models.resnet import ResNetConfig as JaxConfig
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.resnet import (
    BatchNorm,
    Conv,
    ResNet,
    ResNetConfig,
    same_padding,
)
from kubeflow_tpu_torch.models.transformer import torch_dtype

torch.set_num_threads(2)

SMALL = dict(stage_sizes=(1, 1), num_classes=10, width=128)
RESNET50_PARAMS = 25_559_912


def _configs(stem, fused, dtype="float32"):
    jd = jnp.dtype(dtype)
    return (JaxConfig(**SMALL, dtype=jd, bn_dtype=jd, stem=stem,
                      fused_bn_conv=fused),
            ResNetConfig(**SMALL, dtype=dtype, bn_dtype=dtype, stem=stem,
                         fused_bn_conv=fused))


def randomized(variables, seed):
    """Every BN scale near one (bn3's too, which the reference zeroes),
    biases and running means small, running variances in [0.5, 1.5)."""
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


def _images(B=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, 32, 32, 3)).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_forward(jc, variables, images):
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    model = JaxResNet(jc)
    logits, mut = model.apply(jv, jnp.asarray(images), train=True,
                              mutable=["batch_stats"])
    stats = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                   mut["batch_stats"]))
    return logits, stats, model.apply(jv, jnp.asarray(images), train=False)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("stem", ["space_to_depth", "conv"])
def test_forward_and_batch_stats_match_jax(stem, fused):
    """f32: train-mode logits and every new running statistic, and
    eval-mode logits, within 1e-5 of the largest value (f32 summation
    order; measured 2e-6 or less)."""
    jc, pc = _configs(stem, fused)
    variables = randomized(convert.random_resnet_params(pc, 0), 1)
    images = _images()
    want, want_stats, want_eval = _jax_forward(jc, variables, images)
    model = convert.resnet_to_trainable(pc, variables, device="cpu")
    got = model(torch.from_numpy(images), train=True)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert _rel(got.detach(), want) <= 1e-5
    stats = convert.flatten(convert.resnet_variables(model)["batch_stats"])
    assert stats.keys() == want_stats.keys()
    for key, val in want_stats.items():
        assert _rel(stats[key], val) <= 1e-5, key
    frozen = convert.resnet_to_module(pc, variables, device="cpu")
    got_eval = frozen(torch.from_numpy(images), train=False)
    assert _rel(got_eval, want_eval) <= 1e-5
    # eval mode reads the running statistics and leaves them alone
    after = convert.flatten(convert.resnet_variables(frozen)["batch_stats"])
    for key, val in convert.flatten(variables["batch_stats"]).items():
        np.testing.assert_array_equal(after[key], val)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_forward_matches_jax(fused):
    """bf16 compute and BN output over f32 params: the two frameworks
    round at the same points, but a sum taken in another order can land
    on the other side of a bf16 rounding, and that moves later layers by
    a bf16 step (2^-8); held at 1e-2 of the largest logit (measured
    2.3e-3) and of each running statistic."""
    jc, pc = _configs("space_to_depth", fused, "bfloat16")
    variables = randomized(convert.random_resnet_params(pc, 3), 4)
    images = _images(seed=5)
    want, want_stats, want_eval = _jax_forward(jc, variables, images)
    model = convert.resnet_to_trainable(pc, variables, device="cpu")
    got = model(torch.from_numpy(images), train=True)
    assert _rel(got.detach(), want) <= 1e-2
    stats = convert.flatten(convert.resnet_variables(model)["batch_stats"])
    for key, val in want_stats.items():
        assert _rel(stats[key], val) <= 1e-2, key
    frozen = convert.resnet_to_module(pc, variables, device="cpu")
    got_eval = frozen(torch.from_numpy(images), train=False)
    assert _rel(got_eval, want_eval) <= 1e-2


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_variables_match_the_jax_tree(fused):
    """``random_resnet_params`` gives flax's tree for ResNet-50, leaf for
    leaf and shape for shape, 25,559,912 parameters, bn3 scales zero."""
    jax_model = JaxResNet(JaxConfig(fused_bn_conv=fused))
    want = jax.eval_shape(lambda: jax_model.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=True))
    got = convert.random_resnet_params(ResNetConfig(fused_bn_conv=fused), 0)
    flat_want = convert.flatten(want)
    flat_got = convert.flatten(got)
    assert flat_got.keys() == flat_want.keys()
    for key, leaf in flat_want.items():
        assert flat_got[key].shape == leaf.shape, key
        assert flat_got[key].dtype == np.float32, key
    n = sum(v.size for k, v in flat_got.items() if k.startswith("params/"))
    assert n == RESNET50_PARAMS
    for key, val in flat_got.items():
        if key.endswith("bn3/scale"):
            assert not val.any(), key
    with torch.device("meta"):
        model = ResNet(ResNetConfig(fused_bn_conv=fused))
    assert sum(p.numel() for p in model.parameters()) == RESNET50_PARAMS


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_converter_round_trip(fused):
    """A flax-initialised tree goes into a port module and comes back
    unchanged; a leaf of the wrong shape, a missing one and an extra one
    raise."""
    jc, pc = _configs("space_to_depth", fused)
    tree = jax.tree_util.tree_map(np.asarray, JaxResNet(jc).init(
        jax.random.key(3), jnp.zeros((1, 32, 32, 3)), train=True))
    tree = {k: tree[k] for k in ("params", "batch_stats")}
    model = convert.resnet_to_trainable(pc, tree, device="cpu")
    back = convert.flatten(convert.resnet_variables(model))
    flat = convert.flatten(tree)
    assert back.keys() == flat.keys()
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)
    bad = dict(flat)
    bad["params/head/kernel"] = bad["params/head/kernel"][:, :3]
    with pytest.raises(ValueError, match="head/kernel"):
        convert.load_resnet(ResNet(pc), bad)
    missing = {k: v for k, v in flat.items() if not k.endswith("bn1/mean")}
    with pytest.raises(KeyError, match="bn1/mean"):
        convert.load_resnet(ResNet(pc), missing)
    with pytest.raises(KeyError, match="no port tensor"):
        convert.load_resnet(ResNet(pc), dict(flat, **{"params/extra": 0.0}))


@pytest.mark.parametrize("size,kernel,stride", [(8, 3, 2), (7, 3, 2),
                                                (8, 2, 1), (8, 3, 1)])
def test_same_padding_is_xlas(size, kernel, stride):
    """``Conv`` against flax's ``nn.Conv(padding="SAME")`` on one input:
    XLA pads a stride-2 3x3 conv over an even size 0 before and 1 after,
    so output (0, 0) reads x(0, 0) through tap (0, 0)."""
    rng = np.random.default_rng(size + kernel + stride)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    k = rng.standard_normal((kernel, kernel, 4, 5)).astype(np.float32)
    want = fnn.Conv(5, (kernel, kernel), strides=stride, use_bias=False
                    ).apply({"params": {"kernel": jnp.asarray(k)}},
                            jnp.asarray(x))
    conv = Conv(4, 5, (kernel, kernel), stride, dtype=torch.float32,
                param_dtype=torch.float32)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    if (size, kernel, stride) == (8, 3, 2):
        assert same_padding(size, kernel, stride) == (0, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_is_flaxs(dtype):
    """``BatchNorm`` against flax's ``nn.BatchNorm`` (momentum 0.9): the
    train output and the running averages (biased variance), then the
    eval output from them. f32 within 1e-6 of the largest value; the
    bf16 output within one bf16 step (2^-8) of it."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 5, 5, 6)) * 2 + 1).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(6)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(6)).astype(np.float32)
    jd = jnp.dtype(dtype)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jd)
    jv = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
          "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    jx = jnp.asarray(x, jd)
    want, mut = bn.apply(jv, jx, use_running_average=False,
                         mutable=["batch_stats"])
    want_eval = bn.apply({"params": jv["params"], **mut}, jx,
                         use_running_average=True)
    port = BatchNorm(6, momentum=0.9, epsilon=1e-5, dtype=torch_dtype(dtype),
                     param_dtype=torch.float32)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch_dtype(dtype)).permute(0, 3, 1, 2)
    got = port(tx, train=True).permute(0, 2, 3, 1)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    assert got.dtype == torch_dtype(dtype)
    assert _rel(got.detach().float(), want.astype(jnp.float32)) <= tol
    for name in ("mean", "var"):
        assert _rel(getattr(port, name), mut["batch_stats"][name]) <= 1e-6
    got_eval = port(tx, train=False).permute(0, 2, 3, 1)
    assert _rel(got_eval.detach().float(),
                want_eval.astype(jnp.float32)) <= tol


def test_act_compress_is_not_ported_and_never_combines():
    """``act_compress`` is ported (``ops/act_compress.py``): every
    bottleneck conv becomes an ``Int8Conv`` with the plain conv's
    parameters; it still never combines with ``fused_bn_conv``."""
    from kubeflow_tpu_torch.ops.act_compress import Int8Conv

    model = ResNet(ResNetConfig(**SMALL, act_compress=True))
    plain = ResNet(ResNetConfig(**SMALL))
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    assert sum(isinstance(m, Int8Conv) for m in convs) == 8  # 2 x (3 + proj)
    assert [n for n, _ in model.named_parameters()] == \
        [n for n, _ in plain.named_parameters()]
    with pytest.raises(ValueError, match="cannot combine"):
        ResNet(ResNetConfig(**SMALL, act_compress=True, fused_bn_conv=True))


def test_fused_rows_are_a_view_of_channels_last_activations():
    """With NHWC bytes (``channels_last``) the fused layer reads its
    (pixels, channels) rows without a copy."""
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    rows = x.permute(0, 2, 3, 1).reshape(-1, 8)
    assert rows.data_ptr() == x.data_ptr() and rows.is_contiguous()
    model = convert.resnet_to_trainable(
        _configs("space_to_depth", True)[1],
        convert.random_resnet_params(_configs("space_to_depth", True)[1], 0),
        device="cpu")
    conv = dict(model.named_parameters())["stage0_block0.conv2.kernel"]
    assert conv.is_contiguous(memory_format=torch.channels_last)
