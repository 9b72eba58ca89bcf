"""The port's fused BN-apply + ReLU + 1x1 conv against the JAX package.

The same numpy-seeded x, a, b, w and cotangent go through
``kubeflow_tpu.ops.bnconv.fused_scale_relu_matmul`` and the port's
autograd function on the CPU (where its wrappers take their plain
versions): the output and all four gradients. (256, 128, 128) runs the
Pallas kernels in interpret mode; (64, 20, 40) runs the reference's XLA
branch (``_reference``). Three dtype cases: f32, f32 with the activation
rounded through bf16 (``act_dtype``), and bf16 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kubeflow_tpu.ops.bnconv import _tileable
from kubeflow_tpu.ops.bnconv import fused_scale_relu_matmul as jax_fused
from kubeflow_tpu_torch.ops import bnconv

torch.set_num_threads(2)

# (x dtype, act_dtype): f32 is held at 1e-5 of the largest value (f32
# summation order only); bf16 inputs at the reference's own tolerance for
# a bf16-rounded activation (tests/test_bnconv.py, atol 5e-3, rtol 2e-2):
# one bf16 step of an output is 2^-8 of it
CASES = {"f32": (torch.float32, None, jnp.float32, None),
         "f32_act_bf16": (torch.float32, torch.bfloat16, jnp.float32,
                          jnp.bfloat16),
         "bf16": (torch.bfloat16, torch.bfloat16, jnp.bfloat16,
                  jnp.bfloat16)}


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (rng.standard_normal(K) * 0.5 + 1.0).astype(np.float32),
            (rng.standard_normal(K) * 0.1).astype(np.float32),
            (rng.standard_normal((K, N)) * 0.05).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


def _f32(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("M,K,N", [(256, 128, 128), (64, 20, 40)],
                         ids=["pallas", "xla_branch"])
def test_op_and_grads_match_jax(M, K, N, case):
    assert _tileable(M, K, N) == (M == 256)
    tdt, tact, jdt, jact = CASES[case]
    x, a, b, w, g = _inputs(M, K, N)
    jx, jw, jg = (jnp.asarray(v, jdt) for v in (x, w, g))
    want, vjp = jax.vjp(lambda *args: jax_fused(*args, None, jact), jx,
                        jnp.asarray(a), jnp.asarray(b), jw)
    want_grads = vjp(jg)
    tx, ta, tb, tw = (torch.from_numpy(_f32(v)).to(d).requires_grad_(True)
                      for v, d in ((jx, tdt), (a, torch.float32),
                                   (b, torch.float32), (jw, tdt)))
    got = bnconv.fused_scale_relu_matmul(tx, ta, tb, tw, tact)
    got_grads = torch.autograd.grad(got, (tx, ta, tb, tw),
                                    torch.from_numpy(_f32(jg)).to(tdt))
    assert got.dtype == tdt
    assert [t.dtype for t in got_grads] == [tdt, torch.float32,
                                            torch.float32, tdt]
    for name, t, j in zip(("out", "dx", "da", "db", "dw"),
                          (got, *got_grads), (want, *want_grads)):
        t, j = _f32(t), _f32(j)
        if tdt == torch.float32:
            err = np.abs(t - j).max() / np.abs(j).max()
            assert err <= 1e-5, f"{name}: {err}"
        else:
            np.testing.assert_allclose(t, j, atol=5e-3, rtol=2e-2,
                                       err_msg=name)


def test_act_dtype_rounds_the_activation():
    """bf16 ``act_dtype`` on f32 inputs moves the output off the f32
    op, and the plain versions round y before the product."""
    x, a, b, w, g = (torch.from_numpy(v) for v in _inputs(64, 24, 32, 1))
    f32 = bnconv.bnconv_fwd_plain(x, a, b, w)
    rounded = bnconv.bnconv_fwd_plain(x, a, b, w, torch.bfloat16)
    assert not torch.allclose(f32, rounded, atol=1e-6, rtol=0)
    y = torch.clamp_min(x * a + b, 0).to(torch.bfloat16).float()
    torch.testing.assert_close(bnconv.activation(x, a, b, torch.bfloat16),
                               y, atol=0, rtol=0)
    torch.testing.assert_close(
        bnconv.bnconv_dw_plain(x, a, b, g, torch.bfloat16), y.t() @ g,
        atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_take_the_plain_versions():
    """CPU tensors never launch: the wrappers return their plain
    versions, the counts stay put, the dW output dtype is honoured, and
    inputs that do not fit raise."""
    x, a, b, w, g = (torch.from_numpy(v) for v in _inputs(48, 16, 24, 2))
    before = dict(bnconv.launches)
    assert torch.equal(bnconv.bnconv_fwd(x, a, b, w),
                       bnconv.bnconv_fwd_plain(x, a, b, w))
    dw = bnconv.bnconv_dw(x, a, b, g, out_dtype=torch.bfloat16)
    assert dw.dtype == torch.bfloat16 and dw.shape == (16, 24)
    assert torch.equal(dw, bnconv.bnconv_dw_plain(
        x, a, b, g, out_dtype=torch.bfloat16))
    assert bnconv.launches == before
    with pytest.raises(ValueError, match="rows"):
        bnconv.bnconv_fwd(x, a, b, w[:8])
    with pytest.raises(ValueError, match=r"a and b"):
        bnconv.bnconv_dw(x, a[:8], b, g)


def test_vjp_with_plain_dw_is_the_autograd_backward():
    """``fused_vjp`` with the plain dW is what the autograd function
    computes on CPU tensors, bit for bit (the chip smoke holds the
    kernel's backward against it)."""
    x, a, b, w, g = (torch.from_numpy(v).to(torch.bfloat16) if i in (0, 3, 4)
                     else torch.from_numpy(v)
                     for i, v in enumerate(_inputs(40, 16, 8, 3)))
    xs = [t.clone().requires_grad_(True) for t in (x, a, b, w)]
    out = bnconv.fused_scale_relu_matmul(*xs)
    got = torch.autograd.grad(out, xs, g)
    want = bnconv.fused_vjp(x, a, b, w, g, None,
                            dw_fn=bnconv.bnconv_dw_plain)
    for t, u in zip(got, want):
        assert t.dtype == u.dtype and torch.equal(t, u)


@pytest.mark.parametrize("fault", ["unrounded_y", "bf16_dy"])
def test_bf16_faults_exceed_the_chip_limit(fault):
    """The chip smoke's bf16 limit has teeth: at the K and N of
    ResNet-50's first-stage site, with M cut to 4096 rows, plain
    arithmetic with one bf16 fault reads above it against the plain
    version."""
    rng = np.random.default_rng(4)
    M, K, N = 4096, 64, 256
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    a = torch.from_numpy((rng.random(K) + 0.5).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(K) * 0.2).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5
                          ).astype(np.float32)).to(torch.bfloat16)
    dz = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)
                          ).to(torch.bfloat16)
    faults = chip_smoke.bnconv_faults(x, a, b, w, dz, None)
    if fault == "unrounded_y":
        want = (bnconv.bnconv_fwd_plain(x, a, b, w),
                bnconv.bnconv_dw_plain(x, a, b, dz, None, torch.bfloat16))
        bad = faults[:2]
    else:
        want = bnconv.fused_vjp(x, a, b, w, dz, None,
                                dw_fn=bnconv.bnconv_dw_plain)[:1]
        bad = faults[2:]
    for got, ref in zip(bad, want):
        assert chip_smoke.norm_err(got, ref) > chip_smoke.BNCONV_BF16_LIMIT
