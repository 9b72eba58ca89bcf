"""Port flash attention (plain path) against the JAX Pallas kernels.

The same numpy-seeded q/k/v go through ``kubeflow_tpu.ops.attention``'s
``flash_attention`` (its Pallas kernels in interpret mode, as
``tests/test_ops.py`` runs them on the CPU) and the port's
``ops.attention.flash_attention`` on CPU tensors, which takes the plain
versions of the three kernels. f32 forward (out and lse) within 1e-5,
gradients within 1e-4 (``tests/test_ops.py``'s own); bf16 gradients at
that file's ``atol=0.15, rtol=0.1``. The JAX kernels need S to divide
by their tiles; ragged S is held against ``reference_attention``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jatt
from kubeflow_tpu_torch.ops import attention as att
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)
BLOCKS = [(16, 16), (32, 16), (16, 32)]


def _np_qkv(B=2, S=64, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 for _ in range(4))  # q, k, v and a cotangent


def _torch(*arrays, dtype=torch.float32, grad=False):
    return tuple(torch.from_numpy(a).to(dtype).requires_grad_(grad)
                 for a in arrays)


def _jax(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


def _port_grads(q, k, v, w, *, causal, kv_len=None, dtype=torch.float32):
    tq, tk, tv = _torch(q, k, v, dtype=dtype, grad=True)
    out = att.flash_attention(tq, tk, tv, causal, kv_len=kv_len)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad)


def _jax_grads(fn, q, k, v, w, dtype=jnp.float32):
    jq, jk, jv = _jax(q, k, v, dtype=dtype)
    return jax.grad(lambda q, k, v: jnp.sum(
        fn(q, k, v).astype(jnp.float32) * w), argnums=(0, 1, 2))(jq, jk, jv)


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_out_and_lse_match_pallas(causal, bq, bk):
    q, k, v, _ = _np_qkv()
    want, want_lse = jatt._flash_fwd(*_jax(q, k, v), causal=causal,
                                     block_q=bq, block_k=bk, sm_scale=None,
                                     interpret=True)
    got, lse = fa.flash_fwd(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    B, S, H, _ = q.shape
    np.testing.assert_allclose(lse.numpy().reshape(B * H, S, 1),
                               np.asarray(want_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_pallas(causal, bq, bk):
    q, k, v, w = _np_qkv(seed=1)
    _, got = _port_grads(q, k, v, w, causal=causal)
    want = _jax_grads(lambda q, k, v: jatt.flash_attention(
        q, k, v, causal, bq, bk, None, True), q, k, v, w)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lens", [None, (40, 64)])
def test_flash_bwd_matches_pallas_backward(causal, lens):
    """``flash_bwd`` (dQ, dK and dV from one call) against the
    reference's ``_flash_bwd`` (its dQ and dK/dV Pallas kernels in
    interpret mode) on the reference forward's out and lse, f32, with
    and without ``kv_len``: within 1e-4."""
    q, k, v, g = _np_qkv(seed=4)
    jl = None if lens is None else jnp.asarray(np.asarray(lens, np.int32))
    jq, jk, jv, jg = _jax(q, k, v, g)
    o, jlse = jatt._flash_fwd(jq, jk, jv, causal=causal, block_q=16,
                              block_k=16, sm_scale=None, interpret=True,
                              kv_len=jl)
    want = jatt._flash_bwd(jq, jk, jv, o, jlse, jg, causal=causal,
                           block_q=16, block_k=16, sm_scale=None,
                           interpret=True, kv_len=jl)
    B, S, H, _ = q.shape
    tq, tk, tv, tg = _torch(q, k, v, g)
    lse = torch.from_numpy(np.array(jlse)).reshape(B, H, S)
    delta = fa.flash_delta(tg, torch.from_numpy(np.array(o)))
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = fa.flash_bwd(tq, tk, tv, tg, lse, delta, causal=causal,
                       kv_len=kv_len)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("lens", [None, (100, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_at_the_kernel_key_block_matches_pallas(causal, lens):
    """bf16 at D = 64, the wgmma forward's inputs: the plain forward
    steps over the kernels' 64-key blocks (``BLOCK_K``, the wgmma
    kernel's ``kFwdStep``), so it rounds P to bf16 at the running max of
    each 64-key block, as the reference's Pallas forward does at
    ``block_k=64`` (interpret mode, ``block_q=64``, with and without
    ``kv_len``). out within a norm-relative 4e-4 (the card's bf16 limit:
    the two sum q.k in another order, which can move a P across a bf16
    rounding), lse within 1e-5."""
    q, k, v, _ = _np_qkv(B=2, S=256, H=2, D=64, seed=7)
    jl = None if lens is None else jnp.asarray(np.asarray(lens, np.int32))
    want, want_lse = jatt._flash_fwd(*_jax(q, k, v, dtype=jnp.bfloat16),
                                     causal=causal, block_q=64, block_k=64,
                                     sm_scale=None, interpret=True,
                                     kv_len=jl)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    assert fa.BLOCK_K == at.WGMMA_TILES["flash_fwd"][1] == 64
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got, lse = fa.flash_fwd_plain(tq, tk, tv, causal=causal, kv_len=kv_len)
    want = np.asarray(want, np.float32)
    live = slice(None) if lens is None else slice(0, 100)
    got = got.float().numpy()
    for row, cut in ((0, live), (1, slice(None))):
        a, b = got[row, cut], want[row, cut]
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= 4e-4, f"row {row}: norm err {rel}"
    B, S, H, _ = q.shape
    lse = lse.numpy().reshape(B, H, S)
    want_lse = np.asarray(want_lse).reshape(B, H, S)
    np.testing.assert_allclose(lse[0, :, live], want_lse[0, :, live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse[1], want_lse[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("S", [45, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_key_block_matches_reference(causal, S):
    """The plain forward over its ``BLOCK_K`` key blocks, f32, on a
    ragged S (one 64-key block or several with a ragged last) and a
    ``kv_len`` masking a ragged tail: out within 1e-5 of JAX's
    ``reference_attention``."""
    q, k, v, _ = _np_qkv(B=2, S=S, H=2, D=64, seed=8 + S)
    lens = np.asarray([S, S - 17], np.int32)
    tq, tk, tv = _torch(q, k, v)
    kv_len = torch.from_numpy(lens)
    got, _ = fa.flash_fwd_plain(tq, tk, tv, causal=causal, kv_len=kv_len)
    ref = np.asarray(jatt.reference_attention(
        *_jax(q, k, v), causal=causal, kv_len=jnp.asarray(lens)))
    np.testing.assert_allclose(got.numpy()[0], ref[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[1, :S - 17], ref[1, :S - 17],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_matches_pallas(causal):
    """The padding mask in the forward and both backward passes;
    cotangent zero at padded q rows, as ``tests/test_ops.py`` has it."""
    q, k, v, w = _np_qkv(seed=2)
    lens = np.asarray([40, 64], np.int32)
    w = w * (np.arange(64)[None, :] < lens[:, None])[..., None, None]
    out, got = _port_grads(q, k, v, w, causal=causal,
                           kv_len=torch.from_numpy(lens))
    jl = jnp.asarray(lens)
    fn = (lambda q, k, v: jatt.flash_attention(q, k, v, causal, 16, 16,
                                               None, True, jl))
    ref = np.asarray(jatt.reference_attention(*_jax(q, k, v), causal=causal,
                                              kv_len=jl))
    np.testing.assert_allclose(out.detach().numpy()[0, :40], ref[0, :40],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy()[1], ref[1], atol=1e-5,
                               rtol=0)
    for g, r, name in zip(got, _jax_grads(fn, q, k, v, w), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_zero_length_row_averages_v(causal):
    """A batch row with kv_len = 0 has every key masked: NEG_INF is
    finite, so it averages V uniformly, as ``reference_attention`` does
    (with -inf it would be inf - inf = NaN)."""
    q, k, v, _ = _np_qkv(seed=3)
    lens = np.asarray([0, 37], np.int32)
    got, lse = fa.flash_fwd(*_torch(q, k, v), causal=causal,
                            kv_len=torch.from_numpy(lens))
    ref = np.asarray(jatt.reference_attention(
        *_jax(q, k, v), causal=causal, kv_len=jnp.asarray(lens)))
    assert np.isfinite(got.numpy()).all() and np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(got.numpy()[0], np.broadcast_to(
        v.mean(axis=1, keepdims=True)[0], v.shape[1:]), atol=1e-5)
    np.testing.assert_allclose(got.numpy()[0], ref[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy()[1, :37], ref[1, :37], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_seq_matches_reference(causal):
    """Any S: the port masks the ragged edge, where the JAX kernels need
    S to divide by their tiles (and the JAX model falls back to
    blockwise). Held against autodiff through ``reference_attention``."""
    q, k, v, w = _np_qkv(S=45, seed=4)
    out, got = _port_grads(q, k, v, w, causal=causal)
    ref = np.asarray(jatt.reference_attention(*_jax(q, k, v), causal=causal))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    want = _jax_grads(lambda q, k, v: jatt.reference_attention(
        q, k, v, causal=causal), q, k, v, w)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [16, 80, 96, 300, 320, 576])
def test_padded_head_dim_matches_reference(D):
    """The CUDA path's head-dim repair on the plain versions: q, k, v and
    dO zero-padded along D to the width the kernels run (the next of
    ``HEAD_DIMS``, past 256 the next multiple of ``WIDE_STEP``) by
    ``pad_head_dim``, run with the true D's scale, and sliced back
    (``unpad_head_dim``) equal JAX's ``reference_attention`` and its
    gradients (f32, 1e-5); the padded columns come out exactly zero.
    320 and 576 are widths of their own (no padding)."""
    q, k, v, w = _np_qkv(S=48, D=D, seed=20 + D)
    width = fa.padded_head_dim(D)
    assert fa.padded_head_dim(width) == width and width >= D
    if D <= fa.HEAD_DIMS[-1]:
        assert width in fa.HEAD_DIMS and width > D
    else:
        assert width % fa.WIDE_STEP == 0 and width - D < fa.WIDE_STEP
    padded = fa.pad_head_dim(_torch(q, k, v, w), width)
    assert all(t.shape[-1] == width for t in padded)
    pq, pk, pv, pg = padded
    kw = dict(causal=True, sm_scale=D ** -0.5)
    out, lse = fa.flash_fwd_plain(pq, pk, pv, **kw)
    delta = fa.flash_delta(pg, out)
    dq = fa.flash_bwd_dq_plain(pq, pk, pv, pg, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv_plain(pq, pk, pv, pg, lse, delta, **kw)
    for t in (out, dq, dk, dv):
        assert (t[..., D:] == 0).all()
    got = fa.unpad_head_dim((out, dq, dk, dv), D)
    assert all(t.shape == q.shape for t in got)
    if width > D:   # a slice is copied; at width == D the tensor itself
        assert all(t.is_contiguous() for t in got)
    ref = np.asarray(jatt.reference_attention(*_jax(q, k, v), causal=True))
    want = _jax_grads(lambda q, k, v: jatt.reference_attention(
        q, k, v, causal=True), q, k, v, w)
    for g, r, name in zip(got, (ref, *want), ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_path_past_256_matches_reference(causal):
    """D = 320 through the port's autograd function (the plain passes on
    the CPU, as the wide kernels run them on the card): out and the three
    gradients equal JAX's ``reference_attention`` and its autodiff within
    1e-5, with a ``kv_len`` that masks a ragged tail."""
    q, k, v, w = _np_qkv(S=40, D=320, seed=31)
    lens = torch.tensor([40, 29], dtype=torch.int32)
    out, got = _port_grads(q, k, v, w, causal=causal, kv_len=lens)
    jl = jnp.asarray(lens.numpy())

    def ref_fn(q, k, v):
        return jatt.reference_attention(q, k, v, causal=causal, kv_len=jl)
    ref = np.asarray(ref_fn(*_jax(q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    want = _jax_grads(ref_fn, q, k, v, w)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0, err_msg=f"d{name}")


def test_bf16_gradients_track_pallas():
    q, k, v, w = _np_qkv(seed=5)
    out, got = _port_grads(q, k, v, w, causal=True, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    want = _jax_grads(lambda q, k, v: jatt.flash_attention(
        q, k, v, True, 16, 16, None, True), q, k, v, w, dtype=jnp.bfloat16)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), atol=0.15,
                                   rtol=0.1, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_path_gradcheck_float64(causal):
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 11, 2, 8)))
               .requires_grad_(True) for _ in range(3))
    lens = torch.tensor([7, 11], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: att.flash_attention(q, k, v, causal, kv_len=lens),
        (q, k, v))


def test_cpu_tensors_count_no_launch_and_checks_raise():
    q, k, v, g = _torch(*_np_qkv(S=16))
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(g, out)
    fa.flash_bwd_dq(q, k, v, g, lse, delta)
    fa.flash_bwd_dkv(q, k, v, g, lse, delta)
    fa.flash_bwd(q, k, v, g, lse, delta)
    assert fa.launches == before
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_fwd(q, k[:, :, :2], v)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq(q, k, v, g, lse[:, :, :8], delta)


def test_bf16_row_check_refuses_rows_off_16_bytes():
    """``check_rows_16b`` (the bf16 kernels' cp.async contract) passes
    the model's views and refuses a base address or a (b, s, h) stride
    that is not a multiple of 16 bytes; a dim of length 1 never steps."""
    x = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    fused = torch.zeros(2, 16, 3 * 4 * 64, dtype=torch.bfloat16)
    fa.check_rows_16b([x, x.transpose(1, 2).contiguous().transpose(1, 2),
                       fused[..., 256:512].view(2, 16, 4, 64),
                       torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16)
                       .as_strided((1, 16, 1, 64), (3, 64, 5, 1))])
    flat = torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)
    for bad in (flat[1:].view(2, 16, 4, 64),
                torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64],
                fused[..., 4:260].view(2, 16, 4, 64)):
        with pytest.raises(ValueError, match="16 bytes"):
            fa.check_rows_16b([x, bad])


def test_zero_length_causal_row_follows_the_reference_not_pallas_tiles():
    """A ``kv_len = 0`` row under ``causal=True``: the Pallas kernels
    average V over the keys of the kv tiles up to their causal tile
    limit (a set that depends on the tile size); ``reference_attention``
    and the port average over all S keys. The row is padding (its output
    is unspecified), so the port keeps the reference's rule; the live row
    beside it agrees with both."""
    q, k, v, _ = _np_qkv(seed=3)
    lens = np.asarray([0, 37], np.int32)
    jl = jnp.asarray(lens)
    pallas = np.asarray(jatt.flash_attention(*_jax(q, k, v), True, 16, 16,
                                             None, True, jl))
    ref = np.asarray(jatt.reference_attention(*_jax(q, k, v), causal=True,
                                              kv_len=jl))
    got = fa.flash_fwd(*_torch(q, k, v), causal=True,
                       kv_len=torch.from_numpy(lens))[0].numpy()
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1, :37], ref[1, :37], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pallas[1, :37], ref[1, :37], atol=1e-5, rtol=0)
    gap = np.abs(pallas[0] - ref[0]).max()
    assert gap > 0.1, f"the Pallas zero row now matches the reference ({gap})"
    print(f"kv_len=0 causal row, S=64, tiles 16: Pallas vs reference max "
          f"abs {gap:.4f}")


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd",
                                     "flash_bwd_dq", "flash_bwd_dkv"])
def test_every_kernel_wrapper_asks_for_16_byte_rows(monkeypatch, wrapper):
    """All the bf16 kernels stage rows with 16-byte copies, so each wrapper
    hands its launch arguments to ``_cuda_args`` with ``rows_16b``
    (checked on ``meta`` tensors, which take the kernel branch here)."""
    seen = {}

    class _Stop(Exception):
        pass

    def fake(q, tensors, kv_len, rows_16b=False):
        seen["rows_16b"] = rows_16b
        raise _Stop

    monkeypatch.setattr(fa, "_cuda_args", fake)
    q, k, v, g = (torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16,
                              device="meta") for _ in range(4))
    stats = torch.zeros(1, 2, 8, device="meta")
    args = (q, k, v) if wrapper == "flash_fwd" else (q, k, v, g, stats,
                                                     stats)
    with pytest.raises(_Stop):
        getattr(fa, wrapper)(*args)
    assert seen == {"rows_16b": True}
