"""Port paged decode attention against the JAX Pallas kernel.

The port's plain version (the one CPU tensors take) is held against
``kubeflow_tpu.ops.paged_attention.paged_decode_attention`` run through
the Pallas interpreter, as the JAX package's own tests run it: same
seeded inputs, ragged positions, sentinel and causally-dead pages, an
all-sentinel row; f32 within 1e-5. The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda_kernels.py`` and,
at the serving shapes, by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged,
)
from kubeflow_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)
ATOL = 1e-5


def _inputs(QH, KH, *, B=5, Dh=16, ps=8, n_log=6, P=20, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, QH, Dh)).astype(np.float32)
    k = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    v = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    pages = np.full((B, n_log), P, np.int32)
    pages[0, :3] = perm[:3]                 # 2 full pages + a partial
    pages[1, 0] = perm[3]                   # a single token
    pages[2, :] = perm[4:4 + n_log]         # full context
    pages[3, :5] = perm[10:15]              # dead pages left mapped
    # row 4: idle/disarmed, all sentinel
    positions = np.asarray([19, 0, n_log * ps - 1, 13, n_log * ps],
                           np.int32)
    return q, k, v, pages, positions


def _both(q, k, v, pages, positions):
    want = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pages),
                                jnp.asarray(positions), interpret=True))
    got = pa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pages, positions)))
    return got.numpy(), want


@pytest.mark.parametrize("QH,KH,Dh", [
    pytest.param(4, 4, 16, id="4-4"), pytest.param(4, 2, 16, id="4-2"),
    pytest.param(8, 2, 16, id="8-2"),
    # a Llama-style GQA group of 16 (the kernel takes it in blocks of 8),
    # and a head dim that is not 16 bytes x a power of two
    pytest.param(32, 2, 16, id="32-2"), pytest.param(8, 2, 96, id="8-2-Dh96")])
def test_plain_matches_jax_kernel(QH, KH, Dh):
    got, want = _both(*_inputs(QH, KH, Dh=Dh, seed=QH + KH))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[4] == 0).all()              # all-sentinel row: zeros


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_kernel_random_tables(seed):
    """Random page maps and positions over a shared pool (the engine's
    shapes: each row maps distinct pages up to its causal frontier)."""
    rng = np.random.default_rng(100 + seed)
    B, QH, KH, Dh, ps, n_log = 6, 8, 2, 16, 4, 8
    P = B * n_log
    q = rng.normal(size=(B, QH, Dh)).astype(np.float32)
    k = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    v = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    pages = rng.permutation(P).astype(np.int32).reshape(B, n_log)
    positions = rng.integers(0, n_log * ps, size=B).astype(np.int32)
    for b in range(0, B, 2):
        pages[b, positions[b] // ps + 1:] = P
    got, want = _both(q, k, v, pages, positions)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_is_the_gather_core_where_the_contract_holds():
    """With sentinels only past each row's frontier, the plain version is
    exactly the transformer's gather math at S == 1."""
    from kubeflow_tpu_torch.ops.attention import NEG_INF, gqa_repeat

    q, k, v, pages, positions = (torch.from_numpy(a)
                                 for a in _inputs(4, 2, seed=7))
    q, pages, positions = q[:4], pages[:4], positions[:4]
    B, QH, Dh = q.shape
    P, ps, KH, _ = k.shape
    T = pages.shape[1] * ps
    idx = pages.long().clamp(max=P - 1)
    kc, vc = gqa_repeat(q[:, None], k[idx].reshape(B, T, KH, Dh),
                        v[idx].reshape(B, T, KH, Dh))
    s = torch.einsum("bshd,bthd->bhst", q[:, None], kc).float() * Dh ** -0.5
    mask = torch.arange(T)[None, None, :] <= positions[:, None, None]
    s = s.masked_fill(~mask[:, None], NEG_INF)
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vc)[:, 0]
    got = pa.paged_decode_attention_plain(q, k, v, pages, positions)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = pa.launches["paged_decode_attention"]
    q, k, v, pages, positions = (torch.from_numpy(a)
                                 for a in _inputs(4, 2))
    got = pa.paged_decode_attention(q, k, v, pages, positions)
    want = pa.paged_decode_attention_plain(q, k, v, pages, positions)
    assert torch.equal(got, want)
    assert pa.launches["paged_decode_attention"] == before


def test_wrapper_checks_inputs():
    q, k, v, pages, positions = (torch.from_numpy(a)
                                 for a in _inputs(4, 2))
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attention(q, k, v, pages.long(), positions)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode_attention(q, k.double(), v, pages, positions)
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_decode_attention(q[:, :3], k, v, pages, positions)
    with pytest.raises(ValueError, match="positions"):
        pa.paged_decode_attention(q, k, v, pages, positions[:2])


def test_fold_scratch_is_kept_per_device_zeroed_and_grown():
    """The fused fold's counters and workspace (``device_scratch``): one
    pair per device, kept between calls, reused while large enough, and
    replaced by larger ones (counters zeroed) when a call needs more."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    try:
        counters, ws = pa.device_scratch(cpu, 8, 100)
        assert counters.dtype == torch.int32 and ws.dtype == torch.float32
        assert counters.numel() == 8 and ws.numel() == 100
        assert int(counters.abs().sum()) == 0
        same = pa.device_scratch(cpu, 4, 50)
        assert same[0] is counters and same[1] is ws
        counters[0] = 3                  # a fold left mid-way, say
        grown, ws2 = pa.device_scratch(cpu, 16, 60)
        assert grown is not counters and grown.numel() == 16
        assert int(grown.abs().sum()) == 0 and ws2 is ws
        assert pa.device_scratch(cpu, 0, 0)[0] is grown
        other, _ = pa.device_scratch(meta, 2, 2)   # another device's own
        assert other.device == meta and other.numel() == 2
        assert pa.device_scratch(cpu, 0, 0)[0] is grown
    finally:
        for dev in (cpu, meta):
            pa._scratch.pop((dev.type, dev.index), None)
