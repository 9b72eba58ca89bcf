"""The port's CUDA kernels against their plain versions, on a card.

Every test here carries the ``gpu`` marker and skips without CUDA. The
file imports neither JAX nor ``kubeflow_tpu``, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports JAX, so
there run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import paged_attention as pa
from kubeflow_tpu_torch.ops import sampling as sm

pytestmark = pytest.mark.gpu

TEMPS = [0.0, 0.0, 0.8, 1.0, 0.7, 1.3, 1.0, 2.0]
TOPK = [0, 5, 7, 0, 20, 9, 0, 1]
TOPP = [1.0, 0.5, 1.0, 0.9, 0.8, 1.0, 1.0, 1.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _paged_inputs(QH, KH, *, B=5, Dh=64, ps=16, n_log=6, P=40, seed=0):
    """Ragged rows: partial pages, one token, a full row, dead pages left
    mapped, and an all-sentinel (disarmed) row."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, QH, Dh)).astype(np.float32)
    k = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    v = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    pages = np.full((B, n_log), P, np.int32)
    pages[0, :3] = perm[:3]
    pages[1, 0] = perm[3]
    pages[2, :] = perm[4:4 + n_log]
    pages[3, :5] = perm[10:15]
    positions = np.asarray([2 * ps + 3, 0, n_log * ps - 1, ps + 5,
                            n_log * ps], np.int32)
    return q, k, v, pages, positions


@pytest.mark.parametrize("QH,KH", [(8, 2), (16, 16)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 8e-3)])
def test_paged_kernel_matches_plain(cuda, QH, KH, dtype, atol):
    q, k, v, pages, positions = (torch.from_numpy(a).to(cuda)
                                 for a in _paged_inputs(QH, KH))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = pa.launches
    got = pa.paged_decode_attention(q, k, v, pages, positions)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_plain(q, k, v, pages, positions)
    assert pa.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[-1] == 0).all()


def test_sampler_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((3.0 * rng.normal(size=(8, 32000)))
                              .astype(np.float32)).to(cuda)
    args = (torch.tensor(TEMPS, device=cuda),
            torch.tensor(TOPK, dtype=torch.int32, device=cuda),
            torch.tensor(TOPP, device=cuda))
    for step in range(3):
        g = sm.gumbel_noise(range(8), [step] * 8, 32000, device=cuda)
        before = sm.launches
        got = sm.fused_sample(logits, g, *args)
        torch.cuda.synchronize()
        assert sm.launches == before + 1
        assert torch.equal(got, sm.fused_sample_plain(logits, g, *args))


def test_engine_kernel_and_gather_streams_match(cuda):
    """At f32 (TF32 off) the kernel engine's greedy streams are the
    gather engine's, and both kernels launch on the way."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import tiny_config
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config()
    model = convert.to_module(cfg, convert.random_params(cfg, 0),
                              device=cuda)
    prompts = [[5, 11, 17], [3, 2, 9, 23, 41, 8, 1, 30, 12], [7] * 20]
    streams = {}
    for impl in ("kernel", "gather"):
        eng = DecodeEngine(cfg, model, slots=4, paged=True,
                           paged_attention_impl=impl, sampler_impl="fused",
                           kv_page_size=8, prefill_chunk_tokens=8,
                           autostart=False, device=cuda)
        paged0, sampler0 = pa.launches, sm.launches
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        sampled = eng.submit([1, 2, 3], max_new=6, temperature=0.9,
                             top_k=20, top_p=0.9, seed=3)
        while eng.active_count or eng.pending_count:
            eng.run_once(timeout=0.01)
        streams[impl] = [r.result() for r in reqs]
        assert len(sampled.result()) == 6
        assert (pa.launches > paged0) == (impl == "kernel")
        assert sm.launches > sampler0
        eng.close()
        eng._pool.check_idle()
    assert streams["kernel"] == streams["gather"]
