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

from kubeflow_tpu_torch.ops import attention as att
from kubeflow_tpu_torch.ops import bnconv as bc
from kubeflow_tpu_torch.ops import flash_attention as fa
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


def _paged_serving_inputs(QH, KH, *, B=8, Dh=64, ps=64, n_log=32, seed=1):
    """Rows at serving lengths (positions 251-363, as the chip smoke's
    serving phase): each row's pages up to its frontier mapped from a
    shuffled pool, the rest the sentinel."""
    rng = np.random.default_rng(seed)
    P = B * n_log
    q = rng.normal(size=(B, QH, Dh)).astype(np.float32)
    k = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    v = rng.normal(size=(P, ps, KH, Dh)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    positions = rng.integers(251, 364, size=B).astype(np.int32)
    pages = np.full((B, n_log), P, np.int32)
    for b in range(B):
        n = int(positions[b]) // ps + 1
        pages[b, :n] = perm[b * n_log:b * n_log + n]
    return q, k, v, pages, positions


def _paged_case(cuda, inputs, dtype):
    q, k, v, pages, positions = (torch.from_numpy(a).to(cuda)
                                 for a in inputs)
    return q.to(dtype), k.to(dtype), v.to(dtype), pages, positions


@pytest.mark.parametrize("shape,QH,KH", [("ragged", 8, 2),
                                         ("ragged", 16, 16),
                                         ("ragged", 16, 2),
                                         ("serving", 16, 16),
                                         ("serving", 16, 2)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 8e-3)])
def test_paged_kernel_matches_plain(cuda, shape, QH, KH, dtype, atol):
    """One launch a call against the plain version: ragged rows with an
    all-sentinel row (zeros), and rows at serving lengths; GQA groups of
    4 and of 8 (the kernel's largest)."""
    make = _paged_inputs if shape == "ragged" else _paged_serving_inputs
    q, k, v, pages, positions = _paged_case(cuda, make(QH, KH), dtype)
    before = pa.launches["paged_decode_attention"]
    got = pa.paged_decode_attention(q, k, v, pages, positions)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_plain(q, k, v, pages, positions)
    assert pa.launches["paged_decode_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    if shape == "ragged":
        assert (got[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_repeats_bit_for_bit_and_resets_its_counters(cuda,
                                                                  dtype):
    """The fused fold sums the splits in split order, whichever split
    finishes last, and the last split of each (row, KV head) leaves its
    counter at zero for the next call: repeat calls, also at another
    split size (other grids over the same counters), are bit-identical."""
    q, k, v, pages, positions = _paged_case(
        cuda, _paged_serving_inputs(16, 4, seed=2), dtype)
    runs = [pa.paged_decode_attention(q, k, v, pages, positions)
            for _ in range(3)]
    torch.cuda.synchronize()
    counters, _ = pa.device_scratch(q.device, 0, 0)
    assert int(counters.abs().sum()) == 0
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    default = pa._SPLIT_TOKENS
    try:
        pa._SPLIT_TOKENS = 64
        other = pa.paged_decode_attention(q, k, v, pages, positions)
    finally:
        pa._SPLIT_TOKENS = default
    again = pa.paged_decode_attention(q, k, v, pages, positions)
    torch.cuda.synchronize()
    assert int(counters.abs().sum()) == 0
    assert torch.equal(again, runs[0])
    torch.testing.assert_close(other.float(), runs[0].float(),
                               atol=1e-5 if dtype == torch.float32 else 8e-3,
                               rtol=0)


@pytest.mark.parametrize("QH,KH,Dh,dtype,atol", [
    (32, 2, 64, torch.bfloat16, 8e-3), (32, 2, 64, torch.float32, 1e-5),
    (8, 2, 96, torch.bfloat16, 8e-3), (8, 2, 96, torch.float32, 1e-5),
    (4, 4, 256, torch.float32, 1e-5), (4, 4, 256, torch.bfloat16, 8e-3)])
def test_paged_kernel_takes_any_group_and_head_dim(cuda, QH, KH, Dh, dtype,
                                                   atol):
    """A GQA group of 16 (two blocks of 8 q heads, each re-reading the KV
    head's pages), Dh = 96 (12 chunks on 16 lanes, 4 idle) and Dh = 256
    (two 16-byte slices a lane at f32): one launch against the plain
    version, repeat calls bit-identical, counters back at zero."""
    q, k, v, pages, positions = _paged_case(
        cuda, _paged_inputs(QH, KH, Dh=Dh, seed=QH + Dh), dtype)
    before = pa.launches["paged_decode_attention"]
    got = pa.paged_decode_attention(q, k, v, pages, positions)
    again = pa.paged_decode_attention(q, k, v, pages, positions)
    torch.cuda.synchronize()
    assert pa.launches["paged_decode_attention"] == before + 2
    want = pa.paged_decode_attention_plain(q, k, v, pages, positions)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(got, again) and (got[-1] == 0).all()
    counters, _ = pa.device_scratch(q.device, 0, 0)
    assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("kv", [slice(1, 2), slice(2, 4)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 8e-3)])
def test_paged_kernel_reads_a_slice_of_the_pools_kv_heads(cuda, kv, dtype,
                                                          atol):
    """A rank whose q heads map to some of a replicated pool's kv heads
    hands the kernel ``pool[:, :, a:b]`` in place: it matches the plain
    version on a contiguous copy of that slice; a pool laid out token
    by token across its pages is refused."""
    n = kv.stop - kv.start
    q, k, v, pages, positions = _paged_case(
        cuda, _paged_serving_inputs(2 * n, 4, seed=5), dtype)
    ks, vs = k[:, :, kv], v[:, :, kv]
    assert not ks.is_contiguous()
    got = pa.paged_decode_attention(q, ks, vs, pages, positions)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_plain(q, ks.contiguous(),
                                           vs.contiguous(), pages, positions)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    # token-major: a page's keys are not one block of the pool
    kt, vt = (t.transpose(0, 1).contiguous().transpose(0, 1)
              for t in (ks, vs))
    with pytest.raises(ValueError, match="slice of its kv heads"):
        pa.paged_decode_attention(q, kt, vt, pages, positions)


def test_sampler_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((3.0 * rng.normal(size=(8, 32000)))
                              .astype(np.float32)).to(cuda)
    args = (torch.tensor(TEMPS, device=cuda),
            torch.tensor(TOPK, dtype=torch.int32, device=cuda),
            torch.tensor(TOPP, device=cuda))
    for step in range(3):
        g = sm.gumbel_noise(range(8), [step] * 8, 32000, device=cuda)
        before = sm.launches["fused_sample"]
        got = sm.fused_sample(logits, g, *args)
        torch.cuda.synchronize()
        assert sm.launches["fused_sample"] == before + 1
        assert torch.equal(got, sm.fused_sample_plain(logits, g, *args))


def test_sampler_kernel_past_the_shared_memory_row(cuda):
    """V = 128,256 (Llama-3), past one block's shared memory: each of the
    row's 8 cluster CTAs holds a 64 KB slice; token-identical to the
    plain version on the same noise."""
    V = 128256
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((3.0 * rng.normal(size=(8, V)))
                              .astype(np.float32)).to(cuda)
    args = (torch.tensor(TEMPS, device=cuda),
            torch.tensor(TOPK, dtype=torch.int32, device=cuda),
            torch.tensor(TOPP, device=cuda))
    for step in range(2):
        g = sm.gumbel_noise(range(8), [step] * 8, V, device=cuda)
        before = sm.launches["fused_sample"]
        got = sm.fused_sample(logits, g, *args)
        torch.cuda.synchronize()
        assert sm.launches["fused_sample"] == before + 1
        assert torch.equal(got, sm.fused_sample_plain(logits, g, *args))


def _sampler_case(cuda, logits, temp, top_k, top_p):
    return (torch.from_numpy(np.ascontiguousarray(logits)).to(cuda),
            torch.from_numpy(temp).to(cuda),
            torch.from_numpy(top_k).to(cuda),
            torch.from_numpy(top_p).to(cuda))


def _hold_sampler(logits, args, noise):
    before = sm.launches["fused_sample"]
    got = sm.fused_sample(logits, noise, *args)
    torch.cuda.synchronize()
    assert sm.launches["fused_sample"] == before + 1
    want = sm.fused_sample_plain(logits, noise, *args)
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    return got


@pytest.mark.parametrize("V", [64, 32000, 128256])
def test_sampler_kernel_holds_the_adversarial_rows(cuda, V):
    """The shared adversarial rows (``tests/sampler_rows.py``) all at once
    and each alone (B = 1): token-identical to the plain version on two
    Gumbel draws, and on spike probes (noise at one index alone) at the
    first support indices of the float64 oracle and at random others."""
    from sampler_rows import adversarial_rows, oracle_support

    names, logits, temp, top_k, top_p = adversarial_rows(V, seed=3)
    x, *args = _sampler_case(cuda, logits, temp, top_k, top_p)
    gen = torch.Generator(device="cpu").manual_seed(V)
    for _ in range(2):
        u = torch.rand(x.shape, generator=gen).clamp_min(1e-20)
        noise = (-torch.log(-torch.log(u))).to(cuda)
        _hold_sampler(x, args, noise)
        for r in range(len(names)):
            _hold_sampler(x[r:r + 1], [a[r:r + 1] for a in args],
                          noise[r:r + 1])
    rng = np.random.default_rng(V)
    rows, at = [], []
    for r in range(len(names)):
        sup = oracle_support(logits[r], temp[r], top_k[r], top_p[r])
        for j in [*sup[:8], *rng.integers(0, V, size=8)]:
            rows.append(r)
            at.append(int(j))
    rows = torch.tensor(rows, device=cuda)
    spikes = torch.zeros((len(at), V), device=cuda)
    spikes[torch.arange(len(at)), torch.tensor(at)] = 1e5
    _hold_sampler(x[rows].contiguous(), [a[rows].contiguous() for a in args],
                  spikes)


def test_sampler_kernel_past_the_clusters_shared_memory(cuda):
    """A row past 8 x a block's shared memory (V = 2^19 + 3, B = 2) keeps
    its slices in the device-memory workspace; the same passes, the same
    tokens as the plain version."""
    from sampler_rows import adversarial_rows

    V = 2 ** 19 + 3
    names, logits, temp, top_k, top_p = adversarial_rows(V, seed=4)
    pick = [names.index("ties_straddle_k_top_p"),
            names.index("masked_tail_top_p")]
    x, *args = _sampler_case(cuda, logits[pick], temp[pick], top_k[pick],
                             top_p[pick])
    sm.fused_sample(x[:1, :64].contiguous(), torch.zeros_like(x[:1, :64]),
                    *[a[:1] for a in args])
    assert sm._max_vocab[torch.cuda.current_device()] < V
    for step in range(2):
        _hold_sampler(x, args, sm.gumbel_noise([1, 2], [step] * 2, V,
                                               device=cuda))


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
        paged0 = pa.launches["paged_decode_attention"]
        sampler0 = sm.launches["fused_sample"]
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        sampled = eng.submit([1, 2, 3], max_new=6, temperature=0.9,
                             top_k=20, top_p=0.9, seed=3)
        while eng.active_count or eng.pending_count:
            eng.run_once(timeout=0.01)
        streams[impl] = [r.result() for r in reqs]
        assert len(sampled.result()) == 6
        assert ((pa.launches["paged_decode_attention"] > paged0)
                == (impl == "kernel"))
        assert sm.launches["fused_sample"] > sampler0
        eng.close()
        eng._pool.check_idle()
    assert streams["kernel"] == streams["gather"]


def test_dense_engine_fused_sampler_matches_plain(cuda, monkeypatch):
    """The dense engine with ``sampler_impl="fused"`` on the card: the
    sampler kernel launches at the row prefill, the burst's batch
    prefill and every sampled step, never the paged kernel, and the
    tokens are those of the same engine with the sampler's plain
    version swapped in (the same noise: the engine draws it from each
    row's ``(seed, step)``)."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import tiny_config
    from kubeflow_tpu_torch.serving import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_config()
    model = convert.to_module(cfg, convert.random_params(cfg, 0),
                              device=cuda)
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)

    def run():
        eng = engine_mod.DecodeEngine(cfg, model, slots=4,
                                      steps_per_sync=3,
                                      sampler_impl="fused",
                                      autostart=False, device=cuda)
        assert not eng.paged
        burst = [eng.submit([3 + i, 2, 9], max_new=10, seed=i, **kw)
                 for i in range(3)]
        while eng.active_count or eng.pending_count:
            eng.run_once(timeout=0.01)
        row = eng.submit([5, 11, 17, 4, 4], max_new=7, seed=9, **kw)
        greedy = eng.submit([1, 2], max_new=7)
        while eng.active_count or eng.pending_count:
            eng.run_once(timeout=0.01)
        assert eng.batch_prefills == 1
        return [r.result() for r in burst + [row, greedy]]

    paged0 = pa.launches["paged_decode_attention"]
    sampler0 = sm.launches["fused_sample"]
    got = run()
    torch.cuda.synchronize()
    assert sm.launches["fused_sample"] - sampler0 >= 1 + 1 + 3
    assert pa.launches["paged_decode_attention"] == paged0
    monkeypatch.setattr(engine_mod, "fused_sample", sm.fused_sample_plain)
    sampler0 = sm.launches["fused_sample"]
    want = run()
    assert sm.launches["fused_sample"] == sampler0
    assert got == want
    assert all(0 <= t < cfg.vocab_size for row in got for t in row)


def _flash_inputs(cuda, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, S, 4, D))
                                   .astype(np.float32)).to(cuda, dtype)
                  for _ in range(4))
    return q, k, v, g


@pytest.mark.parametrize("S,D", [(256, 64), (200, 128), (1000, 64),
                                 (512, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, S, D, causal, masked, dtype):
    """Forward (out, lse), dQ and dK/dV against their plain versions on
    the same inputs: lse within 1e-5; f32 within 1e-5 (out) and 1e-4
    (gradients); bf16 within a norm-relative error of 4e-4, the limit of
    ``chip_smoke.py`` (one bf16 fault such as P left unrounded reads
    ~2e-3). ``kv_len`` holds a zero row; S = 1000 has a ragged last
    tile; D = 128 runs the bf16 kernels' shared-memory K/V variant."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda, S, D, dtype, seed=S + D)
    lens = (torch.tensor([0, S - 37], dtype=torch.int32, device=cuda)
            if masked else None)
    kw = dict(causal=causal, kv_len=lens)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(g, out)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in before)
    want = (*fa.flash_fwd_plain(q, k, v, **kw),
            fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    atols = (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)
    for name, got, ref, atol in zip(("out", "lse", "dq", "dk", "dv"),
                                    (out, lse, dq, dk, dv), want, atols):
        got, ref = got.float(), ref.float()
        assert torch.isfinite(got).all(), name
        if dtype == torch.bfloat16 and name != "lse":   # lse is f32
            rel = ((got - ref).norm() / ref.norm()).item()
            assert rel <= 4e-4, f"{name}: norm err {rel} > 4e-4"
        else:
            err = (got - ref).abs().max().item()
            assert err <= atol, f"{name}: {err} > {atol}"


def _hold_head_dim(cuda, D, dtype, S=200):
    """Each pass at head dim D (causal, a zero and a ragged ``kv_len``)
    launches its kernel once and matches its plain version at the limits
    of ``test_flash_kernels_match_plain``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda, S, D, dtype, seed=D)
    lens = torch.tensor([0, S - 37], dtype=torch.int32, device=cuda)
    kw = dict(causal=True, kv_len=lens)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(g, out)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in before)
    want = (*fa.flash_fwd_plain(q, k, v, **kw),
            fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    atols = (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)
    for name, got, ref, atol in zip(("out", "lse", "dq", "dk", "dv"),
                                    (out, lse, dq, dk, dv), want, atols):
        assert got.shape == ref.shape, name
        got, ref = got.float(), ref.float()
        assert torch.isfinite(got).all(), name
        if dtype == torch.bfloat16 and name != "lse":
            rel = ((got - ref).norm() / ref.norm()).item()
            assert rel <= 4e-4, f"{name}: norm err {rel} > 4e-4"
        else:
            err = (got - ref).abs().max().item()
            assert err <= atol, f"{name}: {err} > {atol}"


@pytest.mark.parametrize("D", [32, 80, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_every_head_dim_to_256(cuda, D, dtype):
    """Head dims the kernels are not built for run zero-padded to the
    next built one (64, 128, 256) and sliced back; D = 256 runs its own
    build (the FMA kernels, also for bf16)."""
    _hold_head_dim(cuda, D, dtype)


@pytest.mark.parametrize("D", [320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_head_dims_past_256(cuda, D, dtype):
    """Past 256 the wide FMA kernels run (scores summed over 64-wide
    slices of D, 256 output columns a block; 512 takes two blocks of
    columns), for f32 and bf16 alike."""
    _hold_head_dim(cuda, D, dtype)


def test_flash_attention_grads_match_dense(cuda):
    """The autograd function on the card against autodiff through the
    dense oracle (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda, 300, 64, torch.float32, seed=9)
    grads = []
    for fn in (att.flash_attention, att.reference_attention):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*x) * g).sum().backward()
        grads.append([t.grad for t in x])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_flash_kernels_read_strides_and_refuse_what_they_lack(cuda):
    """q/k/v/dO read through their (B, S, H, D) strides give the
    contiguous result bit for bit; a head dim past 256 launches (the wide
    kernels) and an unsupported dtype raises instead of launching."""
    q, k, v, g = _flash_inputs(cuda, 130, 64, torch.bfloat16, seed=11)
    strided = [t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v, g)]
    assert not strided[0].is_contiguous()
    got = [fa.flash_fwd(*strided[:3])]
    want = [fa.flash_fwd(q, k, v)]
    for res, (a, b, c, d) in ((got, strided), (want, (q, k, v, g))):
        out, lse = res[0]
        delta = fa.flash_delta(d, out)
        res += [fa.flash_bwd_dq(a, b, c, d, lse, delta),
                *fa.flash_bwd_dkv(a, b, c, d, lse, delta)]
    torch.cuda.synchronize()
    for a, b in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        assert torch.equal(a, b)
    q32, k32, v32, _ = _flash_inputs(cuda, 64, 320, torch.float32, seed=12)
    launched = dict(fa.launches)
    out32, _ = fa.flash_fwd(q32, k32, v32)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == launched["flash_fwd"] + 1
    assert torch.allclose(out32, fa.flash_fwd_plain(q32, k32, v32)[0],
                          atol=1e-5, rtol=0)
    launched = dict(fa.launches)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q.half(), k.half(), v.half())
    assert fa.launches == launched


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_kernels_are_deterministic(cuda, D):
    """Two calls of the bf16 forward, dQ and dK/dV on the same inputs
    give bit-identical outputs: each output tile is owned by one block,
    with no atomics."""
    q, k, v, g = _flash_inputs(cuda, 1000, D, torch.bfloat16, seed=13)
    lens = torch.tensor([0, 963], dtype=torch.int32, device=cuda)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v, kv_len=lens)
        delta = fa.flash_delta(g, out)
        runs.append((out, lse,
                     fa.flash_bwd_dq(q, k, v, g, lse, delta, kv_len=lens),
                     *fa.flash_bwd_dkv(q, k, v, g, lse, delta,
                                       kv_len=lens)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_bf16_kernels_refuse_rows_off_16_bytes(cuda):
    """The bf16 forward, dQ and dK/dV stage rows with 16-byte copies: a
    view whose base address or row stride is not a multiple of 16 bytes
    raises instead of launching; f32 inputs, read by the FMA kernels,
    take such a view."""
    B, S, H, D = 2, 130, 4, 64
    q, k, v, g = _flash_inputs(cuda, S, D, torch.bfloat16, seed=14)
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(g, out)
    flat = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(B, S, H, D)      # base 2 bytes off
    shifted.copy_(q)
    wide = torch.zeros(B, S, H, D + 4, dtype=torch.bfloat16, device=cuda)
    odd_stride = wide[..., :D]               # rows 136 bytes apart
    odd_stride.copy_(q)
    for bad in (shifted, odd_stride):
        launched = dict(fa.launches)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_fwd(bad, k, v)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_bwd_dq(bad, k, v, g, lse, delta)
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_bwd_dkv(bad, k, v, g, lse, delta)
        assert fa.launches == launched
    wide32 = torch.zeros(B, S, H, D + 1, device=cuda)
    wide32[..., :D].copy_(q.float())
    want = fa.flash_fwd(q.float(), k.float(), v.float())[0]
    got = fa.flash_fwd(wide32[..., :D], k.float(), v.float())[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _bnconv_inputs(cuda, M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0, dt=dtype):
        arr = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
        return torch.from_numpy(arr).to(cuda, dt)
    return (t((M, K)), t((K,), 0.3, 1.0, torch.float32),
            t((K,), 0.3, -0.1, torch.float32), t((K, N), K ** -0.5),
            t((M, N)))


def _norm_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("M,K,N", [(4096, 64, 256), (300, 512, 2048),
                                   (1000, 72, 200), (77, 20, 40)])
@pytest.mark.parametrize("dtype,act", [(torch.bfloat16, None),
                                       (torch.float32, None),
                                       (torch.float32, torch.bfloat16)],
                         ids=["bf16", "f32", "f32_act_bf16"])
def test_bnconv_kernels_match_plain(cuda, M, K, N, dtype, act):
    """The forward and dW kernels against their plain versions (TF32
    off): bf16 outputs within a norm-relative 4e-4 and f32 within 1e-5,
    the limits of ``chip_smoke.py`` (a bf16 fault such as y left
    unrounded reads ~2.5e-3); ragged shapes and the tensor-core and FMA
    paths both; dW in f32 and in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, a, b, w, dz = _bnconv_inputs(cuda, M, K, N, dtype, seed=M + K + N)
    before = dict(bc.launches)
    out = bc.bnconv_fwd(x, a, b, w, act)
    dw32 = bc.bnconv_dw(x, a, b, dz, act)
    dw16 = bc.bnconv_dw(x, a, b, dz, act, torch.bfloat16)
    torch.cuda.synchronize()
    assert bc.launches["bnconv_fwd"] == before["bnconv_fwd"] + 1
    assert bc.launches["bnconv_dw"] == before["bnconv_dw"] + 2
    assert out.dtype == dtype and dw32.dtype == torch.float32
    for got, want in ((out, bc.bnconv_fwd_plain(x, a, b, w, act)),
                      (dw32, bc.bnconv_dw_plain(x, a, b, dz, act)),
                      (dw16, bc.bnconv_dw_plain(x, a, b, dz, act,
                                                torch.bfloat16))):
        assert torch.isfinite(got.float()).all()
        limit = 4e-4 if got.dtype == torch.bfloat16 else 1e-5
        assert _norm_err(got, want) <= limit


@pytest.mark.parametrize("M,K,N", [(8192, 64, 256), (77, 20, 40),
                                   (1000, 72, 200)])
def test_bnconv_kernels_repeat_bit_for_bit(cuda, M, K, N):
    """The bf16 wgmma forward and dW: repeat calls give bit-identical
    outputs (each output tile is owned by one block; dW's splits are
    folded in split order, with no atomics), at a K = 64 site shape with
    a reduced M and at ragged shapes (padded to 16-byte rows)."""
    x, a, b, w, dz = _bnconv_inputs(cuda, M, K, N, torch.bfloat16, 7)
    before = dict(bc.launches)
    outs = [bc.bnconv_fwd(x, a, b, w) for _ in range(2)]
    dws = [bc.bnconv_dw(x, a, b, dz, None, torch.bfloat16)
           for _ in range(2)]
    dw32 = [bc.bnconv_dw(x, a, b, dz) for _ in range(2)]
    torch.cuda.synchronize()
    assert bc.launches["bnconv_fwd"] == before["bnconv_fwd"] + 2
    assert bc.launches["bnconv_dw"] == before["bnconv_dw"] + 4
    for pair in (outs, dws, dw32):
        assert torch.equal(pair[0], pair[1])
    assert outs[0].shape == (M, N) and dws[0].shape == (K, N)


def test_bnconv_autograd_matches_the_plain_backward(cuda):
    """The autograd function on the card (kernel forward and dW) against
    the same backward with the plain dW: dx, da, db bit for bit, dW in
    bf16 within 4e-4."""
    x, a, b, w, dz = _bnconv_inputs(cuda, 2048, 128, 512, torch.bfloat16, 5)
    ins = [t.clone().requires_grad_(True) for t in (x, a, b, w)]
    got = torch.autograd.grad(bc.fused_scale_relu_matmul(*ins), ins, dz)
    want = bc.fused_vjp(x, a, b, w, dz, None, dw_fn=bc.bnconv_dw_plain)
    for g, r in zip(got[:3], want[:3]):
        assert torch.equal(g, r)
    assert got[3].dtype == torch.bfloat16
    assert _norm_err(got[3], want[3]) <= 4e-4


def test_bnconv_kernels_refuse_what_they_lack(cuda):
    x, a, b, w, dz = _bnconv_inputs(cuda, 256, 64, 128, torch.bfloat16, 6)
    with pytest.raises(ValueError, match="contiguous"):
        bc.bnconv_fwd(x.t().contiguous().t(), a, b, w)
    with pytest.raises(TypeError, match="dtype"):
        bc.bnconv_fwd(x.half(), a, b, w.half())
    with pytest.raises(TypeError, match="dtype"):
        bc.bnconv_dw(x, a, b, dz.float())
    with pytest.raises(TypeError, match="act_dtype"):
        bc.bnconv_fwd(x, a, b, w, torch.float16)


def test_resnet_fused_step_launches_and_matches_unfused(cuda):
    """One f32 step (TF32 off) of a small ResNet, fused and unfused from
    the same weights: the fused step launches both kernels at its two
    sites, and the loss, gradients and parameters agree within the
    limits of ``chip_smoke.py`` phase 8 (ReLU flips of near-zero
    elements move whole gradient entries)."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.train import (
        create_image_train_state,
        make_image_train_step,
        make_sgd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(stage_sizes=(1, 1), num_classes=10, width=32,
                dtype="float32", bn_dtype="float32")
    variables = convert.random_resnet_params(
        ResNetConfig(**base, fused_bn_conv=True), 8)
    flat = convert.flatten(variables)
    rng = np.random.default_rng(9)
    for key in flat:
        if key.endswith("bn3/scale"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(
                np.float32)
    variables = convert.unflatten(flat)
    images = torch.from_numpy(rng.standard_normal(
        (8, 64, 64, 3)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, 8)).to(cuda)
    out = {}
    for fused in (True, False):
        tree = variables if fused else convert.unfuse_bn_conv(variables)
        state = create_image_train_state(
            ResNetConfig(**base, fused_bn_conv=fused), tree,
            make_sgd(0.1, momentum=0.9), device=cuda)
        before = dict(bc.launches)
        state, m = make_image_train_step()(state, images, labels)
        torch.cuda.synchronize()
        n = bc.launches["bnconv_fwd"] - before["bnconv_fwd"]
        assert n == (2 if fused else 0)
        assert bc.launches["bnconv_dw"] - before["bnconv_dw"] == n
        tree = convert.resnet_variables(state.module)
        if fused:
            tree = convert.unfuse_bn_conv(tree)
        out[fused] = (float(m["loss"]), convert.flatten(tree))
    (lf, pf), (lu, pu) = out[True], out[False]
    assert abs(lf - lu) <= 1e-5
    for key, val in pu.items():
        assert np.abs(pf[key] - val).max() <= 1e-3, key
