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
from kubeflow_tpu_torch.ops import autotune
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
    # another split size: a tile-table row of 64 keys for every shape
    split = {"kernel": "paged_attn", "generation": "*", "dtype": "*",
             "split_tokens": 64}
    with autotune.table_override(autotune.TileTable([split], [])):
        other = pa.paged_decode_attention(q, k, v, pages, positions)
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


def _paged_long_inputs(QH, KH, *, B=8, ps=64, n_log=32, seed=3):
    """Ragged rows up to the whole context (the chip smoke's phase 2):
    a full row, rows with their dead pages unmapped, a row with a
    sentinel page inside its live range (skipped, its keys masked), and
    an all-sentinel row."""
    rng = np.random.default_rng(seed)
    P = B * n_log
    q = rng.normal(size=(B, QH, 64)).astype(np.float32)
    k = rng.normal(size=(P, ps, KH, 64)).astype(np.float32)
    v = rng.normal(size=(P, ps, KH, 64)).astype(np.float32)
    pages = rng.permutation(P).astype(np.int32).reshape(B, n_log)
    positions = rng.integers(0, n_log * ps, size=B).astype(np.int32)
    positions[0] = n_log * ps - 1
    positions[2] = max(int(positions[2]), 3 * ps)
    for b in range(1, B, 2):
        pages[b, positions[b] // ps + 1:] = P
    pages[2, 1] = P
    pages[-1], positions[-1] = P, n_log * ps
    return q, k, v, pages, positions


def _tma_case(cuda, inputs, kv=None):
    q, k, v, pages, positions = _paged_case(cuda, inputs, torch.bfloat16)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    return q, k, v, pages, positions


@pytest.mark.parametrize("case", ["ragged_p16", "serving", "long_16_16",
                                  "long_gqa_16_4", "long_p16", "long_p128",
                                  "long_p100", "slice", "slice_gqa"])
def test_paged_tma_route_matches_plain(cuda, case):
    """bf16 at Dh 64 and groups of at most 8 take ``paged_decode_tma``:
    rows taken whole (short rows) and cut into split_tokens ranges folded
    in split order (rows to the whole context), page sizes 16, 64, 100
    (a page in two pieces, the second box reading past the page) and 128,
    GQA 16/4, kv-head slices read in place; against the plain version
    within 8e-3 (two bf16 steps of an output below 1), repeat calls bit
    for bit, the all-sentinel row zeros, the fold counters back at 0."""
    inputs = {
        "ragged_p16": lambda: _paged_inputs(16, 16),
        "serving": lambda: _paged_serving_inputs(16, 16),
        "long_16_16": lambda: _paged_long_inputs(16, 16),
        "long_gqa_16_4": lambda: _paged_long_inputs(16, 4),
        "long_p16": lambda: _paged_long_inputs(8, 2, ps=16, n_log=128),
        "long_p128": lambda: _paged_long_inputs(8, 8, ps=128, n_log=16),
        "long_p100": lambda: _paged_long_inputs(4, 4, ps=100, n_log=20),
        "slice": lambda: _paged_serving_inputs(16, 4, seed=6),
        "slice_gqa": lambda: _paged_long_inputs(16, 4, seed=7),
    }[case]()
    kv = {"slice": slice(1, 2), "slice_gqa": slice(2, 4)}.get(case)
    q, k, v, pages, positions = _tma_case(cuda, inputs, kv)
    if kv is not None:  # the q heads of those kv heads (group 4)
        q = q[:, 4 * kv.start:4 * kv.stop].contiguous()
    before = dict(pa.launches)
    got = pa.paged_decode_attention(q, k, v, pages, positions)
    again = pa.paged_decode_attention(q, k, v, pages, positions)
    torch.cuda.synchronize()
    assert pa.launches["paged_decode_tma"] == before["paged_decode_tma"] + 2
    assert (pa.launches["paged_decode_attention"]
            == before["paged_decode_attention"] + 2)
    want = pa.paged_decode_attention_plain(q, k.contiguous(), v.contiguous(),
                                           pages, positions)
    torch.testing.assert_close(got.float(), want.float(), atol=8e-3, rtol=0)
    assert torch.equal(got, again)
    dead = positions.cpu().numpy() < 0
    for b, row in enumerate(pages.cpu().numpy()):
        if (row == k.shape[0]).all() or dead[b]:
            assert (got[b] == 0).all()
    counters, _ = pa.device_scratch(q.device, 0, 0)
    assert int(counters.abs().sum()) == 0


def test_paged_tma_route_at_other_splits_and_grids(cuda, monkeypatch):
    """The long rows at another split (64 keys: more ranges to fold) and
    on grids of 1 and 7 blocks (each block walking many units, the ring
    running on across them; one block takes the rows whole): the same
    answer within 8e-3, each bit for bit on a repeat call."""
    q, k, v, pages, positions = _tma_case(cuda, _paged_long_inputs(16, 4))
    want = pa.paged_decode_attention_plain(q, k, v, pages, positions)
    split = {"kernel": "paged_attn", "generation": "*", "dtype": "*",
             "split_tokens": 64}
    for grid in (None, 1, 7):
        if grid is not None:
            monkeypatch.setattr(pa, "_sm_count", lambda index, g=grid: g)
        with autotune.table_override(autotune.TileTable([split], [])):
            got = pa.paged_decode_attention(q, k, v, pages, positions)
            again = pa.paged_decode_attention(q, k, v, pages, positions)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=8e-3,
                                   rtol=0)
        assert torch.equal(got, again)
    counters, _ = pa.device_scratch(q.device, 0, 0)
    assert int(counters.abs().sum()) == 0


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


def _launched_once(before, q):
    """The forward and one backward launched: the fused kernel at bf16
    and D <= 64, else the dQ and the dK/dV kernels."""
    bwd = (("flash_bwd",) if fa.fused_backward(q)
           else ("flash_bwd_dq", "flash_bwd_dkv"))
    want = dict(before)
    for name in ("flash_fwd",) + bwd:
        want[name] += 1
    return fa.launches == want


@pytest.mark.parametrize("S,D", [(256, 64), (200, 128), (1000, 64),
                                 (512, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, S, D, causal, masked, dtype):
    """Forward (out, lse) and the backward (dQ, dK, dV) against their
    plain versions on the same inputs: lse within 1e-5; f32 within 1e-5
    (out) and 1e-4 (gradients); bf16 within a norm-relative error of
    4e-4, the limit of ``chip_smoke.py`` (one bf16 fault such as P left
    unrounded reads ~2e-3). ``kv_len`` holds a zero row; S = 1000 has a
    ragged last tile; D = 128 runs the bf16 kernels' shared-memory K/V
    variant."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda, S, D, dtype, seed=S + D)
    lens = (torch.tensor([0, S - 37], dtype=torch.int32, device=cuda)
            if masked else None)
    kw = dict(causal=causal, kv_len=lens)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(g, out)
    dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert _launched_once(before, q)
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
    """The forward and the backward at head dim D (causal, a zero and a
    ragged ``kv_len``) launch their kernels once each and match their
    plain versions at the limits of ``test_flash_kernels_match_plain``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _flash_inputs(cuda, S, D, dtype, seed=D)
    lens = torch.tensor([0, S - 37], dtype=torch.int32, device=cuda)
    kw = dict(causal=True, kv_len=lens)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(g, out)
    dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert _launched_once(before, q)
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
        res += [*fa.flash_bwd(a, b, c, d, lse, delta)]
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
    """Two calls of the bf16 forward and backward on the same inputs give
    bit-identical outputs: each output tile is owned by one block, but
    the fused backward's dQ, whose partials land in a fixed order."""
    q, k, v, g = _flash_inputs(cuda, 1000, D, torch.bfloat16, seed=13)
    lens = torch.tensor([0, 963], dtype=torch.int32, device=cuda)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v, kv_len=lens)
        delta = fa.flash_delta(g, out)
        runs.append((out, lse,
                     *fa.flash_bwd(q, k, v, g, lse, delta, kv_len=lens)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _hold_bwd(q, k, v, g, *, causal, kv_len=None, heads=None):
    """dQ, dK and dV of the fused kernel (one launch) from the kernel
    forward's lse against their plain versions at the bf16
    norm-relative limit (4e-4), the plain versions ``heads`` heads a
    call (all at once by default: they hold (B, H, S, S) f32 scores);
    returns the kernel outputs (dq, dk, dv) and each output's
    reading."""
    kw = dict(causal=causal, kv_len=kv_len)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(g, out)
    before = dict(fa.launches)
    got = fa.flash_bwd(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.launches == dict(before, flash_bwd=before["flash_bwd"] + 1)
    step = heads or q.shape[2]
    parts = []
    for h in range(0, q.shape[2], step):
        sl = slice(h, h + step)
        a = (q[:, :, sl], k[:, :, sl], v[:, :, sl], g[:, :, sl],
             lse[:, sl], delta[:, sl])
        parts.append((fa.flash_bwd_dq_plain(*a, **kw),
                      *fa.flash_bwd_dkv_plain(*a, **kw)))
    want = tuple(torch.cat(ts, dim=2) for ts in zip(*parts))
    del parts
    rels = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        rels[name] = ((a - b).norm() / b.norm()).item()
        assert rels[name] <= 4e-4, f"{name}: norm err {rels[name]} > 4e-4"
    return got, rels


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_backward_reads_views_of_a_fused_projection(cuda,
                                                                causal):
    """The bf16 D = 64 backward loads q, k, v and dO through TMA maps
    over their strides: q/k/v as views of one fused (B, S, 3, H, D)
    tensor give the contiguous inputs' result bit for bit, and both hold
    to the plain versions."""
    B, S, H, D = 2, 300, 4, 64
    rng = np.random.default_rng(21)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, D)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    views = [qkv[:, :, i] for i in range(3)]
    assert not views[0].is_contiguous()
    fused, _ = _hold_bwd(*views, g, causal=causal)
    dense, _ = _hold_bwd(*(t.contiguous() for t in views), g, causal=causal)
    for a, b in zip(fused, dense):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_backward_ragged_rows_and_kv_len(cuda, causal):
    """S = 1000 (a ragged last 128-row block tile and 64-row stage) with
    kv_len rows of 0, 1, a ragged length and the full length: the
    kv_len = 0 row walks every tile and averages over all S keys."""
    S = 1000
    rng = np.random.default_rng(22)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((4, S, 4, 64))
                                   .astype(np.float32)).to(cuda,
                                                           torch.bfloat16)
                  for _ in range(4))
    lens = torch.tensor([0, 1, 937, S], dtype=torch.int32, device=cuda)
    _hold_bwd(q, k, v, g, causal=causal, kv_len=lens)


def test_flash_wgmma_backward_long_sum_holds_dv(cuda):
    """dV over S = 8192 q rows, causal: each 64-row q tile's products go
    to fresh tensor-core fragments added in f32, so the truncation of
    one long tensor-core sum (4.1e-4 of dV's norm when it carried the
    whole sum) stays under the 4e-4 limit."""
    rng = np.random.default_rng(23)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 8192, 2, 64))
                                   .astype(np.float32)).to(cuda,
                                                           torch.bfloat16)
                  for _ in range(4))
    _, rels = _hold_bwd(q, k, v, g, causal=True)
    print(f"S=8192 causal norm errors: {rels}")


def test_flash_wgmma_backward_compiles_without_spills(cuda, tmp_path):
    """The fused backward's consumers work at the edge of their 232
    registers: its descriptors are adds to one address field, so none
    holds a register across the tile loop (made once per kernel, they
    spilled 60 bytes). ptxas, run as the package builds the library,
    reports no spill and no stack for ``flash_bwd_wgmma_kernel``."""
    import re

    from kubeflow_tpu_torch.ops import _build

    log = _build.build(["flash_attention"], build_dir=str(tmp_path))
    text = log["flash_attention"]
    at = [m.start() for m in re.finditer(
        r"Compiling entry function '[^']*flash_bwd_wgmma_kernel", text)]
    assert len(at) == 1, text[-2000:]
    entry = text[at[0]:].split("Compiling entry function")[1]
    assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill " \
           "loads" in entry, entry


def _one_key_limits(q, k, v, g, lse, delta):
    """Elementwise limits on |kernel - plain| of dQ and dK at S = 1,
    where each row has one key: P = exp(s - lse) is 1 up to rounding and
    dS = P (dP - delta) is the difference of two equal sums, so both
    sides' dQ = scale dS K and dK = scale dS Q are rounding noise and a
    norm-relative reading says nothing. First-order rounding bounds with
    u = 2^-23 (twice f32's unit roundoff, for the tensor cores'
    accumulation) and gamma = D u a D-term f32 sum, each side's error
    counted: dP differs by 2 gamma sum|dO V|, s by 2 gamma scale
    sum|Q K|, the exponential by 4u (|s| + |lse|) + 8u; then dS's hi + lo
    split and both sides' bf16 rounding of the output, 2^-7 |dS| in
    all."""
    u = 2.0 ** -23
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    D = q.shape[-1]
    scale, gamma = D ** -0.5, D * u
    lse, delta = lse.transpose(1, 2), delta.transpose(1, 2)  # (B, S, H)
    s = (q32 * k32).sum(-1) * scale
    p = torch.exp(s - lse)
    dp = (g32 * v32).sum(-1)
    d_p = p * (2 * gamma * scale * (q32 * k32).abs().sum(-1)
               + 4 * u * (s.abs() + lse.abs()) + 8 * u)
    d_ds = d_p * (dp - delta).abs() + p * 2 * gamma * (g32 * v32).abs().sum(-1)
    err = (d_ds + 2.0 ** -7 * (p * (dp - delta)).abs())[..., None] * scale
    return err * k32.abs(), err * q32.abs()


def _hold_bwd_one_key(q, k, v, g, *, causal):
    """The fused kernel at S = 1: dQ and dK within
    :func:`_one_key_limits` of their plain versions, element by element,
    dV at the bf16 norm-relative limit (4e-4); returns the kernel outputs
    and the readings (each side's max |x|, the largest difference and
    the largest limit)."""
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa.flash_delta(g, out)
    before = dict(fa.launches)
    got = fa.flash_bwd(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == dict(before, flash_bwd=before["flash_bwd"] + 1)
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal))
    limits = _one_key_limits(q, k, v, g, lse, delta)
    readings = {}
    for name, a, b, lim in zip(("dq", "dk"), got, want, limits):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        diff = (a - b).abs()
        readings[name] = {"kernel_max": a.abs().max().item(),
                          "plain_max": b.abs().max().item(),
                          "diff_max": diff.max().item(),
                          "limit_max": lim.max().item()}
        assert (diff <= lim).all(), f"{name} at S=1: {readings[name]}"
    dv, want_dv = got[2].float(), want[2].float()
    rel = ((dv - want_dv).norm() / want_dv.norm()).item()
    assert rel <= 4e-4, f"dv at S=1: norm err {rel} > 4e-4"
    readings["dv"] = rel
    return got, readings


@pytest.mark.parametrize("S", [1, 2, 63, 64, 65, 127, 129, 192])
def test_flash_wgmma_backward_short_sequences(cuda, S):
    """Sequences of one or two 128-key tiles: one key (S = 1, held by
    :func:`_hold_bwd_one_key`), the upper warpgroup without keys
    (S <= 64 past a tile's start), a ragged q tile, one item a head;
    causal and not, and a repeat call bit for bit."""
    rng = np.random.default_rng(40 + S)
    q, k, v, g = (_bf16(rng, (2, S, 3, 64), cuda) for _ in range(4))
    hold = _hold_bwd_one_key if S == 1 else _hold_bwd
    for causal in (True, False):
        got, readings = hold(q, k, v, g, causal=causal)
        print(f"S={S} causal={causal}: {readings}")
        again, _ = hold(q, k, v, g, causal=causal)
        for a, b in zip(got, again):
            assert torch.equal(a, b)


def _hold_fwd(q, k, v, *, causal, kv_len=None):
    """The forward against its plain version: out within the bf16
    norm-relative limit (4e-4), lse within 1e-5; returns (out, lse) and
    out's reading."""
    kw = dict(causal=causal, kv_len=kv_len)
    before = fa.launches["flash_fwd"]
    out, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 1
    want, want_lse = fa.flash_fwd_plain(q, k, v, **kw)
    assert torch.isfinite(out.float()).all()
    rel = ((out.float() - want.float()).norm()
           / want.float().norm()).item()
    assert rel <= 4e-4, f"out: norm err {rel} > 4e-4"
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-5, f"lse: {err} > 1e-5"
    return (out, lse), rel


def _bf16(rng, shape, cuda):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_forward_reads_views_of_a_fused_projection(cuda,
                                                               causal):
    """The bf16 D = 64 forward loads q, k and v through TMA maps over
    their strides: views of one fused (B, S, 3, H, D) tensor give the
    contiguous inputs' out and lse bit for bit."""
    qkv = _bf16(np.random.default_rng(24), (2, 300, 3, 4, 64), cuda)
    views = [qkv[:, :, i] for i in range(3)]
    fused, _ = _hold_fwd(*views, causal=causal)
    dense, _ = _hold_fwd(*(t.contiguous() for t in views), causal=causal)
    for a, b in zip(fused, dense):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_forward_ragged_rows_and_kv_len(cuda, causal):
    """S = 1000 (a ragged last 64-row item and 64-key stage) with
    kv_len rows of 0, 1, a ragged length and the full length: the
    kv_len = 0 row walks every tile and averages over all S keys."""
    rng = np.random.default_rng(25)
    q, k, v = (_bf16(rng, (4, 1000, 4, 64), cuda) for _ in range(3))
    lens = torch.tensor([0, 1, 937, 1000], dtype=torch.int32, device=cuda)
    _hold_fwd(q, k, v, causal=causal, kv_len=lens)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129])
def test_flash_wgmma_forward_short_sequences(cuda, S):
    """Sequences shorter than an item: warpgroups without rows (S <= 64
    at 192 rows an item), one ragged stage."""
    rng = np.random.default_rng(26 + S)
    q, k, v = (_bf16(rng, (2, S, 3, 64), cuda) for _ in range(3))
    for causal in (True, False):
        _hold_fwd(q, k, v, causal=causal)


def test_flash_wgmma_forward_long_sum_holds_out(cuda):
    """out over S = 8192 keys, causal: each stage's P.V goes to fresh
    tensor-core fragments added in f32, so the rows that sum 128 stages
    stay under the 4e-4 limit."""
    rng = np.random.default_rng(27)
    q, k, v = (_bf16(rng, (1, 8192, 2, 64), cuda) for _ in range(3))
    _, rel = _hold_fwd(q, k, v, causal=True)
    print(f"S=8192 causal out norm error: {rel}")


# the bf16 D = 64 forward's timed shapes (B, S, H) and a ragged one
FWD_SHAPES = {"lm": (2, 8192, 16), "bert": (16, 512, 12),
              "predict_b8": (8, 512, 12), "predict_b1": (1, 128, 12),
              "ragged": (3, 1000, 4)}


def _pin_rows(monkeypatch, rows):
    """Pin the forward's rows an item: the wrapper asks ``flash_tile``
    at launch, which here answers ``rows`` for the forward."""
    tile = fa.flash_tile

    def pinned(kernel, *args, **kwargs):
        if kernel == "flash_fwd":
            return rows, autotune.WGMMA_TILES["flash_fwd"][1]
        return tile(kernel, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_tile", pinned)


@pytest.mark.parametrize("rows", [64, 192])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_flash_wgmma_forward_at_the_timed_shapes(cuda, monkeypatch, shape,
                                                 causal, masked, rows):
    """The forward at its four timed shapes and a ragged S, causal and
    not, with kv_len (a zero row and ragged ones; one ragged row at
    B = 1), at both of its tiles (each pinned): out within the bf16
    norm-relative limit (4e-4), lse within 1e-5."""
    B, S, H = FWD_SHAPES[shape]
    rng = np.random.default_rng(B * S + H)
    q, k, v = (_bf16(rng, (B, S, H, 64), cuda) for _ in range(3))
    lens = None
    if masked:
        lens = torch.tensor([0] + [max(1, S - 37 * b) for b in range(1, B)]
                            if B > 1 else [S - 37], dtype=torch.int32,
                            device=cuda)
    _pin_rows(monkeypatch, rows)
    assert fa._wgmma_route("flash_fwd", (q, k, v), causal)[0] == rows
    _hold_fwd(q, k, v, causal=causal, kv_len=lens)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_flash_wgmma_backward_at_the_timed_shapes(cuda, shape, causal,
                                                  masked):
    """The one-pass backward at the four timed shapes and a ragged S,
    causal and not, with kv_len (a zero row and ragged ones; one ragged
    row at B = 1): its q tiles' dQ alternate between the two consumer
    warpgroups and its items' walks run from one to 128 q tiles. dQ, dK
    and dV within the bf16 norm-relative limit (4e-4) of their plain
    versions (four heads a call), and a repeat call bit for bit."""
    B, S, H = FWD_SHAPES[shape]
    rng = np.random.default_rng(B * S + H + 1)
    q, k, v, g = (_bf16(rng, (B, S, H, 64), cuda) for _ in range(4))
    lens = None
    if masked:
        lens = torch.tensor([0] + [max(1, S - 37 * b) for b in range(1, B)]
                            if B > 1 else [S - 37], dtype=torch.int32,
                            device=cuda)
    got, rels = _hold_bwd(q, k, v, g, causal=causal, kv_len=lens, heads=4)
    print(f"{shape} causal={causal} masked={masked}: {rels}")
    out, lse = fa.flash_fwd(q, k, v, causal=causal, kv_len=lens)
    again = fa.flash_bwd(q, k, v, g, lse, fa.flash_delta(g, out),
                         causal=causal, kv_len=lens)
    for a, b in zip(got, again):
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
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_bwd(bad, k, v, g, lse, delta)
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
