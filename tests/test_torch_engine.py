"""Port paged ``DecodeEngine`` against the JAX paged engine.

Same weights, same prompts, same schedule (``run_once`` driven by hand,
the ``tests/test_engine_paged.py`` setups): greedy token streams must be
identical at f32 through chunked prefill, admission into a running
batch, prefix-page sharing with a copy-on-write split, and early EOS —
with the port's gather path and with its kernel path (the plain version
on the CPU). Sampled streams are held to the port's own contract:
reproducible per ``(seed, step)`` whatever the co-tenants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.serving.engine import DecodeEngine as JaxEngine
from kubeflow_tpu.serving.model_store import transformer_export_config
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.serving.engine import DecodeEngine, EngineClosed

torch.set_num_threads(2)

P_SHORT = [5, 11, 17]
P_LONG = [3, 2, 9, 23, 41, 8, 1, 30, 12]
PFX = list(range(1, 13))                    # 1 full page + 4 tokens
P1, P2 = PFX + [5, 11], PFX + [9, 3, 7]


def _schedule(eng):
    """Chunked prefill + admission into a running batch, then a prefix
    hit with a non-aligned boundary (one COW split)."""
    r1 = eng.submit(P_SHORT, max_new=10)
    for _ in range(4):
        eng.run_once(timeout=0.01)
    r2 = eng.submit(P_LONG, max_new=6)      # 3 chunks of 4
    for _ in range(40):
        eng.run_once(timeout=0.01)
    a = eng.submit(P1, max_new=4, prefix_len=12)
    for _ in range(25):
        eng.run_once(timeout=0.01)
    b = eng.submit(P2, max_new=4, prefix_len=12)
    for _ in range(25):
        eng.run_once(timeout=0.01)
    return [r.result() for r in (r1, r2, a, b)]


@pytest.fixture(scope="module")
def lm():
    jc = JaxConfig(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=64, max_seq_len=48,
                   dtype=jnp.float32, remat=False)
    params = JaxTransformer(jc).init(
        jax.random.key(0), np.zeros((1, 8), np.int32))["params"]
    pc = TransformerConfig(**transformer_export_config(jc))
    model = convert.to_module(pc, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    jeng = JaxEngine(jc, params, slots=4, paged=True, kv_page_size=8,
                     prefill_chunk_tokens=4, autostart=False)
    want = _schedule(jeng)
    stats = (jeng.prefix_hits, jeng.prefix_misses, jeng.cow_splits,
             jeng.prefix_pages_shared)
    return pc, model, want, stats


def _port(lm, **kw):
    pc, model = lm[0], lm[1]
    kw.setdefault("slots", 4)
    kw.setdefault("kv_page_size", 8)
    kw.setdefault("prefill_chunk_tokens", 4)
    return DecodeEngine(pc, model, paged=True, autostart=False,
                        device="cpu", **kw)


def _drain(eng, n=60):
    for _ in range(n):
        eng.run_once(timeout=0.01)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_greedy_streams_match_jax_paged_engine(lm, impl):
    _, _, want, stats = lm
    eng = _port(lm, paged_attention_impl=impl)
    assert _schedule(eng) == want
    assert (eng.prefix_hits, eng.prefix_misses, eng.cow_splits,
            eng.prefix_pages_shared) == stats == (1, 1, 1, 2)
    assert eng.prefill_chunks >= 3 + 1 + 4
    eng._prefix_pages.clear()
    eng._pool.check_idle()


def test_cow_split_copies_one_page(lm):
    eng = _port(lm)
    copies = []
    real = eng._copy_page

    def counted(cache, src, dst):
        copies.append((src, dst))
        return real(cache, src, dst)

    eng._copy_page = counted
    a = eng.submit(P1, max_new=4, prefix_len=12)
    _drain(eng, 25)
    b = eng.submit(P2, max_new=4, prefix_len=12)
    _drain(eng, 25)
    assert a.result() == lm[2][2] and b.result() == lm[2][3]
    assert len(copies) == 1 and eng._pool.cow_splits == 1
    snap = eng.snapshot()
    assert snap["cow_splits"] == 1 and snap["prefix_pages_shared"] == 2


def test_eos_frees_pages_early(lm):
    toks = lm[2][0]
    eos = next(toks[i] for i in range(1, len(toks))
               if toks[i] not in toks[:i])
    eng = _port(lm, slots=2)
    req = eng.submit(P_SHORT, max_new=10, eos_id=eos)
    _drain(eng, 20)
    assert req.result() == toks[:toks.index(eos) + 1]
    assert eng.active_count == 0
    eng._pool.check_idle()


def test_multi_step_sync_matches_single_step(lm):
    eng = _port(lm, steps_per_sync=3)
    r1 = eng.submit(P_SHORT, max_new=10)
    r2 = eng.submit(P_LONG, max_new=6)
    _drain(eng, 40)
    assert r1.result() == lm[2][0] and r2.result() == lm[2][1]
    eng._pool.check_idle()


def test_undersized_pool_gates_admission_fifo(lm):
    """3 streams of 3 pages each through a 6-page pool: admissions wait
    for retirements, nobody deadlocks, every stream is exact."""
    eng = _port(lm, kv_pages=6)
    reqs = [eng.submit(P_SHORT, max_new=10) for _ in range(3)]
    _drain(eng, 120)
    for r in reqs:
        assert r.result() == lm[2][0]
    eng._pool.check_idle()
    with pytest.raises(ValueError, match="KV pages"):
        _port(lm, kv_pages=2).submit(P_SHORT, max_new=21)


def test_chunks_interleave_with_live_decode(lm):
    """While a stream decodes, each cycle runs at most one prefill chunk
    before the shared step — a burst admit stalls decode one chunk."""
    eng = _port(lm)
    r0 = eng.submit(P_SHORT, max_new=30)
    _drain(eng, 3)
    burst = [eng.submit([1 + i, 2, 3, 4, 5, 6, 7, 8], max_new=2)
             for i in range(3)]
    real = eng._run_chunk
    per_cycle = []

    def counted(job):
        per_cycle[-1] += 1
        return real(job)

    eng._run_chunk = counted
    for _ in range(40):
        per_cycle.append(0)
        eng.run_once(timeout=0.01)
    assert sum(per_cycle) == 6 and max(per_cycle) == 1
    # the live stream's greedy prefix is the JAX engine's stream
    assert len(r0.result()) == 30 and r0.result()[:10] == lm[2][0]
    for r in burst:
        assert len(r.result()) == 2


@pytest.mark.parametrize("sampler", ["fused", "bounded", "exact_sort"])
def test_sampled_streams_reproducible_regardless_of_cotenants(lm, sampler):
    kw = dict(max_new=6, temperature=0.8, top_k=12, top_p=0.9, seed=42)
    solo_eng = _port(lm, sampler_impl=sampler)
    solo = solo_eng.submit(P_SHORT + [2], **kw)
    _drain(solo_eng, 25)
    crowd_eng = _port(lm, sampler_impl=sampler)
    crowd = [crowd_eng.submit([9 + i], max_new=6, temperature=1.3, seed=i)
             for i in range(3)]
    shared = crowd_eng.submit(P_SHORT + [2], **kw)
    _drain(crowd_eng, 30)
    assert solo.result() == shared.result()
    assert len(solo.result()) == 6
    assert all(len(c.result()) == 6 for c in crowd)
    assert crowd_eng.greedy_steps == 0


def test_all_greedy_batch_takes_the_argmax_step(lm):
    eng = _port(lm, sampler_impl="fused")
    r = eng.submit(P_SHORT, max_new=10)
    _drain(eng, 20)
    assert r.result() == lm[2][0]
    assert eng.greedy_steps == eng.steps_total > 0


def test_env_switches(lm, monkeypatch):
    monkeypatch.setenv("KFTPU_PAGED", "0")
    dense = _port_env(lm)
    assert (dense.paged, dense.kv_page_size) == (False, 0)
    r = dense.submit(P_LONG, max_new=6)
    _drain(dense, 20)
    assert r.result() == lm[2][1]
    monkeypatch.setenv("KFTPU_PAGED", "1")
    monkeypatch.setenv("KFTPU_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("KFTPU_KV_PAGES", "20")
    monkeypatch.setenv("KFTPU_PREFILL_CHUNK", "5")
    monkeypatch.setenv("KFTPU_PAGED_ATTN", "kernel")
    monkeypatch.setenv("KFTPU_SAMPLER_IMPL", "auto")
    monkeypatch.setenv("KFTPU_SAMPLER_BOUND", "0")
    eng = _port_env(lm)
    assert (eng.kv_page_size, eng.kv_pages, eng.prefill_chunk_tokens,
            eng.paged_attention_impl, eng.sampler_impl) == (
                4, 20, 5, "kernel", "fused")
    r = eng.submit(P_LONG, max_new=6)
    _drain(eng, 20)
    assert r.result() == lm[2][1]


def _port_env(lm):
    return DecodeEngine(lm[0], lm[1], slots=2, autostart=False,
                        device="cpu")


def test_close_fails_waiting_and_prefilling(lm):
    eng = _port(lm, slots=2, kv_pages=3)
    held = eng.submit(P_SHORT, max_new=17)       # 3 pages: fills the pool
    _drain(eng, 3)
    waiting = eng.submit([3, 2], max_new=17)
    eng.run_once(timeout=0.01)
    assert eng.pending_count == 1
    eng.close()
    for req in (held, waiting):
        with pytest.raises(EngineClosed):
            req.result()
    with pytest.raises(EngineClosed):
        eng.submit([1], max_new=1)


def test_background_thread_serves(lm):
    pc, model = lm[0], lm[1]
    eng = DecodeEngine(pc, model, slots=2, paged=True, kv_page_size=8,
                       device="cpu")
    try:
        assert eng.submit(P_SHORT, max_new=10).result() == lm[2][0]
    finally:
        eng.close()
