"""Port dense ``DecodeEngine`` (the reference's default mode) against JAX.

The tiny LM of ``tests/test_engine.py`` with weights from
``jax.random.key(0)``. The JAX dense engine runs the schedules of
``tests/test_engine.py`` once, in module-scoped fixtures; the port's
dense engine runs the same schedules, driven by hand with ``run_once``,
and its greedy streams and counters must be identical at f32: ragged
requests sharing steps, admission into a running batch, more requests
than slots, burst admission (mixed buckets, the batch cap, a prefixed
request on the row path), prefix hits, misses and re-serves, prompts
near the context end, and the greedy fast path. Port-only behaviour is
held to those streams: early EOS, multi-step sync, the batch prefill's
fallback to the row path, the prefix LRU's eviction and byte budget,
cache recovery in both modes and its budget, rows written past the
context end, and the unary ``:generate`` of a ``ModelServer`` with no
engine against the JAX server's. Sampled streams are held to the port's
own contract: the same ``(seed, step)`` gives the same tokens whatever
the co-tenants and whichever admission path.
"""

import json
import threading
import time
import urllib.error
import urllib.request

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
from kubeflow_tpu_torch.serving.engine import (
    DecodeEngine,
    EngineClosed,
    pow2_bucket,
)

torch.set_num_threads(2)

SYS = [7, 3, 19, 4]
P1, P2 = SYS + [5, 11], SYS + [9, 23, 2]
NEAR, NEAR2 = list(range(1, 48)), list(range(2, 45))
AT_BUDGET = list(range(1, 41))          # 40 + 8 new = the whole context
BURST = [[5, 11], [3, 2], [9, 23, 41, 7, 2], [1, 2, 3, 4, 5, 6]]


def _go(eng, n):
    for _ in range(n):
        eng.run_once(timeout=0.01)


def _counters(eng):
    return {k: getattr(eng, k) for k in (
        "steps_total", "greedy_steps", "tokens_total", "batch_prefills",
        "prefix_hits", "prefix_misses")}


def _main_schedule(eng):
    """The tests/test_engine.py schedules in turn through one engine of
    4 slots; returns every stream and the counters after each part."""
    out = {}
    a = eng.submit([5, 11, 17], max_new=8)
    b = eng.submit([3, 2, 9, 23, 41], max_new=4)
    _go(eng, 12)
    out["ragged"] = [a.result(), b.result()]
    out["ragged_counters"] = _counters(eng)
    c = eng.submit([5, 11, 17], max_new=10)
    _go(eng, 3)
    d = eng.submit([7, 2], max_new=3)
    _go(eng, 12)
    out["running"] = [c.result(), d.result()]
    reqs = [eng.submit([3 + i, 7], max_new=4) for i in range(6)]
    _go(eng, 30)
    out["queued"] = [r.result() for r in reqs]
    reqs = [eng.submit(p, max_new=4) for p in BURST]
    reqs.append(eng.submit(P1, max_new=4, prefix_len=4))
    _go(eng, 20)
    out["burst"] = [r.result() for r in reqs]
    out["burst_counters"] = _counters(eng)
    reqs = [eng.submit(P2, max_new=5, prefix_len=4)]
    _go(eng, 8)
    reqs.append(eng.submit(P1, max_new=5, prefix_len=4))
    _go(eng, 8)
    reqs += [eng.submit(p, max_new=5) for p in (P1, P2)]
    _go(eng, 10)
    out["prefix"] = [r.result() for r in reqs]
    reqs = [eng.submit(NEAR, max_new=1, prefix_len=42),
            eng.submit(NEAR2, max_new=3, prefix_len=41),
            eng.submit(NEAR, max_new=1), eng.submit(NEAR2, max_new=3)]
    _go(eng, 10)
    out["near_end"] = [r.result() for r in reqs]
    steps0 = eng.greedy_steps
    g = eng.submit([5, 11, 17], max_new=8)
    s = eng.submit([9, 2], max_new=8, temperature=0.9, seed=1)
    _go(eng, 12)
    out["mixed_greedy"] = g.result()
    assert len(s.result()) == 8
    out["greedy_steps_while_sampling"] = eng.greedy_steps - steps0
    reqs = [eng.submit(AT_BUDGET, max_new=8), eng.submit([3, 2, 9], max_new=4),
            eng.submit([10, 3, 19, 4, 5], max_new=2)]
    _go(eng, 12)
    out["more"] = [r.result() for r in reqs]
    out["counters"] = _counters(eng)
    return out


def _cap_schedule(eng):
    reqs = [eng.submit(p, max_new=3) for p in ([5, 11], [3, 2], [9, 23],
                                                [13, 7])]
    _go(eng, 6)
    return [r.result() for r in reqs], _counters(eng)


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
    return jc, params, pc, model


@pytest.fixture(scope="module")
def want(lm):
    """The JAX dense engine's streams and counters over both schedules."""
    jc, params = lm[0], lm[1]
    jeng = JaxEngine(jc, params, slots=4, autostart=False)
    main = _main_schedule(jeng)
    main["prefix_row_bytes"] = jeng._prefix_row_bytes
    cap = _cap_schedule(JaxEngine(jc, params, slots=8, admit_batch_max=2,
                                  autostart=False))
    return main, cap


def _port(lm, **kw):
    kw.setdefault("slots", 4)
    return DecodeEngine(lm[2], lm[3], autostart=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def got(lm):
    eng = _port(lm)
    assert not eng.paged
    main = _main_schedule(eng)
    main["prefix_row_bytes"] = eng._prefix_row_bytes
    return main


@pytest.mark.parametrize("part", [
    "ragged", "ragged_counters", "running", "queued", "burst",
    "burst_counters", "prefix", "near_end", "mixed_greedy",
    "greedy_steps_while_sampling", "more", "counters", "prefix_row_bytes"])
def test_dense_schedule_matches_jax_engine(want, got, part):
    assert got[part] == want[0][part]


def test_schedule_exercised_every_path(got):
    """The schedule really took the paths it names."""
    c = got["counters"]
    assert got["ragged_counters"]["steps_total"] <= 8
    assert got["burst_counters"]["batch_prefills"] >= 2
    assert (c["prefix_hits"], c["prefix_misses"]) == (2, 3)
    assert got["greedy_steps_while_sampling"] == 0
    assert c["greedy_steps"] < c["steps_total"]
    # prefix continuations equal the full prefills
    pre = got["prefix"]
    assert pre[0] == pre[3] and pre[1] == pre[2]
    assert got["near_end"][:2] == got["near_end"][2:]


def test_batch_cap_matches_jax(lm, want):
    streams, counters = _cap_schedule(_port(lm, slots=8, admit_batch_max=2))
    assert (streams, counters) == want[1]
    assert counters["batch_prefills"] == 2


def test_batch_prefill_failure_falls_back_to_the_row_path(lm, want):
    eng = _port(lm)

    def boom(*a, **k):
        raise RuntimeError("injected batch prefill failure")

    eng._prefill_batch = boom
    reqs = [eng.submit(p, max_new=3) for p in ([5, 11], [3, 2])]
    _go(eng, 6)
    assert [r.result() for r in reqs] == want[1][0][:2]
    assert eng.batch_prefills == 0
    off = _port(lm, admit_batch_max=0)
    reqs = [off.submit(p, max_new=3) for p in ([5, 11], [3, 2])]
    _go(off, 6)
    assert [r.result() for r in reqs] == want[1][0][:2]
    assert off.batch_prefills == 0


def test_burst_insert_failure_closes_the_engine(lm):
    """A failed row copy has half-written the cache: the burst fails
    retryably and the background loop closes the engine."""
    eng = _port(lm)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected insert failure")

        eng._insert_rows = boom
        reqs = [eng.submit([5, 11, 17], max_new=4),
                eng.submit([3, 2, 9], max_new=4)]
        eng.start()             # both queued: one burst
        for r in reqs:
            with pytest.raises(EngineClosed):
                r.result()
        for _ in range(50):
            if eng.closed:
                break
            time.sleep(0.1)
        assert eng.closed
        with pytest.raises(EngineClosed):
            eng.submit([7], max_new=2)
    finally:
        eng.close()


def test_burst_puts_every_first_token_before_any_span(lm, monkeypatch):
    """The batch path puts every member's first token on its queue
    before it records any member's spans or arms any slot: the ledger
    stamps the batch once, and the last member's queue must not wait on
    the others' bookkeeping. The streams are the row path's."""
    prompts = ([5, 11], [3, 2], [7, 4])
    eng = _port(lm)
    reqs = [eng.submit(p, max_new=4) for p in prompts]
    queued = []
    record = eng.tracer.record

    def spy(name, *args, **kwargs):
        if name == "engine.admit":
            queued.append([r.out.qsize() for r in reqs])
        return record(name, *args, **kwargs)

    monkeypatch.setattr(eng.tracer, "record", spy)
    _go(eng, 6)
    assert eng.batch_prefills == 1
    assert queued == [[1, 1, 1]] * 3
    row = _port(lm, admit_batch_max=0)
    alone = [row.submit(p, max_new=4) for p in prompts]
    _go(row, 6)
    assert [r.result() for r in reqs] == [r.result() for r in alone]


def test_burst_insert_failure_fails_every_bucket(lm):
    """A failed row copy in the first bucket's burst also ends the
    requests of the buckets queued behind it: they are off the queue and
    in no slot, so nothing else would ever answer them."""
    from kubeflow_tpu_torch.serving.engine import _END, _CacheInvalidated

    eng = _port(lm)

    def boom(*a, **k):
        raise RuntimeError("injected insert failure")

    eng._insert_rows = boom
    reqs = [eng.submit(p, max_new=4)
            for p in ([5, 11], [3, 2], [9, 23, 41, 7, 2], [1, 2, 3, 4, 5])]
    with pytest.raises(_CacheInvalidated):
        eng.run_once(timeout=0.01)
    assert eng.pending_count == 0
    for r in reqs:
        assert r.out.get_nowait() is _END
        assert isinstance(r.error, EngineClosed)


def test_eos_frees_the_slot_early(lm, got):
    toks = got["ragged"][0]
    stop = next(i for i in range(1, len(toks)) if toks[i] not in toks[:i])
    eng = _port(lm, slots=2)
    req = eng.submit([5, 11, 17], max_new=8, eos_id=toks[stop])
    _go(eng, 10)
    assert req.result() == toks[:stop + 1]
    assert eng.active_count == 0


@pytest.mark.parametrize("sampler", ["fused", "bounded", "exact_sort"])
def test_multi_step_sync_matches_single_step(lm, got, sampler):
    want9 = got["running"][0][:9]
    eng = _port(lm, slots=2, steps_per_sync=4, sampler_impl=sampler)
    r1 = eng.submit([5, 11, 17], max_new=9)
    r2 = eng.submit([7, 2], max_new=5, temperature=0.9, seed=3)
    _go(eng, 6)
    assert r1.result() == want9
    one = _port(lm, slots=2, sampler_impl=sampler)
    r2b = one.submit([7, 2], max_new=5, temperature=0.9, seed=3)
    _go(one, 8)
    assert r2.result() == r2b.result() and len(r2b.result()) == 5
    stop = next(i for i in range(1, 9) if want9[i] not in want9[:i])
    eos = _port(lm, slots=2, steps_per_sync=4, sampler_impl=sampler)
    r3 = eos.submit([5, 11, 17], max_new=9, eos_id=want9[stop])
    _go(eos, 6)
    assert r3.result() == want9[:stop + 1]


@pytest.mark.parametrize("sampler", ["fused", "bounded", "exact_sort"])
def test_sampled_first_token_same_on_row_and_batch_paths(lm, sampler):
    kw = dict(max_new=6, temperature=0.8, top_k=12, top_p=0.9, seed=42)
    row = _port(lm, sampler_impl=sampler)
    solo = row.submit([5, 11, 17], **kw)
    _go(row, 8)
    assert row.batch_prefills == 0
    batch = _port(lm, sampler_impl=sampler)
    crowd = [batch.submit([9 + i, 23, 41], max_new=6, temperature=1.3,
                          seed=i) for i in range(2)]
    shared = batch.submit([5, 11, 17], **kw)     # third row of the batch
    _go(batch, 8)
    assert batch.batch_prefills == 1 and batch.greedy_steps == 0
    assert shared.result() == solo.result() and len(solo.result()) == 6
    assert all(len(c.result()) == 6 for c in crowd)


def test_prefix_lru_eviction_and_validation(lm):
    eng = _port(lm, slots=2, prefix_cache_entries=2)
    for i in range(3):          # 3 distinct prefixes, room for 2
        r = eng.submit([10 + i, 3, 19, 4, 5], max_new=2, prefix_len=4)
        _go(eng, 4)
        r.result()
    assert len(eng._prefix_store) == 2
    r = eng.submit([10, 3, 19, 4, 5], max_new=2, prefix_len=4)
    _go(eng, 4)
    r.result()
    assert eng.prefix_misses == 4
    with pytest.raises(ValueError, match="prefix_len"):
        eng.submit([1, 2, 3], max_new=2, prefix_len=3)
    with pytest.raises(ValueError, match="prefix_len"):
        eng.submit([1, 2, 3], max_new=2, prefix_len=-1)


def test_prefix_lru_byte_budget(lm, got):
    row = got["prefix_row_bytes"]
    eng = _port(lm, slots=2, prefix_cache_bytes=int(1.5 * row))
    for i in range(3):
        r = eng.submit([10 + i, 3, 19, 4, 5], max_new=2, prefix_len=4)
        _go(eng, 4)
        out = r.result()
        if i == 0:
            assert out == got["more"][2]
        assert len(eng._prefix_store) == 1
        assert eng.prefix_cache_bytes == row <= eng._prefix_budget_bytes
    assert eng.prefix_misses == 3
    r = eng.submit([12, 3, 19, 4, 5], max_new=2, prefix_len=4)
    _go(eng, 4)
    r.result()
    assert eng.prefix_hits == 1
    # one row past the budget: the full prefill serves, nothing stored
    tiny = _port(lm, slots=2, prefix_cache_bytes=128)
    r = tiny.submit(P1, max_new=5, prefix_len=4)
    _go(tiny, 8)
    assert r.result() == got["prefix"][2]
    assert (len(tiny._prefix_store), tiny.prefix_cache_bytes,
            tiny.prefix_hits, tiny.prefix_misses) == (0, 0, 0, 0)


def test_rows_past_the_context_leave_live_streams_unchanged(lm, got):
    """A row at its budget computes steps past ``max_seq_len`` (K = 5
    over 7 needed steps), and a retired row idles past it, writing
    nowhere; nothing raises and the live streams are the JAX engine's."""
    eng = _port(lm, slots=2, steps_per_sync=5)
    a = eng.submit(AT_BUDGET, max_new=8)
    b = eng.submit([3, 2, 9], max_new=4)
    _go(eng, 6)
    assert a.result() == got["more"][0] and b.result() == got["more"][1]
    assert int(eng._cache.positions.max()) > 48
    c = eng.submit(AT_BUDGET, max_new=8)   # into a row idled past the end
    _go(eng, 6)
    assert c.result() == got["more"][0]


def test_greedy_fast_path_and_precompile(lm, got):
    eng = _port(lm, precompile=True, sampler_impl="fused")
    g = eng.submit([5, 11, 17], max_new=8)
    _go(eng, 10)
    assert g.result() == got["ragged"][0]
    assert eng.greedy_steps == eng.steps_total > 0


def _inject_step_failure(eng):
    real = (eng._step_greedy, eng._step)
    fired = []

    def boom(*a, **k):
        fired.append(1)
        raise RuntimeError("injected step failure")

    eng._step_greedy = boom
    eng._step = boom
    return real, fired


@pytest.mark.parametrize("paged", [True, False])
def test_step_failure_recovers_and_replays(lm, got, paged):
    """A failed step rebuilds the cache and replays the in-flight
    streams: the greedy stream completes bit-identically and the engine
    keeps serving (as tests/test_engine_paged.py:450)."""
    kw = dict(paged=True, kv_page_size=8, prefill_chunk_tokens=8) \
        if paged else {}
    eng = _port(lm, slots=2, **kw)
    r = eng.submit([5, 11, 17], max_new=8)
    _go(eng, 4)
    real, fired = _inject_step_failure(eng)
    eng.run_once(timeout=0.01)
    assert fired and eng.recoveries == 1 and not eng.closed
    eng._step_greedy, eng._step = real
    _go(eng, 30)
    assert r.result() == got["ragged"][0]
    r2 = eng.submit([3, 2, 9], max_new=4)
    _go(eng, 20)
    assert r2.result() == got["more"][1]
    if paged:
        eng._pool.check_idle()


def test_sampled_stream_survives_recovery(lm):
    kw = dict(max_new=8, temperature=0.9, top_k=20, seed=5)
    clean = _port(lm, slots=2)
    want = clean.submit([5, 11, 17], **kw)
    _go(clean, 10)
    eng = _port(lm, slots=2)
    r = eng.submit([5, 11, 17], **kw)
    _go(eng, 3)
    real, _ = _inject_step_failure(eng)
    eng.run_once(timeout=0.01)
    eng._step_greedy, eng._step = real
    _go(eng, 10)
    assert eng.recoveries == 1 and r.result() == want.result()


def test_recovery_budget_exhaustion_closes(lm):
    eng = _port(lm, slots=2, recoveries=1)
    r = eng.submit([5, 11], max_new=4)
    eng.run_once(timeout=0.01)
    _inject_step_failure(eng)
    eng.run_once(timeout=0.01)          # recovery 1: replayed
    assert eng.recoveries == 1
    with pytest.raises(RuntimeError, match="injected"):
        for _ in range(5):              # budget gone: raises through
            eng.run_once(timeout=0.01)
    eng.close()
    with pytest.raises(EngineClosed):
        r.result()


def test_loop_closes_and_repository_rebuilds(tmp_path, lm, got):
    """A persistently failing step spends the recovery budget; the loop
    closes the engine, requests fail retryably, and the repository
    builds a fresh engine on the next request."""
    from kubeflow_tpu.serving import model_store as jax_store
    from kubeflow_tpu_torch.serving.server import ModelRepository

    jc, params = lm[0], lm[1]
    jax_store.export_model(str(tmp_path / "lm"), "transformer", params,
                           config=jax_store.transformer_export_config(jc))
    repo = ModelRepository(str(tmp_path), poll_interval_s=3600,
                           decode_slots=2, device="cpu")
    try:
        loaded = repo.get("lm")
        eng = repo.engine_for("lm", loaded)
        assert eng is not None and not eng.paged
        _inject_step_failure(eng)
        req = eng.submit([5, 11], max_new=4)
        with pytest.raises(EngineClosed):
            req.result()
        assert eng.closed and eng.recoveries == 2
        with pytest.raises(EngineClosed):
            eng.submit([3], max_new=2)
        eng2 = repo.engine_for("lm", loaded)
        assert eng2 is not eng and not eng2.closed
        assert eng2.submit([5, 11, 17], max_new=4).result() == \
            got["ragged"][0][:4]
    finally:
        repo.stop()


def test_repository_warmup_precompiles_its_engines(tmp_path, lm, got,
                                                  monkeypatch):
    """``warmup=True`` builds each engine with ``precompile``: both step
    paths run once before the first request, and the streams are
    unchanged."""
    from kubeflow_tpu.serving import model_store as jax_store
    from kubeflow_tpu_torch.serving.server import ModelServer

    jc, params = lm[0], lm[1]
    jax_store.export_model(str(tmp_path / "lm"), "transformer", params,
                           config=jax_store.transformer_export_config(jc))
    warmed = []
    real = DecodeEngine._precompile_steps
    monkeypatch.setattr(DecodeEngine, "_precompile_steps",
                        lambda self: (warmed.append(self), real(self)))
    for warmup in (False, True):
        server = ModelServer(str(tmp_path), port=0, poll_interval_s=3600,
                             decode_slots=2, warmup=warmup, device="cpu")
        try:
            eng = server.repo.engine_for("lm", server.repo.get("lm"))
            assert warmed == ([eng] if warmup else [])
            assert eng.submit([5, 11, 17], max_new=8).result() == \
                got["ragged"][0]
        finally:
            server.repo.stop()


def test_default_mode_is_dense(lm, monkeypatch):
    monkeypatch.delenv("KFTPU_PAGED", raising=False)
    monkeypatch.delenv("KFTPU_ADMIT_BATCH", raising=False)
    monkeypatch.delenv("KFTPU_ENGINE_RECOVERIES", raising=False)
    eng = DecodeEngine(lm[2], lm[3], autostart=False, device="cpu")
    assert (eng.paged, eng.admit_batch_max, eng._recoveries_left,
            eng.kv_page_size) == (False, 8, 2, 0)
    assert "pages_total" not in eng.snapshot()
    monkeypatch.setenv("KFTPU_PAGED", "1")
    monkeypatch.setenv("KFTPU_ADMIT_BATCH", "3")
    monkeypatch.setenv("KFTPU_ENGINE_RECOVERIES", "5")
    eng = DecodeEngine(lm[2], lm[3], autostart=False, device="cpu")
    assert (eng.paged, eng.admit_batch_max, eng._recoveries_left) == (
        True, 3, 5)
    assert eng.snapshot()["paged"] is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DecodeEngine(lm[2], lm[3], autostart=False)


def test_pow2_bucket_matches_the_reference():
    from kubeflow_tpu.serving.engine import pow2_bucket as ref

    cases = [(n, cap) for cap in (1, 5, 48, 64) for n in range(-1, 70)]
    assert [pow2_bucket(n, cap) for n, cap in cases] == [
        ref(n, cap) for n, cap in cases]
    with pytest.raises(ValueError):
        pow2_bucket(3, 0)


# -- the unary :generate path ------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read()
        if resp.headers.get("Content-Type") == "application/jsonlines":
            return [json.loads(x) for x in raw.splitlines() if x.strip()]
        return json.loads(raw)


def test_unary_generate_matches_jax_server(tmp_path, lm, monkeypatch):
    from kubeflow_tpu.serving import model_store as jax_store
    from kubeflow_tpu.serving.server import ModelServer as JaxServer
    from kubeflow_tpu_torch.serving.server import ModelServer

    monkeypatch.delenv("KFTPU_PAGED", raising=False)
    jc, params = lm[0], lm[1]
    jax_store.export_model(str(tmp_path / "lm"), "transformer", params,
                           config=jax_store.transformer_export_config(jc))
    prompts = [[5, 11, 17], [3, 2, 9, 23, 41, 8, 1, 30, 12], [13]]
    body = {"prompt_tokens": prompts, "max_new_tokens": 6}
    jsrv = JaxServer(str(tmp_path), port=0, poll_interval_s=3600)
    code, want = jsrv.handle_generate("lm", None, body)
    assert code == 200
    server = ModelServer(str(tmp_path), port=0, poll_interval_s=3600,
                         device="cpu")
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/lm:generate"
    try:
        assert server.repo.engine_for("lm", server.repo.get("lm")) is None
        out = _post(url, body)
        assert out["tokens"] == want["tokens"] and out["model_version"] == "1"
        lines = _post(url, dict(body, stream=True))
        assert lines[-1] == {"done": True, "model_version": "1"}
        assert [list(r) for r in zip(*[ln["tokens"] for ln in lines[:-1]])] \
            == want["tokens"]
        # the tail near the context end serves the exact ask
        tail = {"prompt_tokens": [NEAR2], "max_new_tokens": 5}
        assert _post(url, tail)["tokens"] == jsrv.handle_generate(
            "lm", None, tail)[1]["tokens"]
        sampled = dict(body, temperature=0.8, top_k=10, top_p=0.9, seed=3)
        a, b = _post(url, sampled), _post(url, sampled)
        assert a["tokens"] == b["tokens"]
        assert all(0 <= t < 97 for row in a["tokens"] for t in row)
        for bad, msg in (({"prefix_len": 1}, "prefix_len requires"),
                         ({"eos_id": 3}, "eos_id requires"),
                         ({"max_new_tokens": 46}, "exceed"),
                         ({"top_p": 0}, "top_p")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, dict(body, **bad))
            assert e.value.code == 400
            assert msg in json.loads(e.value.read())["error"]
            assert jsrv.handle_generate("lm", None, dict(body, **bad))[0] \
                == 400
    finally:
        server.stop()
        jsrv.repo.stop()


def test_unary_generate_concurrent_requests(tmp_path, lm):
    """Concurrent unary requests each get their own tokens."""
    from kubeflow_tpu.serving import model_store as jax_store
    from kubeflow_tpu_torch.serving.server import ModelServer

    jc, params = lm[0], lm[1]
    jax_store.export_model(str(tmp_path / "lm"), "transformer", params,
                           config=jax_store.transformer_export_config(jc))
    server = ModelServer(str(tmp_path), port=0, poll_interval_s=3600,
                         decode_slots=0, device="cpu")
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/lm:generate"
    results = {}

    def client(i):
        results[i] = _post(url, {"prompt_tokens": [[5 + i, 11, 17]],
                                 "max_new_tokens": 4})["tokens"][0]

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(3):
            assert results[i] == _post(url, {
                "prompt_tokens": [[5 + i, 11, 17]],
                "max_new_tokens": 4})["tokens"][0]
    finally:
        server.stop()
