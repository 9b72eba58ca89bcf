"""The port's request ledger and serving spans against the JAX package.

- The reference's pure ledger cases (``tests/test_request_ledger.py``)
  run on both ``kubeflow_tpu.obs.requests`` and the port's copy, one
  shared body each: exact fake-clock pins of an edge-joined record and a
  shed one, stall clipping, the tiling property under random
  interleavings, live eviction.
- The emit hot path reads no clock: a steady-state ``run_once`` of the
  port's engine, dense and paged, takes as many clock reads at
  ``steps_per_sync=8`` as at 2, and at most 6.
- A real engine run: every record tiles, carries prefill and decode, and
  the ``kftpu_request_*`` series are exposed with ``{model, slo_class}``.
- Engine span names and parent structure equal the JAX engine's on the
  same tiny model and requests, each engine under its own fake clock.
- The JAX package's ``EdgeProxy`` in front of the port's ``ModelServer``
  with a forged ``traceparent``: the port's ``serving.*`` and
  ``engine.*`` spans carry the edge's trace id (the forged one is
  stripped), and the ledger record is keyed by it.
"""

import collections
import json
import random
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.edge.proxy import EdgeProxy, Route
from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.obs import requests as jax_reqobs
from kubeflow_tpu.obs import trace as jax_trace
from kubeflow_tpu.serving.engine import DecodeEngine as JaxEngine
from kubeflow_tpu.serving.model_store import (
    export_model,
    transformer_export_config,
)
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.obs import requests as reqobs
from kubeflow_tpu_torch.obs import trace as port_trace
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.serving.server import ModelServer
from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY

torch.set_num_threads(2)

RID = "ab" * 16
MODULES = {"jax": jax_reqobs, "port": reqobs}


# -- the pure ledger cases, on both modules ---------------------------------


def _edge_joined(m):
    led = m.RequestLedger()
    led.start(RID, t=0.0, slo_class="standard", phase=m.ADMISSION)
    led.mark(RID, m.QUEUE_WAIT, 0.5)
    led.start(RID, t=0.6, model="m")
    led.mark(RID, m.ADMISSION, 1.0)
    led.mark(RID, m.PREFILL, 1.5)
    led.emit(RID, 2.0)
    led.emit(RID, 2.5)
    led.emit(RID, 3.0)
    led.stall(RID, m.KV_FAULT, 2.2, 2.4)
    rec = led.finish(RID, 3.0)
    m.check_tiling(rec)
    assert rec.model == "m" and rec.slo_class == "standard"
    assert rec.ttft_ms == 2000.0 and rec.itl_ms == [500.0, 500.0]
    assert rec.tokens == 3
    assert rec.seconds == {
        m.ADMISSION: pytest.approx(1.0), m.QUEUE_WAIT: pytest.approx(0.5),
        m.PREFILL: pytest.approx(0.5), m.DECODE: pytest.approx(0.8),
        m.KV_FAULT: pytest.approx(0.2)}
    assert rec.wall_s == pytest.approx(3.0) and not rec.breach
    led.emit(RID, 99.0)
    assert led.finish(RID, 99.0) is None
    return rec.to_dict()


def _shed(m):
    led = m.RequestLedger()
    rec = led.shed(RID, t_start=10.0, t_shed=10.25, t_end=10.3,
                   slo_class="batch")
    m.check_tiling(rec)
    assert rec.shed and rec.breach and rec.ttft_ms is None
    assert rec.seconds == {m.ADMISSION: pytest.approx(0.25),
                           m.SHED: pytest.approx(0.05)}
    return rec.to_dict()


def _stalls(m):
    led = m.RequestLedger()
    led.start(RID, t=0.0, phase=m.PREFILL)
    led.emit(RID, 1.0)
    led.stall(RID, m.WEIGHT_FAULT, -5.0, 0.5)
    led.stall(RID, m.KV_FAULT, 0.4, 0.8)
    led.stall(RID, m.STREAM_STALL, 1.5, 99.0)
    rec = led.finish(RID, 2.0)
    m.check_tiling(rec)
    assert rec.seconds == {
        m.WEIGHT_FAULT: pytest.approx(0.5), m.KV_FAULT: pytest.approx(0.3),
        m.PREFILL: pytest.approx(0.2), m.DECODE: pytest.approx(0.5),
        m.STREAM_STALL: pytest.approx(0.5)}
    return rec.to_dict()


def _random_interleavings(m):
    rng = random.Random(20)
    folded = []
    for round_i in range(30):
        led = m.RequestLedger()
        rids = [f"{round_i:02x}{i:02x}" * 8 for i in range(8)]
        t0 = {rid: rng.uniform(0.0, 10.0) for rid in rids}
        last = dict(t0)
        for rid in rids:
            led.start(rid, t=t0[rid], model="m",
                      phase=rng.choice([m.QUEUE_WAIT, m.ADMISSION]))
        ops = [rid for rid in rids for _ in range(rng.randrange(0, 12))]
        rng.shuffle(ops)
        for rid in ops:
            kind = rng.randrange(4)
            t = last[rid] + rng.uniform(-0.5, 2.0)
            if kind == 0:
                led.mark(rid, rng.choice([m.QUEUE_WAIT, m.ADMISSION,
                                          m.PREFILL, m.DECODE]), t)
            elif kind == 1:
                led.emit(rid, t)
            elif kind == 2:
                led.stall(rid, rng.choice([m.KV_FAULT, m.WEIGHT_FAULT,
                                           m.STREAM_STALL]),
                          t, t + rng.uniform(-0.2, 1.0))
            else:
                led.note_chunk(rid)
            last[rid] = max(last[rid], t)
        for rid in rids:
            rec = led.finish(rid, last[rid] + rng.uniform(-1.0, 1.0))
            m.check_tiling(rec)
            assert set(rec.seconds) <= set(m.PHASES)
            assert sum(rec.seconds.values()) == pytest.approx(rec.wall_s,
                                                              abs=1e-9)
            folded.append(rec.to_dict())
    return folded


def _live_eviction(m):
    led = m.RequestLedger(max_live=4)
    for i in range(8):
        led.start(f"{i:02x}" * 16, t=float(i))
    assert led.live_count() == 4 and led.dropped_live == 4
    a, b = m.synthetic_rid(), m.synthetic_rid()
    assert a != b and len(a) == 32
    int(a, 16)
    return led.rollup()


LEDGER_CASES = {"edge_joined_record_pins_exact_values": _edge_joined,
                "shed_record_pins_admission_plus_shed": _shed,
                "stalls_clip_and_never_overlap": _stalls,
                "property_random_interleavings_tile_exactly":
                    _random_interleavings,
                "live_eviction_and_synthetic_rids": _live_eviction}


@pytest.mark.parametrize("module", sorted(MODULES))
@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_ledger_case(case, module):
    """Each reference case on one module; the port's folded records equal
    the reference's field for field."""
    got = LEDGER_CASES[case](MODULES[module])
    if module == "port":
        assert got == LEDGER_CASES[case](jax_reqobs)


# -- the engines -------------------------------------------------------------


LM = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq_len=64, remat=False)


@pytest.fixture(scope="module")
def lm():
    """(JAX config, JAX params, port config, the params as numpy)."""
    config = JaxConfig(**LM, dtype=jax.numpy.float32)
    params = JaxTransformer(config).init(
        jax.random.key(0), np.zeros((1, 8), np.int32))["params"]
    return (config, params, TransformerConfig(**LM, dtype=torch.float32),
            jax.tree_util.tree_map(np.asarray, params))


class _CountingClock:
    def __init__(self):
        self.reads = 0

    def __call__(self) -> float:
        self.reads += 1
        return time.monotonic()


def _steady_state_reads(config, params, steps_per_sync, paged):
    """Engine clock reads in one steady-state ``run_once`` (live decode,
    no admission, no finish; paged: one page a slot, so no growth)."""
    clock = _CountingClock()
    eng = DecodeEngine(config, params, slots=2,
                       steps_per_sync=steps_per_sync, paged=paged,
                       kv_page_size=64 if paged else None,
                       autostart=False, clock=clock,
                       request_ledger=reqobs.RequestLedger(), device="cpu")
    eng.submit([5, 11, 17], max_new=40)
    eng.run_once(timeout=0.01)
    before = clock.reads
    eng.run_once(timeout=0.01)
    eng.close()
    return clock.reads - before


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_emit_hot_path_adds_no_wall_clock_reads(lm, paged):
    _, _, config, params = lm
    small = _steady_state_reads(config, params, 2, paged)
    large = _steady_state_reads(config, params, 8, paged)
    assert small == large, (small, large)
    assert large <= 6


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_records_tile_and_export_histograms(lm, paged):
    _, _, config, params = lm
    led = reqobs.RequestLedger()
    name = f"tiled-{'paged' if paged else 'dense'}"
    eng = DecodeEngine(config, params, slots=2, autostart=False, name=name,
                       paged=paged, prefill_chunk_tokens=2,
                       request_ledger=led, device="cpu")
    reqs = [eng.submit([5, 11, 17 + i], max_new=6) for i in range(3)]
    while eng.active_count or eng.pending_count:
        eng.run_once(timeout=0.01)
    for r in reqs:
        assert len(r.result()) == 6
    recs = led.records(name)
    assert len(recs) == 3 and led.live_count() == 0
    for rec in recs:
        reqobs.check_tiling(rec)
        assert rec.tokens == 6 and len(rec.itl_ms) == 5
        assert rec.ttft_ms is not None and rec.ttft_ms > 0
        assert reqobs.PREFILL in rec.seconds
        assert reqobs.DECODE in rec.seconds
        assert rec.chunks == (2 if paged else 0)
    text = DEFAULT_REGISTRY.expose()
    assert (f'kftpu_request_ttft_ms_count{{model="{name}",'
            f'slo_class="none"}}') in text
    assert "kftpu_request_phase_seconds_count" in text
    assert "kftpu_request_finished_total" in text
    # each TTFT bucket line carries its latest request's trace as an
    # exemplar; the classic exposition carries none
    ttft_lines = [ln for ln in text.splitlines()
                  if ln.startswith("kftpu_request_ttft_ms_bucket")
                  and f'model="{name}"' in ln]
    assert any(f'# {{trace_id="{recs[-1].rid}"}}' in ln
               for ln in ttft_lines), ttft_lines
    assert "# {trace_id=" not in DEFAULT_REGISTRY.expose(exemplars=False)
    eng.close()


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


def _span_paths(spans):
    """Each span as the names from its root down, with multiplicity."""
    by_id = {s.span_id: s for s in spans}
    paths = []
    for s in spans:
        path, cur = [s.name], s
        while cur.parent_id in by_id:
            cur = by_id[cur.parent_id]
            path.append(cur.name)
        paths.append(tuple(reversed(path)))
        assert s.end >= s.start
    return collections.Counter(paths)


PROMPTS = [[5, 11, 17], [3, 2, 9], [1, 2, 3, 4, 5, 6], [7, 8]]


def _drive(engine_cls, trace_mod, config, params, paged, **kw):
    clock = _FakeClock()
    col = trace_mod.SpanCollector()
    tracer = trace_mod.Tracer(col, clock=clock)
    eng = engine_cls(config, params, slots=4, autostart=False, clock=clock,
                     tracer=tracer, paged=paged, prefill_chunk_tokens=4,
                     kv_page_size=8 if paged else None, name="spans", **kw)
    reqs = []
    for i, p in enumerate(PROMPTS):
        with tracer.span(f"request{i}"):
            reqs.append(eng.submit(p, max_new=5))
    while eng.active_count or eng.pending_count:
        eng.run_once(timeout=0.01)
    streams = [r.result() for r in reqs]
    eng.close()
    return _span_paths(col.spans()), streams


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_spans_nest_as_the_jax_engines(lm, paged):
    """The same requests, each under its own caller span: the port's
    engine records the JAX engine's span names, each under the same
    parents, as many times (burst and row admission in dense mode;
    chunks and shared steps in paged mode)."""
    jc, jparams, pc, params = lm
    want, want_streams = _drive(JaxEngine, jax_trace, jc, jparams, paged,
                                request_ledger=jax_reqobs.RequestLedger())
    got, streams = _drive(DecodeEngine, port_trace, pc, params, paged,
                          request_ledger=reqobs.RequestLedger(),
                          device="cpu")
    assert streams == want_streams
    assert got == want
    names = {p[-1] for p in got}
    assert {"engine.queue_wait", "engine.admit", "engine.first_token",
            "engine.decode"} <= names
    assert ("engine.prefill_chunk" if paged else "engine.prefill") in names


def test_edge_proxy_trace_reaches_the_port_engine(tmp_path, lm):
    """JAX ``EdgeProxy`` → the port's ``ModelServer``: the forged
    ``traceparent`` is stripped, the edge's trace continues into
    ``serving.generate`` and every ``engine.*`` span, and the ledger
    record is keyed by it; ``:predict`` continues it the same way."""
    config, params = lm[:2]
    export_model(str(tmp_path / "lm"), "transformer", params,
                 config=transformer_export_config(config))
    server = ModelServer(str(tmp_path), port=0, poll_interval_s=3600,
                         decode_slots=2, device="cpu")
    port = server.start()
    edge = EdgeProxy([Route("/serving/", f"http://127.0.0.1:{port}")])
    eport = edge.start(0)
    forged = "00-" + "f0" * 16 + "-" + "0b" * 8 + "-01"
    try:
        rids = {}
        for verb, body in ((":generate", {"prompt_tokens": [[5, 11, 17]],
                                          "max_new_tokens": 4}),
                           (":predict", {"instances": [[5, 11, 17]]})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{eport}/serving/v1/models/lm{verb}",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": forged})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                rids[verb] = resp.headers["X-Request-Id"]
                json.loads(resp.read())
        for verb, rid in rids.items():
            assert len(rid) == 32 and rid != "f0" * 16
            spans = port_trace.DEFAULT_COLLECTOR.trace(rid)
            names = sorted(s.name for s in spans)
            root = [s for s in spans if s.name == "serving" + verb.replace(
                ":", ".")]
            assert len(root) == 1 and root[0].attrs["http.status"] == 200
            if verb == ":generate":
                for name in ("engine.queue_wait", "engine.admit",
                             "engine.prefill", "engine.first_token",
                             "engine.decode"):
                    assert name in names, names
                recs = [r for r in reqobs.DEFAULT_LEDGER.records("lm")
                        if r.rid == rid]
                assert len(recs) == 1 and recs[0].tokens == 4
                reqobs.check_tiling(recs[0])
            else:
                assert names == ["serving.predict"]
        assert not port_trace.DEFAULT_COLLECTOR.trace("f0" * 16)
        # /metrics: exemplars only for a scraper that asks for them
        metrics = f"http://127.0.0.1:{port}/metrics"
        with urllib.request.urlopen(metrics, timeout=60) as resp:
            assert "# {trace_id=" not in resp.read().decode()
        req = urllib.request.Request(metrics,
                                     headers={"X-Kftpu-Exemplars": "1"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert (f'# {{trace_id="{rids[":generate"]}"}}'
                    in resp.read().decode())
        edge_spans = jax_trace.DEFAULT_COLLECTOR.trace(rids[":generate"])
        assert [s.name for s in edge_spans] == ["edge.request"]
    finally:
        edge.stop()
        server.stop()
