"""The port's step telemetry (``kubeflow_tpu_torch/obs/steps.py``,
``obs/xprof.py:HbmSampler``, ``examples/common.py:make_step_telemetry``)
beside the JAX package's.

The reference and the port wrap the same fake step on twin fake clocks
(a scripted schedule of step durations, a slow step and a failing one)
and must keep the same flight records, histogram and gauge exposition,
summary, beacons, dump files and step spans. Beacons through a fake
ConfigMap client, ``read_beacons``, ``flag_stragglers`` and
``telemetry_view`` must agree too. The FLOP probe (the first step under
``FlopCounterMode``) on a tiny LM must equal the analytic 6·N·T plus the
dense attention products.
"""

import json
import os

import pytest
import torch

from kubeflow_tpu.obs import steps as ref_steps
from kubeflow_tpu.obs import xprof as ref_xprof
from kubeflow_tpu.obs.trace import SpanCollector as RefCollector
from kubeflow_tpu.obs.trace import Tracer as RefTracer
from kubeflow_tpu.utils.metrics import Registry as RefRegistry
from kubeflow_tpu_torch.examples.common import make_step_telemetry
from kubeflow_tpu_torch.obs import steps, xprof
from kubeflow_tpu_torch.obs.export import parse_otlp_lines
from kubeflow_tpu_torch.obs.trace import SpanCollector, Tracer
from kubeflow_tpu_torch.utils.metrics import Registry

torch.set_num_threads(2)

# seconds each scripted step takes: a slow first step, steady steps, a
# 6x outlier (recompile fallback + slow-step dump), then steady again
SCHEDULE = [2.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.6, 0.1, 0.1, 0.1, 0.1, 0.1]


class ScriptClock:
    """A clock the fake step advances: each step's start-to-end is its
    scheduled duration."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def __call__(self):
        return self.t


class FakeClient:
    """The ConfigMap slice of a Kubernetes client: ``apply``/``list``."""

    def __init__(self):
        self.objects = {}

    def apply(self, obj):
        md = obj["metadata"]
        self.objects[(md.get("namespace"), md["name"])] = json.loads(
            json.dumps(obj))

    def list(self, api_version, kind, ns, label_selector=None):
        sel = label_selector or {}
        return [o for (n, _), o in sorted(self.objects.items())
                if n == ns and all(o["metadata"].get("labels", {}).get(k)
                                   == v for k, v in sel.items())]


def _fake_step(clock):
    def run(state, i):
        if i == "boom":
            clock.t += 0.05
            raise RuntimeError("step failed")
        clock.t += SCHEDULE[i]
        return state + 1, {"loss": 10.0 - i, "grad_norm": 0.5 * i,
                           "skip": float("nan"), "name": "x"}

    return run


def _drive(mod, registry_cls, tracer_cls, collector_cls, tmp, **kw):
    """Run the schedule, a failing step and the beacons through one
    package's telemetry; returns everything the two must agree on."""
    clock = ScriptClock()
    registry = registry_cls()
    collector = collector_cls()
    beacons = []
    client = FakeClient()
    sink = mod.kube_beacon_sink(client, "team", "lm", 3, job_uid="u-1")
    telem = mod.StepTelemetry(
        job="lm", namespace="team", uid="u-1", worker=3, clock=clock,
        registry=registry, tracer=tracer_cls(collector, clock=clock),
        tokens_per_step=4096, examples_per_step=8, span_every=4,
        beacon_sink=lambda b: (beacons.append(dict(b)), sink(b)),
        beacon_every=2, dump_dir=str(tmp), sync=True,
        capacity=8, **kw)
    step = telem.wrap(_fake_step(clock))
    state = 0
    for i in range(len(SCHEDULE)):
        state, _ = step(state, i)
    with pytest.raises(RuntimeError):
        step(state, "boom")
    records = [(r.step, r.start, r.end, r.tokens, r.examples, r.recompile,
                r.status, r.metrics) for r in telem.recorder.records()]
    spans = [s.to_dict() for s in collector.spans()]
    dumps = {}
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name)) as f:
            dumps[name] = f.read()
    return {"records": records, "summary": telem.summary(),
            "expose": registry.expose(), "beacons": beacons,
            "spans": spans, "dumps": dumps, "dump_count": telem.dumps,
            "recompiles": telem.recompiles,
            "series": {m: telem.objective_series(m) for m in (
                "loss", "step_seconds", "steps_per_sec", "tokens_per_sec",
                "examples_per_sec", "mfu")},
            "configmaps": client.objects,
            "read": mod.read_beacons(client, "team", "lm"),
            "read_downsized": mod.read_beacons(client, "team", "lm",
                                               max_workers=2)}


@pytest.mark.parametrize("flops", [None, 3.2e12], ids=["no_mfu", "mfu"])
def test_telemetry_matches_the_reference(tmp_path, flops):
    kw = ({} if flops is None else
          {"flops_per_step": flops, "peak_flops_per_chip": 989e12})
    want = _drive(ref_steps, RefRegistry, RefTracer, RefCollector,
                  tmp_path / "ref", **kw)
    got = _drive(steps, Registry, Tracer, SpanCollector,
                 tmp_path / "port", **kw)
    assert got["records"] == want["records"]
    assert got["summary"] == want["summary"]
    assert got["expose"] == want["expose"]
    assert got["beacons"] == want["beacons"]
    assert got["spans"] == want["spans"]
    assert got["dumps"] == want["dumps"]
    assert got["series"] == want["series"]
    assert got["configmaps"] == want["configmaps"]
    assert got["read"] == want["read"]
    assert got["read_downsized"] == want["read_downsized"] == {}
    # the scripted schedule hits every path: the outlier is a recompile
    # (fallback) and a slow-step dump, the failure a second dump
    assert got["recompiles"] == 1 and got["dump_count"] == 2
    assert sorted(got["dumps"]) == [
        "flight-w3-failure-step13.ndjson",
        "flight-w3-failure-step13.trace.json",
        "flight-w3-slow_step-step7.ndjson",
        "flight-w3-slow_step-step7.trace.json"]
    ndjson = got["dumps"]["flight-w3-failure-step13.ndjson"]
    spans = parse_otlp_lines(ndjson)
    assert len(spans) == 8 and spans[-1].status == "ERROR: RuntimeError"
    assert ("train_step_seconds_bucket" in got["expose"]
            and 'le="300"' in got["expose"])
    if flops:
        assert got["summary"]["mfu"] > 0
    else:
        assert "mfu" not in got["summary"]


def test_beacon_view_and_stragglers_match_the_reference():
    beacons = {
        0: {"step": 120, "stepsPerSec": 2.0, "tokensPerSec": 8192.0,
            "mfu": 0.41, "recompiles": 1,
            "hbm": {"inUseBytes": 5, "peakBytes": 9, "limitBytes": 80}},
        1: {"step": 118, "stepsPerSec": 1.9, "tokensPerSec": 7800.0,
            "mfu": 0.40, "recompiles": 0, "hbm": {}},
        2: {"step": 95, "stepsPerSec": 0.7, "tokensPerSec": 3000.0,
            "mfu": None, "recompiles": 2,
            "hbm": {"inUseBytes": 7, "peakBytes": 8, "limitBytes": 80}},
    }
    for k in (1, 10, 30):
        assert steps.telemetry_view(beacons, k) == \
            ref_steps.telemetry_view(beacons, k)
        assert steps.flag_stragglers({w: b["step"] for w, b in
                                      beacons.items()}, k) == \
            ref_steps.flag_stragglers({w: b["step"] for w, b in
                                       beacons.items()}, k)
    assert steps.telemetry_view({}) == ref_steps.telemetry_view({})
    assert steps.tpujob_trace_ids("ns", "job", "uid") == \
        ref_steps.tpujob_trace_ids("ns", "job", "uid")
    assert steps.step_span_id("ab" * 16, 2, 40) == \
        ref_steps.step_span_id("ab" * 16, 2, 40)
    assert (steps.JOB_NAME_LABEL, steps.TELEMETRY_LABEL,
            steps.TPUJOB_API_VERSION, steps.TPUJOB_KIND) == (
        ref_steps.JOB_NAME_LABEL, ref_steps.TELEMETRY_LABEL,
        *_tpujob_identity())


def _tpujob_identity():
    from kubeflow_tpu.manifests.components.tpujob_operator import (
        API_VERSION,
        TPUJOB_KIND,
    )

    return API_VERSION, TPUJOB_KIND


def test_hbm_sampler_matches_the_reference():
    """Injected stats: the same samples, peaks, beacon blocks and gauge
    rows; a source returning None (the CPU) stays silent in both."""
    samples = [{"bytes_in_use": 100, "peak_bytes_in_use": 150,
                "bytes_limit": 1000},
               {"bytes_in_use": 90, "peak_bytes_in_use": 120,
                "bytes_limit": 1000},
               None]
    ident = dict(namespace="ns", job="hbm-parity", worker=1)
    ref = ref_xprof.HbmSampler(source=iter(samples).__next__, **ident)
    port = xprof.HbmSampler(source=iter(samples).__next__, **ident)
    for _ in samples:
        assert port.sample() == ref.sample()
        assert port.beacon_fields() == ref.beacon_fields()
    assert port.beacon_fields()["peakBytes"] == 150

    def rows(text):
        return sorted(ln for ln in text.splitlines() if "hbm-parity" in ln)

    assert rows(xprof._hbm_g.expose()) == rows(ref_xprof._hbm_g.expose())
    assert rows(xprof._hbm_util_g.expose()) == \
        rows(ref_xprof._hbm_util_g.expose())
    assert len(rows(xprof._hbm_g.expose())) == 3


def test_cpu_degrades_silently(monkeypatch):
    """No card: no memory stats, no peak FLOP/s, no MFU, and the HBM
    sampler adds no beacon block."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("KFTPU_PEAK_TFLOPS", raising=False)
    assert xprof._device_memory_stats() is None
    assert steps._detect_peak_flops() == 0.0
    sampler = xprof.HbmSampler()
    assert sampler.sample() is None and sampler.beacon_fields() == {}
    monkeypatch.setenv("KFTPU_PEAK_TFLOPS", "989")
    assert steps._detect_peak_flops() == 989e12


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A10G", 0.0)])
def test_peak_flops_by_device_name(monkeypatch, name, peak):
    monkeypatch.delenv("KFTPU_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert steps._detect_peak_flops() == peak


def _tiny_lm():
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import tiny_config
    from kubeflow_tpu_torch.train import create_train_state, make_optimizer

    cfg = tiny_config()
    state = create_train_state(cfg, convert.random_params(cfg, 0),
                               make_optimizer(), device="cpu")
    return cfg, state


def test_flop_probe_counts_the_first_step():
    """The first step runs under ``FlopCounterMode``: 6·N·T for the
    matrices (norm scales carry no products; the tied embedding counts
    once, through the head) plus the dense attention's two products,
    forward and backward (12·B·L·S²·D). Later steps are not probed."""
    from kubeflow_tpu_torch.train import make_lm_train_step

    cfg, state = _tiny_lm()
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S))
    telem = steps.StepTelemetry(registry=Registry(), tokens_per_step=B * S,
                                peak_flops_per_chip=1e12)
    step = telem.wrap(make_lm_train_step())
    state, _ = step(state, toks)
    n_matrix = sum(p.numel() for n, p in state.module.named_parameters()
                   if not n.endswith(".scale"))
    want = 6 * n_matrix * B * S + 12 * B * cfg.n_layers * S * S * cfg.d_model
    assert telem.flops_per_step == want
    state, _ = step(state, toks)
    assert telem.flops_per_step == want and telem.mfu() > 0
    # an explicit count wins, and the probe can be switched off
    given = steps.StepTelemetry(registry=Registry(), flops_per_step=5.0)
    off = steps.StepTelemetry(registry=Registry(), use_cost_analysis=False)
    for t in (given, off):
        state, _ = t.wrap(make_lm_train_step())(state, toks)
    assert given.flops_per_step == 5.0 and off.flops_per_step is None


def test_make_step_telemetry_from_the_env(monkeypatch):
    """The env contract: identity from the operator's variables, one
    chip, an HBM sampler; beacons to a given client inside a gang, and
    off (logged) with none."""
    monkeypatch.setenv("KFTPU_JOB_NAME", "lm-job")
    monkeypatch.setenv("KFTPU_NAMESPACE", "team")
    monkeypatch.setenv("KFTPU_PROCESS_ID", "0")
    monkeypatch.setenv("KFTPU_JOB_UID", "uid-7")
    client = FakeClient()
    telem = make_step_telemetry(tokens_per_step=64, client=client,
                                registry=Registry(), beacon_every=1)
    assert (telem.job, telem.namespace, telem.worker, telem.n_chips) == (
        "lm-job", "team", 0, 1)
    assert telem.trace_id == ref_steps.tpujob_trace_ids(
        "team", "lm-job", "uid-7")[0]
    assert isinstance(telem.hbm_sampler, xprof.HbmSampler)
    telem.wrap(lambda: None)()
    cm = client.objects[("team", "lm-job-telemetry-w0")]
    assert cm["metadata"]["ownerReferences"][0]["uid"] == "uid-7"
    assert make_step_telemetry(registry=Registry()).beacon_sink is None
    monkeypatch.setenv("KFTPU_BEACONS", "0")
    assert make_step_telemetry(client=client,
                               registry=Registry()).beacon_sink is None


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_wrap_times_the_call_and_its_sync_alone(monkeypatch, tmp_path, sync):
    """Both packages' ``wrap`` time one window: the wrapped call, plus
    its device sync when ``sync`` is set (the reference's
    ``steps.py:381``). The bookkeeping after the window (the HBM sample,
    the beacon, the step span) runs on the caller's wall clock but not
    in the step's duration, so a caller timing ``step(...)`` itself
    reads the window plus that bookkeeping."""
    CALL, SYNC, HBM, BEACON = 0.100, 0.030, 0.250, 0.125
    got = {}
    for name, mod, xp, reg, tracer, coll in (
            ("ref", ref_steps, ref_xprof, RefRegistry, RefTracer,
             RefCollector),
            ("port", steps, xprof, Registry, Tracer, SpanCollector)):
        clock = ScriptClock()

        def block(out, clock=clock):
            clock.t += SYNC
            return out

        def stats(clock=clock):
            clock.t += HBM
            return {"bytes_in_use": 1.0, "bytes_limit": 2.0,
                    "peak_bytes_in_use": 1.0}

        def sink(_, clock=clock):
            clock.t += BEACON

        def run(state, clock=clock):
            clock.t += CALL
            return state + 1, {"loss": 1.0}

        monkeypatch.setattr(mod, "_block", block)
        telem = mod.StepTelemetry(
            job="lm", namespace="team", worker=0, clock=clock,
            registry=reg(), tracer=tracer(coll(), clock=clock),
            hbm_sampler=xp.HbmSampler(source=stats), beacon_sink=sink,
            beacon_every=1, span_every=1, dump_dir=str(tmp_path / name),
            sync=sync, flops_per_step=1.0)
        step = telem.wrap(run)
        walls = []
        for i in range(4):
            t0 = clock()
            assert step(i)[0] == i + 1
            walls.append(clock() - t0)
        got[name] = ([r.duration for r in telem.recorder.records()], walls)
    assert got["port"] == got["ref"]
    window = CALL + (SYNC if sync else 0.0)
    durations, walls = got["port"]
    assert durations == pytest.approx([window] * 4, abs=1e-6)
    assert walls == pytest.approx([window + HBM + BEACON] * 4, abs=1e-6)
