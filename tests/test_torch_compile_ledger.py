"""The port's compile ledger and memory budgets (``kubeflow_tpu_torch/
obs/xprof.py``) against the reference's ``kubeflow_tpu/obs/xprof.py``.

``tests/test_xprof.py``'s cases on the port: the series' names, help
and labels; shape classes and span ids equal the reference's; a record
lands as a histogram observation, a ``compile`` span under the job's
root and the job totals, with the reference's summary for the same
records; the event list is bounded; install is idempotent, a second
ledger's install sweeps the first's listener, uninstall removes only its
own. Then the port's compile, the ``nvcc`` builds of ``ops/_build.py``,
through a stub ``nvcc`` that writes the library: one event a source with
its library's digest, nothing for a library found on disk, and the job
total of a parallel build within the build call's wall time though the
sources' own seconds sum past it. ``make_compile_ledger`` from the env
contract; ``timed_compile`` and the budgets on the CPU (``{}``: the
allocator measures CUDA tensors only).
"""

import os
import stat
import sys
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.obs import xprof as jxprof
from kubeflow_tpu.utils import DEFAULT_REGISTRY as JREG
from kubeflow_tpu_torch.examples import common
from kubeflow_tpu_torch.obs import xprof
from kubeflow_tpu_torch.obs.steps import tpujob_trace_ids
from kubeflow_tpu_torch.obs.trace import SpanCollector, Tracer
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY


class SetClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


@pytest.mark.parametrize("name", ["kftpu_compile_seconds",
                                  "kftpu_hbm_budget_bytes",
                                  "kftpu_hbm_bytes",
                                  "kftpu_hbm_utilization"])
def test_series_names_help_and_kind_are_the_references(name):
    mine, ref = DEFAULT_REGISTRY._metrics[name], JREG._metrics[name]
    assert (mine.kind, mine.help) == (ref.kind, ref.help)
    assert xprof.BUDGET_KINDS == jxprof.BUDGET_KINDS
    assert xprof.HBM_KINDS == jxprof.HBM_KINDS


def test_shape_class_of_matches_reference():
    x, y = torch.ones(8, 200, dtype=torch.bfloat16), torch.ones(8)
    jx, jy = jnp.ones((8, 200), jnp.bfloat16), jnp.ones((8,))
    assert xprof.shape_class_of(x) == jxprof.shape_class_of(jx) == \
        "seq256_bfloat16"
    assert xprof.shape_class_of((x, {"y": y})) == \
        jxprof.shape_class_of((jx, {"y": jy}))
    assert xprof.shape_class_of(1.0, 2) == "scalar"
    assert xprof.shape_class_of() == "scalar"


def test_compile_span_id_matches_reference():
    tid, _ = tpujob_trace_ids("t", "rec", "u1")
    assert xprof.compile_span_id(tid, 2, "m", 3) == \
        jxprof.compile_span_id(tid, 2, "m", 3)


def test_ledger_record_metric_span_totals():
    clock = SetClock(500.0)
    collector = SpanCollector()
    ledger = xprof.CompileLedger(namespace="t", job="rec", uid="u1",
                                 worker=2, clock=clock,
                                 tracer=Tracer(collector, clock=clock),
                                 generation="sm_90")
    assert xprof.job_compile_seconds("t", "rec") == 0.0
    ev = ledger.record("train_step", 4.25, shape_class="seq512_bfloat16",
                       fingerprint="abcd" * 4)
    assert ev.seconds == 4.25 and ev.end == 500.0 and ev.start == 495.75
    assert xprof.job_compile_seconds("t", "rec") == 4.25
    assert xprof.job_compile_totals("t", "rec")["count"] == 1

    h = DEFAULT_REGISTRY.histogram("kftpu_compile_seconds")
    labels = dict(module="train_step", shape_class="seq512_bfloat16",
                  generation="sm_90", namespace="t", job="rec")
    assert h.get(**labels) == 1
    assert h.sum(**labels) == pytest.approx(4.25)

    tid, root = tpujob_trace_ids("t", "rec", "u1")
    spans = [s for s in collector.spans() if s.name == "compile/train_step"]
    assert len(spans) == 1
    sp = spans[0]
    assert sp.trace_id == tid and sp.parent_id == root
    assert sp.span_id == xprof.compile_span_id(tid, 2, "train_step", 0)
    assert sp.duration == pytest.approx(4.25)
    assert sp.attrs["fingerprint"] == "abcd" * 4

    ledger.record("train_step", 1.0)
    spans = [s for s in collector.spans() if s.name == "compile/train_step"]
    assert spans[1].span_id == xprof.compile_span_id(tid, 2, "train_step",
                                                     1)
    assert ledger.total_seconds() == pytest.approx(5.25)
    s = ledger.summary()
    assert s["count"] == 2 and s["seconds"] == pytest.approx(5.25)
    assert s["by_module"]["train_step"] == pytest.approx(5.25)


def test_summary_and_payload_equal_the_references_for_the_same_records():
    clock = SetClock(50.0)
    mine = xprof.CompileLedger(namespace="t", job="same-p", clock=clock,
                               generation="sm_90")
    ref = jxprof.CompileLedger(namespace="t", job="same-r", clock=clock,
                               generation="sm_90")
    for ledger in (mine, ref):
        for module, secs in (("a", 1.5), ("b", 0.25), ("a", 2.0)):
            clock.now += 3.0
            ledger.record(module, secs, shape_class="seq128_float32",
                          fingerprint="f" * 16)
        clock.now = 50.0
    assert mine.summary() == ref.summary()
    assert mine.events_payload() == ref.events_payload()
    assert xprof.job_compile_totals("t", "same-p") == \
        jxprof.job_compile_totals("t", "same-r")


def test_ledger_event_capacity_bounded():
    ledger = xprof.CompileLedger(capacity=4, generation="cpu")
    for i in range(10):
        ledger.record(f"m{i}", 0.1)
    assert len(ledger.events) == 4
    assert ledger.events[-1].module == "m9"


def test_no_job_no_totals():
    assert xprof.job_compile_seconds("t", "never-seen") is None
    assert xprof.job_compile_totals("t", "never-seen") == {
        "seconds": 0.0, "count": 0}


def _event(name="paged_attention", start=10.0, seconds=2.0):
    return _build.BuildEvent(name=name, fingerprint="9" * 16,
                             seconds=seconds, start=start,
                             end=start + seconds)


def test_install_idempotent_uninstall_removes_only_its_own():
    other = lambda event: None  # noqa: E731 — a foreign listener
    _build.listeners.append(other)
    ledger = xprof.CompileLedger(namespace="t", job="inst",
                                 generation="sm_90")
    try:
        assert ledger.install() is True
        assert ledger.install() is False
        for cb in list(_build.listeners):
            cb(_event())
        assert len(ledger.events) == 1
        assert ledger.events[0].module == "paged_attention.cu"
        assert ledger.events[0].shape_class == xprof.BUILD_SHAPE_CLASS
        assert xprof.job_compile_seconds("t", "inst") == pytest.approx(2.0)
        assert ledger.uninstall() is True
        assert ledger.uninstall() is False
        assert other in _build.listeners
        for cb in list(_build.listeners):
            cb(_event(start=20.0))
        assert len(ledger.events) == 1
    finally:
        _build.listeners.remove(other)
        ledger.uninstall()


def test_second_ledger_install_evicts_marked_listener():
    a = xprof.CompileLedger(namespace="t", job="dup-a", generation="sm_90")
    b = xprof.CompileLedger(namespace="t", job="dup-b", generation="sm_90")
    assert a.install() and b.install()
    try:
        for cb in list(_build.listeners):
            cb(_event(seconds=1.0))
        assert xprof.job_compile_seconds("t", "dup-a") == 0.0
        assert xprof.job_compile_seconds("t", "dup-b") == 1.0
    finally:
        b.uninstall()
        a.uninstall()
    assert not any(getattr(cb, "_kftpu_compile_listener", False)
                   for cb in _build.listeners)


def test_overlapping_builds_charge_the_job_once():
    """Three sources built together over [10, 12], [10, 13], [11, 12]:
    each event keeps its own seconds, the job is charged the union."""
    ledger = xprof.CompileLedger(namespace="t", job="overlap",
                                 generation="sm_90")
    ledger._on_build(_event("a", 10.0, 2.0))
    ledger._on_build(_event("b", 10.0, 3.0))
    ledger._on_build(_event("c", 11.0, 1.0))
    assert [e.seconds for e in ledger.events] == [2.0, 3.0, 1.0]
    assert xprof.job_compile_seconds("t", "overlap") == pytest.approx(3.0)
    assert ledger.total_seconds() == pytest.approx(3.0)
    assert xprof.job_compile_totals("t", "overlap")["count"] == 3
    ledger._on_build(_event("d", 20.0, 0.5))      # a later, separate build
    assert ledger.total_seconds() == pytest.approx(3.5)


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` on PATH that sleeps, then writes the ``-o`` file."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.4)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'stub library')\n"
        "print('ptxas info    : Used 32 registers')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return tmp_path / "build"


def test_build_hook_records_one_event_a_source_and_nothing_cached(
        stub_nvcc):
    clock_ledger = xprof.CompileLedger(namespace="t", job="hook",
                                       uid="u", generation="sm_90")
    collector = SpanCollector()
    clock_ledger.tracer = Tracer(collector, clock=time.time)
    with clock_ledger:
        t0 = time.perf_counter()
        logs = _build.build(["fused_sample"], build_dir=str(stub_nvcc))
        wall = time.perf_counter() - t0
        assert "registers" in logs["fused_sample"]
        assert len(clock_ledger.events) == 1
        ev = clock_ledger.events[0]
        _, lib, digest = _build._target("fused_sample", str(stub_nvcc))
        assert os.path.exists(lib)
        assert ev.module == "fused_sample.cu" and ev.fingerprint == digest
        assert lib.endswith(f"-{digest}.so")
        assert 0.4 <= ev.seconds <= wall
        span = [s for s in collector.spans()
                if s.name == "compile/fused_sample.cu"]
        assert span and span[0].trace_id == tpujob_trace_ids(
            "t", "hook", "u")[0]
        # a second build finds the library on disk: no compile, no event
        _build.build(["fused_sample"], build_dir=str(stub_nvcc))
        assert len(clock_ledger.events) == 1


def test_parallel_build_total_within_the_build_wall(stub_nvcc):
    """The pin: every nvcc of a build call runs at once, so the sources'
    own seconds sum past the call's wall, and the job total must not."""
    ledger = xprof.CompileLedger(namespace="t", job="parallel",
                                 generation="sm_90")
    names = ["paged_attention", "fused_sample", "flash_attention",
             "bnconv"]
    with ledger:
        t0 = time.perf_counter()
        _build.build(names, build_dir=str(stub_nvcc))
        wall = time.perf_counter() - t0
    assert sorted(e.module for e in ledger.events) == sorted(
        f"{n}.cu" for n in names)
    own = sum(e.seconds for e in ledger.events)
    total = xprof.job_compile_seconds("t", "parallel")
    assert own > wall, (own, wall)
    assert 0.4 <= total <= wall, (total, wall)
    assert ledger.summary()["seconds"] == pytest.approx(total, abs=1e-6)


def test_a_raising_listener_never_fails_the_build(stub_nvcc):
    def boom(event):
        raise RuntimeError("listener fault")

    _build.listeners.append(boom)
    try:
        _build.build(["bnconv"], build_dir=str(stub_nvcc))
    finally:
        _build.listeners.remove(boom)
    assert os.path.exists(_build._target("bnconv", str(stub_nvcc))[1])


def test_make_compile_ledger_from_the_env_contract(monkeypatch):
    monkeypatch.setenv("KFTPU_JOB_NAME", "envjob")
    monkeypatch.setenv("KFTPU_NAMESPACE", "team")
    monkeypatch.setenv("KFTPU_JOB_UID", "uid-7")
    monkeypatch.setenv("KFTPU_PROCESS_ID", "3")
    ledger = common.make_compile_ledger()
    try:
        assert (ledger.namespace, ledger.job, ledger.worker) == (
            "team", "envjob", 3)
        assert (ledger.trace_id, ledger.root_span_id) == \
            tpujob_trace_ids("team", "envjob", "uid-7")
        assert ledger._listener in _build.listeners
        assert xprof.job_compile_seconds("team", "envjob") == 0.0
    finally:
        ledger.uninstall()
    idle = common.make_compile_ledger(install=False)
    assert idle._listener is None


def test_timed_compile_times_the_first_call():
    clock = SetClock(10.0)
    ledger = xprof.CompileLedger(namespace="t", job="first", clock=clock,
                                 generation="cpu")
    x = torch.ones(16, 16)

    def mm(v):
        clock.now += 0.5
        return v @ v

    out = ledger.timed_compile(mm, x, module="mm")
    assert torch.equal(out, x @ x)
    ev = ledger.events[-1]
    assert (ev.module, ev.shape_class, ev.seconds) == ("mm",
                                                       "seq128_float32",
                                                       0.5)
    assert ev.fingerprint == xprof.call_fingerprint(mm, x)
    assert len(ev.fingerprint) == 16
    # CPU tensors: the allocator measures nothing, no budget is kept
    assert xprof.budget_for(ev.fingerprint) is None


def test_memory_budget_on_the_cpu_is_empty_and_never_raises():
    assert xprof.memory_budget(lambda v: v * 2, torch.ones(4)) == {}

    def broken(v):
        raise RuntimeError("no")

    assert xprof.memory_budget(broken, torch.ones(4)) == {}
    assert xprof.record_memory_budget(lambda v: v + 1, torch.ones(4),
                                      module="cpu") == {}
    assert xprof.budget_for("not-a-fingerprint") is None


def test_budget_walk_skips_cpu_tensors():
    """The tensor walk behind the budget (CUDA tensors only, so on the
    CPU it is checked through its storage map directly)."""
    seen = {}
    xprof._cuda_tensors((torch.ones(2), [torch.ones(3)]), seen, set())
    assert seen == {}


def test_ledger_threads_record_every_event():
    ledger = xprof.CompileLedger(namespace="t", job="threads",
                                 generation="sm_90", capacity=1000)
    workers = [threading.Thread(target=lambda: [
        ledger.record("m", 0.01) for _ in range(50)]) for _ in range(8)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(10.0)
    assert not any(w.is_alive() for w in workers)
    assert len(ledger.events) == 400
    assert xprof.job_compile_totals("t", "threads")["count"] == 400
