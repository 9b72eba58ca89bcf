"""The port's model multiplexer (``kubeflow_tpu_torch/serving/
multiplex.py``) against the reference's.

``tests/test_fleet_edge.py``'s multiplexer cases (:764-874) on the port,
each also run on the reference's ``ModelMultiplexer`` with the same fake
loader, clock and calls, and the two snapshots compared key for key:
single-flight faulting, LRU paging that never pages out a pinned model,
leases that block eviction, a failed load that fails its herd and leaves
nothing behind. Then a real store round trip: the reference's
``export_model`` writes MNIST and a thin ResNet, the port pages them on
the CPU with ``max_resident=1``, and ``predict`` stays within 1e-5 of the
reference's ``load_version(...).predict`` at f32, across evictions and
re-faults; the ``weight_fault`` phase lands on the faulting request's
ledger record; and the port's snapshot drives the reference's autoscaler
poll (``MetricsAggregator.observe_engine``).
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.autoscale.metrics import MetricsAggregator
from kubeflow_tpu.serving import model_store as jax_store
from kubeflow_tpu.serving import multiplex as jmux
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.resnet import ResNetConfig
from kubeflow_tpu_torch.obs.requests import WEIGHT_FAULT, RequestLedger
from kubeflow_tpu_torch.obs.trace import Tracer
from kubeflow_tpu_torch.serving import multiplex as mux
from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY

torch.set_num_threads(2)

BOTH = [mux, jmux]


def _ticking():
    t = [0.0]

    def clock():
        t[0] += 0.005
        return t[0]

    return clock


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "jax"])
def test_multiplex_single_flight(pkg):
    """N concurrent requests for one cold model trigger exactly ONE
    load; everyone gets the handle; the cold start surfaces."""
    loads = []
    gate = threading.Event()

    def loader(name):
        loads.append(name)
        gate.wait(2.0)
        return f"<{name}>"

    m = pkg.ModelMultiplexer(loader=loader, max_resident=2,
                             clock=_ticking())
    got = []
    threads = [threading.Thread(target=lambda: got.append(m.get("m")))
               for _ in range(8)]
    for th in threads:
        th.start()
    gate.set()
    for th in threads:
        th.join(5.0)
    assert not any(th.is_alive() for th in threads)
    assert got == ["<m>"] * 8
    assert loads == ["m"]
    snap = m.snapshot()
    assert snap["multiplex_loads"] == 1
    assert snap["models"]["m"]["cold_start_ms"] > 0


def _lru_run(pkg):
    loads = []
    m = pkg.ModelMultiplexer(loader=lambda n: (loads.append(n) or n),
                             max_resident=2, pinned=("hot",))
    steps = [m.resident_models()]
    m.get("a")
    m.get("b")
    steps.append(m.resident_models())
    m.get("a")
    return m, loads, steps


def test_multiplex_lru_pages_out_cold_models_never_pinned():
    m, loads, steps = _lru_run(mux)
    assert steps == [["hot"], ["b", "hot"]]
    assert m.evictions == 2 and loads.count("a") == 2
    snap = m.snapshot()
    assert snap["models_resident"] == 2 and snap["models_pinned"] == 1
    assert snap["models"]["hot"]["pinned"] is True
    assert snap["models_evictable"] == 1
    jm, jloads, jsteps = _lru_run(jmux)
    assert (steps, loads) == (jsteps, jloads)
    mine, ref = m.snapshot(), jm.snapshot()
    for s in (mine, ref):
        for rec in s["models"].values():
            rec["cold_start_ms"] = 0.0
    assert mine == ref


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "jax"])
def test_multiplex_leased_models_are_not_evictable(pkg):
    m = pkg.ModelMultiplexer(loader=lambda n: n, max_resident=1)
    with m.lease("a") as h:
        assert h == "a"
        assert m.snapshot()["models"]["a"]["inflight"] == 1
        with pytest.raises(pkg.MultiplexFull, match="cannot page"):
            m.get("b")
    m.get("b")
    assert m.resident_models() == ["b"]


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "jax"])
def test_multiplex_failed_load_fails_the_herd_then_recovers(pkg):
    calls = []

    def loader(name):
        calls.append(name)
        if len(calls) == 1:
            raise RuntimeError("store unreachable")
        return name

    m = pkg.ModelMultiplexer(loader=loader, max_resident=1)
    with pytest.raises(RuntimeError):
        m.get("m")
    assert m.get("m") == "m"
    for i in range(5):
        with pytest.raises(RuntimeError):
            pkg.ModelMultiplexer(loader=lambda n: (_ for _ in ()).throw(
                RuntimeError("x")), max_resident=1).get(f"bogus{i}")
    assert m._loading == {}


@pytest.mark.parametrize("pkg", BOTH, ids=["port", "jax"])
def test_constructor_refusals(pkg):
    with pytest.raises(ValueError, match="max_resident"):
        pkg.ModelMultiplexer(loader=lambda n: n, max_resident=0)
    with pytest.raises(ValueError, match="cannot fit"):
        pkg.ModelMultiplexer(loader=lambda n: n, max_resident=1,
                             pinned=("a", "b"))
    with pytest.raises(ValueError, match="store_root or loader"):
        pkg.ModelMultiplexer(max_resident=1)


def test_series_are_the_references():
    from kubeflow_tpu.utils import DEFAULT_REGISTRY as JREG

    for name in ("kftpu_multiplex_loads_total",
                 "kftpu_multiplex_evictions_total",
                 "kftpu_multiplex_cold_start_ms",
                 "kftpu_multiplex_resident_models"):
        mine, ref = DEFAULT_REGISTRY._metrics[name], JREG._metrics[name]
        assert (mine.kind, mine.help) == (ref.kind, ref.help)
    before = DEFAULT_REGISTRY.counter(
        "kftpu_multiplex_loads_total").get(model="series-x")
    mux.ModelMultiplexer(loader=lambda n: n, max_resident=1).get("series-x")
    assert DEFAULT_REGISTRY.counter("kftpu_multiplex_loads_total").get(
        model="series-x") == before + 1


def _export_store(root):
    """The reference's exports: MNIST and a thin ResNet (f32)."""
    jax_store.export_model(str(root / "mnist"), "mnist",
                           convert.random_mnist_params(0))
    cfg = dict(stage_sizes=[1, 1], num_classes=10, width=16,
               dtype="float32", bn_dtype="float32", stem="conv",
               fused_bn_conv=False)
    params = convert.random_resnet_params(ResNetConfig(**cfg), 1)
    jax_store.export_model(str(root / "resnet"), "resnet", params,
                           config=cfg, input_shape=(32, 32, 3))


def test_real_store_round_trip_pages_and_predicts_like_the_reference(
        tmp_path):
    _export_store(tmp_path)
    rng = np.random.default_rng(3)
    inputs = {"mnist": rng.standard_normal((3, 28, 28, 1)).astype(
        np.float32), "resnet": rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)}
    want = {name: np.asarray(jax_store.load_version(
        str(tmp_path / name), 1).predict(jnp.asarray(x)))
        for name, x in inputs.items()}
    m = mux.ModelMultiplexer(str(tmp_path), max_resident=1, device="cpu")
    for name in ("mnist", "resnet", "mnist"):      # A, B (A out), A again
        with m.lease(name) as loaded:
            assert loaded.kind == name and loaded.version == 1
            assert loaded.device == torch.device("cpu")
            out = loaded.predict(inputs[name])
        np.testing.assert_allclose(out, want[name], atol=1e-5, rtol=0)
        assert m.resident_models() == [name]
    snap = m.snapshot()
    assert (snap["multiplex_loads"], snap["multiplex_evictions"]) == (3, 2)
    assert snap["models"]["mnist"]["cold_start_ms"] > 0
    with pytest.raises(FileNotFoundError):
        m.get("nope")


def test_the_default_loader_targets_cuda(tmp_path, monkeypatch):
    """Without ``device`` the store loader asks ``load_version`` for its
    default device, CUDA (which refuses on a machine without it)."""
    from kubeflow_tpu_torch.serving import model_store

    _export_store(tmp_path)
    seen = []
    real = model_store.load_version

    def spy(base, version, *, device=None, mesh=None):
        seen.append(device)
        return real(base, version, device="cpu", mesh=mesh)

    monkeypatch.setattr(model_store, "load_version", spy)
    mux.ModelMultiplexer(str(tmp_path), max_resident=1).get("mnist")
    mux.ModelMultiplexer(str(tmp_path), max_resident=1,
                         device="cpu").get("mnist")
    assert seen == [None, "cpu"]


def test_cold_start_is_the_requests_weight_fault_phase():
    ledger = RequestLedger()
    tracer = Tracer()
    clock = _ticking()
    m = mux.ModelMultiplexer(loader=lambda n: n, max_resident=1,
                             clock=clock, request_ledger=ledger)
    with tracer.span("serving.predict") as span:
        rid = span.trace_id
        ledger.start(rid, t=clock(), model="m")
        m.get("m")
        ledger.finish(rid, t=clock())
    rec = ledger.records("m")[-1]
    assert rec.seconds.get(WEIGHT_FAULT, 0.0) > 0
    assert any(p == WEIGHT_FAULT for _, _, p in rec.intervals)


def test_snapshot_feeds_the_references_autoscaler_poll():
    """A pager at full residency with every model leased reads as load;
    idle unpinned models read as reclaimable cache."""
    m = mux.ModelMultiplexer(loader=lambda n: n, max_resident=2)
    t = [100.0]
    leases = [m.lease("a"), m.lease("b")]
    agg = MetricsAggregator(clock=lambda: t[0])
    agg.observe_engine("m", m)
    assert agg.window("m", 10.0).concurrency == pytest.approx(2.0)
    for lease in leases:
        lease.__exit__(None, None, None)
    t[0] += 30.0
    agg2 = MetricsAggregator(clock=lambda: t[0])
    agg2.observe_engine("m", m)
    assert agg2.window("m", 10.0).concurrency == 0.0
    snap = m.snapshot()
    assert {"active_slots", "pending", "slots", "closed", "multiplex",
            "models_resident", "models_max", "models_evictable",
            "models_loading", "models_pinned", "multiplex_loads",
            "multiplex_evictions", "models"} <= set(snap)


def test_an_evicted_model_is_freed_at_once(tmp_path):
    """Paging out drops the last reference the multiplexer holds, and no
    reference cycle keeps the model: with the cycle collector off, the
    evicted model's module is gone as soon as the caller drops its
    handle (on the card its weights go back to the allocator then)."""
    import gc
    import weakref

    _export_store(tmp_path)
    m = mux.ModelMultiplexer(str(tmp_path), max_resident=1, device="cpu")
    gc.disable()
    try:
        with m.lease("resnet") as handle:
            handle.predict(np.zeros((1, 32, 32, 3), np.float32))
            gone = weakref.ref(handle.module)
        del handle
        assert gone() is not None          # still resident
        m.get("mnist")                     # pages resnet out
        assert gone() is None
    finally:
        gc.enable()
