"""The port's elastic plane against ``kubeflow_tpu/elastic``, and the
Podracer example against the reference's.

One counterpart for each reference test in ``tests/test_elastic.py``
but the operator-validation ones (control plane only):

- a 4-rank gloo gang (``tests/torch_gang.py``, suite ``elastic``) runs
  the spec derivation at 2 and 1 slices of tp 2, then shrinks a live
  run from 2 slices to 1 through the coordinator: ranks 2-3 take part
  in the snapshot and leave, ranks 0-1 re-enter a fresh group of 2
  through the production re-init. Here the reference's coordinator
  runs the reference test's shape, 4 → 2 slices of 2 devices, on the
  same weights (numpy seeds, carried across by ``models/convert.py``)
  and batches: losses and grad norms for steps 1-4 agree within 1e-5,
  the restored state is the snapshot bit for bit, and the spans are the
  reference's, under its trace ids;
- in this process, at world 1 (every slice count maps onto the one-rank
  mesh: these tests hold the protocol, not the topology), the
  snapshotter, ``DirCheckpointer`` over the port's checkpoint, the
  coordinator's shrink, ``SHUTDOWN`` and re-gang, the no-op at the
  target, the newer signal that survives a resize, a wrong-model
  restore, ``cr_resize_target`` on the reference's ``FakeKubeClient``,
  and the reference's end-to-end shrink with the port's
  ``DirCheckpointer`` injected into the reference's ``TpuJobOperator``;
- Podracer: the port's ``main`` at the reference test's arguments, and
  the REINFORCE update held against the reference's ``make_update`` on
  the same trajectories and parameters within 1e-5 at f32.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.elastic import ElasticCoordinator as JaxCoordinator
from kubeflow_tpu.elastic import ResizeSignal as JaxSignal
from kubeflow_tpu.elastic import mesh_for_slices as jax_mesh_for_slices
from kubeflow_tpu.elastic import shardings_for as jax_shardings_for
from kubeflow_tpu.elastic import validate_global_shapes as jax_validate
from kubeflow_tpu.k8s import FakeKubeClient
from kubeflow_tpu.manifests.components.tpujob_operator import (
    API_VERSION,
    TPUJOB_KIND,
)
from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.obs.steps import tpujob_trace_ids as jax_trace_ids
from kubeflow_tpu.operators.tpujob import JOB_LABEL, TpuJobOperator, tpujob
from kubeflow_tpu.platform.local import fake_slice_nodes
from kubeflow_tpu.scheduler.queue import GangQueue
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu.train.checkpoint import CheckpointManager as JaxManager
from kubeflow_tpu.utils import DEFAULT_REGISTRY as JAX_REGISTRY
from kubeflow_tpu_torch.elastic import (
    DirCheckpointer,
    ElasticCoordinator,
    ElasticSnapshotter,
    ReshardMismatchError,
    ResizeSignal,
    cr_resize_target,
    lm_init_fn,
    mesh_for_slices,
    restore_resharded,
    shard_put,
    validate_global_shapes,
)
from kubeflow_tpu_torch.elastic.coordinator import SHUTDOWN
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import tiny_config
from kubeflow_tpu_torch.obs.goodput import checkpoint_save_seconds
from kubeflow_tpu_torch.obs.steps import publish_beacon, tpujob_trace_ids
from kubeflow_tpu_torch.obs.trace import SpanCollector, Tracer
from kubeflow_tpu_torch.operators.tpujob import API_VERSION as PORT_API
from kubeflow_tpu_torch.operators.tpujob import TPUJOB_KIND as PORT_KIND
from kubeflow_tpu_torch.train import make_lm_train_step, make_optimizer
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from torch_gang import (
    ELASTIC_CFG,
    ELASTIC_JOB,
    ELASTIC_OPT,
    Gang,
    elastic_tokens,
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("elastic", 4, tmp_path_factory.mktemp("elastic-gang"))


class FakeClock:
    def __init__(self, start=1000.0, step=0.5):
        self.t = start
        self.step = step
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self.t += self.step
            return self.t


def port_config(**kw):
    return tiny_config(**{**ELASTIC_CFG, **kw})


def port_init_fn(**kw):
    cfg = port_config(**kw)
    return lm_init_fn(cfg, convert.random_params(cfg, 0),
                      make_optimizer(**ELASTIC_OPT))


def one_rank_mesh(_n):
    """Every slice count onto the one-rank mesh of this process."""
    return mesh_for_slices(1, device_type="cpu")


def data_fn(step):
    return (elastic_tokens(step),)


def make_coordinator(tmp_path, **kw):
    kw.setdefault("manager", CheckpointManager(str(tmp_path / "ckpt")))
    kw.setdefault("init_fn", port_init_fn())
    kw.setdefault("make_step", make_lm_train_step)
    kw.setdefault("mesh_factory", one_rank_mesh)
    kw.setdefault("reinit", lambda n: None)
    kw.setdefault("device", "cpu")
    return ElasticCoordinator(**kw)


def snapshot_of(state):
    """Parameters and both moments, copied."""
    return ([p.detach().clone() for p in state.params],
            [t.clone() for t in state.opt_state["mu"]],
            [t.clone() for t in state.opt_state["nu"]])


def same(a, b) -> bool:
    return all(torch.equal(x, y) for xs, ys in zip(a, b)
               for x, y in zip(xs, ys))


def trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(trees_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


# -- the gang: a shrink across real ranks -------------------------------------


_JAX_RUN = {}


def jax_elastic_run(tmp_path_factory):
    """The reference's coordinator at the reference test's shape: 4
    slices of 2 devices for steps 1-3, the resize, 2 slices for step 4,
    on the port's weights and batches. Loss and grad norm a step."""
    if "run" in _JAX_RUN:
        return _JAX_RUN["run"]
    cfg = JaxConfig(**ELASTIC_CFG, dtype=jnp.float32)
    model = JaxTransformer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, convert.unflatten(
        convert.random_params(port_config(), 0)))
    tx = jax_optimizer(**ELASTIC_OPT)

    def init_fn(rng):
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    from kubeflow_tpu.obs.trace import SpanCollector as JaxCollector
    from kubeflow_tpu.obs.trace import Tracer as JaxTracer

    collector, signal = JaxCollector(), JaxSignal()
    coord = JaxCoordinator(
        manager=JaxManager(str(tmp_path_factory.mktemp("jax-elastic"))),
        init_fn=init_fn, make_step=lambda m: jax_step(m),
        mesh_factory=lambda n: jax_mesh_for_slices(
            n, devices=jax.devices()[:2 * n]),
        signal=signal, reinit=lambda n: None, tracer=JaxTracer(collector),
        **ELASTIC_JOB)
    state, _ = coord.start(4)
    metrics = []
    for step in (1, 2, 3, 4):
        if step == 4:
            signal.request(2)
            state, resized = coord.maybe_resize(state)
            assert resized
        state, m = coord.step_fn(state, jnp.asarray(elastic_tokens(step)))
        coord.step = step
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    _JAX_RUN["run"] = (metrics, [s.name for s in collector.spans()
                                 if s.name.startswith("elastic.")])
    return _JAX_RUN["run"]


def test_shrink_across_ranks_matches_the_reference(gang, tmp_path_factory):
    """2 slices x tp 2 → 1 slice x tp 2 on 4 gloo ranks: the losses of
    steps 1-4 within 1e-5 of the reference's 4 → 2 slices; ranks 2-3
    snapshot and leave; ranks 0-1 restore the snapshot bit for bit on a
    fresh group of 2 and take step 4 with the step clock intact."""
    want, jax_spans = jax_elastic_run(tmp_path_factory)
    got = gang.case("shrink")
    for rank, g in enumerate(got):
        assert g["start"] == 0 and g["world"] == 4 and g["saves"] == 1
        assert g["left"] is (rank >= 2), rank
        n = 3 if g["left"] else 4
        for (loss, gnorm, step), (wl, wg, ws) in zip(g["metrics"],
                                                     want[:n]):
            assert step == ws
            np.testing.assert_allclose(loss, wl, atol=1e-5, rtol=0,
                                       err_msg=f"loss, rank {rank}")
            np.testing.assert_allclose(gnorm, wg, rtol=1e-5,
                                       err_msg=f"grad_norm, rank {rank}")
        assert len(g["metrics"]) == n
    for g in got[:2]:
        assert g["resized"] and g["n_slices"] == 1 and g["new_world"] == 2
        assert g["state_step"] == 4
        assert trees_equal(g["pre"], g["post"])    # bit-identical restore
        assert g["pre"]["step"] == 3 and g["pre"]["opt_state"]["count"] == 3


def test_resize_spans_are_the_references(gang, tmp_path_factory):
    """The port's snapshot → reshard → resume spans, in the reference's
    order, under the reference's trace id and root span for the job."""
    _, jax_spans = jax_elastic_run(tmp_path_factory)
    trace_id, root = jax_trace_ids(ELASTIC_JOB["namespace"],
                                   ELASTIC_JOB["job"], ELASTIC_JOB["uid"])
    assert (trace_id, root) == tpujob_trace_ids(
        ELASTIC_JOB["namespace"], ELASTIC_JOB["job"], ELASTIC_JOB["uid"])
    for g in gang.case("shrink")[:2]:
        assert [s[0] for s in g["spans"]] == jax_spans == [
            "elastic.snapshot", "elastic.reshard", "elastic.resume"]
        assert all(s[1] == trace_id and s[2] == root for s in g["spans"])


def test_shardings_follow_logical_axes_on_both_topologies(gang):
    """The same PartitionSpecs at 2 slices and at 1 (the remap's whole
    trick), as the reference's at 4 and 2; the split leaves name tp."""
    for specs in gang.case("specs"):
        assert specs[2] == specs[1]
        module = specs[1]["module"]
        assert any("tp" in tuple(s) for s in module.values())
        assert any(tuple(s) == () for s in module.values())
        assert specs[1]["opt_state"]["mu"] == specs[1]["opt_state"]["nu"]
    cfg = JaxConfig(**ELASTIC_CFG, dtype=jnp.float32)
    model = JaxTransformer(cfg)
    tx = jax_optimizer(**ELASTIC_OPT)

    def init_fn(rng):
        params = model.init(rng, jnp.zeros((8, 8), jnp.int32))["params"]
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    abstract = jax.eval_shape(init_fn, jax.random.key(0))
    ref = [jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda s: tuple(s.spec), jax_shardings_for(
            abstract, jax_mesh_for_slices(n, devices=jax.devices()[:2 * n])),
        is_leaf=lambda x: hasattr(x, "spec"))) for n in (4, 2)]
    assert ref[0] == ref[1]


# -- reshard ------------------------------------------------------------------


def test_validate_global_shapes_raises_on_mismatch():
    """The reference's two messages, on the port's tensors."""
    good = {"w": torch.zeros(4, 2), "b": torch.zeros(2)}
    validate_global_shapes(good, {"w": torch.zeros(4, 2),
                                  "b": torch.zeros(2)})
    for check, zeros, err in (
            (validate_global_shapes, torch.zeros, ReshardMismatchError),
            (jax_validate, jnp.zeros, ValueError)):
        good = {"w": zeros((4, 2)), "b": zeros((2,))}
        with pytest.raises(err, match="global shape"):
            check(good, {"w": zeros((4, 3)), "b": zeros((2,))})
        with pytest.raises(err, match="structure"):
            check(good, {"w": zeros((4, 2))})
    with pytest.raises(ReshardMismatchError, match="global shape"):
        validate_global_shapes({"w": torch.zeros(4)},
                               {"w": torch.zeros(4, dtype=torch.float64)})


def test_restore_resharded_is_bit_identical_and_refuses_a_wrong_model(
        tmp_path):
    init_fn = port_init_fn()
    mesh = one_rank_mesh(1)
    state = init_fn(mesh, torch.device("cpu"))
    state, _ = make_lm_train_step(mesh)(state, elastic_tokens(1))
    state, _ = make_lm_train_step(mesh)(state, elastic_tokens(2))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state, wait=True)
    restored = restore_resharded(mgr, init_fn, one_rank_mesh(1), step=2,
                                 device="cpu")
    assert same(snapshot_of(state), snapshot_of(restored))
    assert restored.step == 2 and restored.opt_state["count"] == 2
    assert restored.module is not state.module
    with pytest.raises(ReshardMismatchError, match="global shape"):
        restore_resharded(mgr, port_init_fn(d_ff=96), mesh, device="cpu")
    with pytest.raises(ReshardMismatchError, match="structure"):
        restore_resharded(mgr, port_init_fn(n_layers=3), mesh,
                          device="cpu")


def test_mesh_for_slices_checks_and_device_slices():
    """The reference's two refusals; a slice of this process's devices
    places a live tree whole, as a copy, and refuses a split."""
    with pytest.raises(ValueError, match="do not divide into 3 slices"):
        mesh_for_slices(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide slice size 1"):
        mesh_for_slices(2, devices=["cpu"] * 2, tp=2)
    with pytest.raises(ValueError, match="n_slices must be >= 1"):
        mesh_for_slices(0)
    sl = mesh_for_slices(1, devices=["cpu"] * 2)
    tree = {"k": torch.arange(8.0).reshape(2, 4), "n": 3}
    placed = shard_put(tree, sl)
    assert torch.equal(placed["k"], tree["k"]) and placed["n"] == 3
    assert placed["k"].data_ptr() != tree["k"].data_ptr()
    with pytest.raises(ValueError, match="cannot split a leaf"):
        shard_put(tree, mesh_for_slices(1, devices=["cpu"] * 2, tp=2),
                  axes_fn=lambda path, leaf: ("embed", "mlp")[:leaf.ndim])


# -- snapshot discipline ------------------------------------------------------


def test_snapshotter_exactly_once_per_step():
    class Recorder:
        def __init__(self):
            self.saves = []

        def save(self, step, state, wait=False):
            assert wait, "resize snapshots must be synchronous"
            self.saves.append(step)

    rec = Recorder()
    before = checkpoint_save_seconds("d", "snap-job")
    snap = ElasticSnapshotter(rec, clock=FakeClock(step=0.25),
                              job="snap-job", namespace="d")
    assert snap.snapshot(7, {"w": 1}) == 7
    assert snap.snapshot(7, {"w": 1}) == 7   # signal raced the loop
    assert rec.saves == [7]
    assert snap.snapshot(9, {"w": 2}) == 9   # a later resize saves again
    assert rec.saves == [7, 9] and snap.saves == 2 and snap.last_step == 9
    assert checkpoint_save_seconds("d", "snap-job") == before + 0.5


def test_dir_checkpointer_reads_spec_checkpoint_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "job"))
    mgr.save(12, {"w": torch.arange(4.0)}, wait=True)
    mgr.close()
    ckpt = DirCheckpointer()
    job = {"metadata": {"namespace": "d", "name": "j"},
           "spec": {"checkpointDir": str(tmp_path / "job")}}
    assert ckpt.save(job) == 12
    # the queue's victim-cost read resolves through the learned dir
    assert ckpt.latest_step("d", "j") == 12
    assert ckpt.latest_step("d", "unknown") is None
    assert ckpt.save({"metadata": {}, "spec": {}}) is None
    # a step another process writes later is seen (reload, then read)
    CheckpointManager(str(tmp_path / "job")).save(
        13, {"w": torch.arange(4.0)}, wait=True)
    assert ckpt.latest_step("d", "j") == 13
    ckpt.close()


# -- the worker-side coordinator ---------------------------------------------


def test_coordinator_shrink_resume_and_spans(tmp_path):
    collector = SpanCollector()
    signal = ResizeSignal()
    coord = make_coordinator(tmp_path, signal=signal,
                             tracer=Tracer(collector), job="j",
                             namespace="d", uid="u")
    state, start = coord.start(4)
    assert start == 0 and coord.n_slices == 4
    for step in (1, 2):
        state, _ = coord.step_fn(state, *data_fn(step))
        coord.step = step
    pre = snapshot_of(state)
    signal.request(2)
    state, resized = coord.maybe_resize(state)
    assert resized and coord.n_slices == 2 and coord.resizes == 1
    assert coord.snapshotter.saves == 1
    assert signal.pending() is None
    assert same(pre, snapshot_of(state))      # restore is bit-identical
    state, _ = coord.step_fn(state, *data_fn(3))
    coord.step = 3
    assert int(state.step) == 3              # step clock intact

    trace_id, root = jax_trace_ids("d", "j", "u")
    spans = [s for s in collector.spans() if s.trace_id == trace_id]
    assert [s.name for s in spans] == [
        "elastic.snapshot", "elastic.reshard", "elastic.resume"]
    assert all(s.parent_id == root for s in spans)  # one tree
    assert spans[-1].attrs == {"step": 3, "slices": 2}


def test_coordinator_shutdown_signal_saves_then_regang_resumes(tmp_path):
    signal = ResizeSignal()
    coord = make_coordinator(tmp_path, signal=signal)
    state, _ = coord.start(4)
    state, _ = coord.step_fn(state, *data_fn(1))
    coord.step = 1
    signal.request(SHUTDOWN)
    with pytest.raises(SystemExit):
        coord.maybe_resize(state)
    assert coord.snapshotter.saves == 1

    # "fresh pod at the new shape": same checkpoint dir, 2 slices
    coord2 = make_coordinator(
        tmp_path, manager=CheckpointManager(str(tmp_path / "ckpt")))
    state2, start2 = coord2.start(2)
    assert start2 == 1                       # resume, not re-init
    assert same(snapshot_of(state), snapshot_of(state2))
    state2, _ = coord2.step_fn(state2, *data_fn(2))
    assert int(state2.step) == 2


def test_maybe_resize_noop_when_already_at_target(tmp_path):
    signal = ResizeSignal()
    coord = make_coordinator(tmp_path, signal=signal)
    state, _ = coord.start(2)
    state, _ = coord.step_fn(state, *data_fn(1))
    coord.step = 1
    assert coord.maybe_resize(state) == (state, False)   # no signal
    signal.request(2)                        # target == current
    state, resized = coord.maybe_resize(state)
    assert resized is False
    assert coord.snapshotter.saves == 0      # no needless checkpoint
    assert signal.pending() is None          # consumed, not re-latched


def test_newer_signal_survives_a_completing_resize(tmp_path):
    signal = ResizeSignal()
    coord = make_coordinator(
        tmp_path, signal=signal,
        barrier=lambda: signal.request(SHUTDOWN))
    state, _ = coord.start(4)
    state, _ = coord.step_fn(state, *data_fn(1))
    coord.step = 1
    signal.request(2)
    state, resized = coord.maybe_resize(state)
    assert resized and coord.n_slices == 2
    assert signal.pending() == SHUTDOWN      # survived the clear
    with pytest.raises(SystemExit):
        coord.maybe_resize(state)            # and is honored next poll


def test_run_loop_trains_through_a_resize(tmp_path):
    """``run``: a resize latched mid-loop is taken between steps; the
    run ends at ``total_steps`` with every step's metrics."""
    signal = ResizeSignal()
    coord = make_coordinator(tmp_path, signal=signal)
    seen = []

    def on_metrics(step, m):
        seen.append(step)
        if step == 2:
            signal.request(1)

    state = coord.run(total_steps=4, n_slices=2, data_fn=data_fn,
                      on_metrics=on_metrics)
    assert seen == [1, 2, 3, 4] and state.step == 4
    assert coord.n_slices == 1 and coord.snapshotter.saves == 1


def test_cr_resize_target_reads_the_nudge():
    assert (PORT_API, PORT_KIND) == (API_VERSION, TPUJOB_KIND)
    client = FakeKubeClient()
    client.create(tpujob("j", "d", {"image": "x", "slices": 2,
                                    "elastic": {"minSlices": 1,
                                                "maxSlices": 4}}))
    assert cr_resize_target(client, "d", "j") is None   # no nudge yet
    job = dict(client.get(API_VERSION, TPUJOB_KIND, "d", "j"))
    job["status"] = {"resize": {"requested": True}}
    client.update_status(job)
    assert cr_resize_target(client, "d", "j") == 2
    assert cr_resize_target(client, "d", "missing") is None


# -- the end-to-end acceptance, with the reference's control plane -----------


def _cluster(checkpointer):
    client = FakeKubeClient()
    for node in fake_slice_nodes("v5e-8", count=4):
        client.create(node)
    clock = FakeClock()
    collector = SpanCollector()
    from kubeflow_tpu.obs.trace import Tracer as JaxTracer

    tracer = JaxTracer(clock=clock)
    q = GangQueue(client, clock=clock, tracer=tracer,
                  checkpoint_step=checkpointer.latest_step)
    op = TpuJobOperator(client, clock=clock, tracer=tracer, queue=q,
                        checkpointer=checkpointer)
    return client, op, collector


def _pods(client, ns, name):
    return client.list("v1", "Pod", ns, label_selector={JOB_LABEL: name})


def _set_phase(client, ns, name, phase):
    for pod in _pods(client, ns, name):
        pod.setdefault("status", {})["phase"] = phase
        client.update_status(pod)


def test_elastic_shrink_end_to_end(tmp_path):
    """The reference's end-to-end shrink with the port on the worker
    side: the reference operator, with the port's ``DirCheckpointer``,
    drives nudge → snapshot → teardown → re-gang at 2 slices while the
    port's coordinator catches the nudge, snapshots once, reshards and
    resumes at step 4; the operator reads the port's checkpoint step,
    the port's beacons keep the telemetry monotone, and the port's spans
    land under the job's trace."""
    ckpt_dir = str(tmp_path / "ckpt")
    client, op, _ = _cluster(DirCheckpointer())
    resizes = JAX_REGISTRY.counter("kftpu_job_resizes_total")
    r0 = resizes.get(direction="shrink")

    client.create(tpujob("train", "d", {
        "image": "x", "slices": 4, "hostsPerSlice": 1,
        "checkpointDir": ckpt_dir,
        "elastic": {"minSlices": 2, "maxSlices": 4}}))
    op.reconcile("d", "train")
    assert len(_pods(client, "d", "train")) == 4
    _set_phase(client, "d", "train", "Running")
    uid = client.get(API_VERSION, TPUJOB_KIND, "d",
                     "train")["metadata"]["uid"]

    collector = SpanCollector()
    signal = ResizeSignal()
    coord = make_coordinator(
        tmp_path, manager=CheckpointManager(ckpt_dir), signal=signal,
        tracer=Tracer(collector), job="train", namespace="d", uid=uid)
    state, _ = coord.start(4)
    for step in (1, 2, 3):
        state, m = coord.step_fn(state, *data_fn(step))
        coord.step = step
    for w in range(4):
        publish_beacon(client, "d", "train", w,
                       {"step": 3, "stepsPerSec": 1.0}, job_uid=uid)
    op.reconcile("d", "train")
    job = client.get(API_VERSION, TPUJOB_KIND, "d", "train")
    assert job["status"]["telemetry"]["lastStep"] == 3

    job = dict(job)
    job["spec"] = {**job["spec"], "slices": 2}
    client.update(job)
    op.reconcile("d", "train")            # nudge pass: pods still alive
    job = client.get(API_VERSION, TPUJOB_KIND, "d", "train")
    assert job["status"]["resize"]["requested"] is True
    assert len(_pods(client, "d", "train")) == 4

    target = cr_resize_target(client, "d", "train")
    assert target == 2
    pre = snapshot_of(state)
    signal.request(target)
    state, resized = coord.maybe_resize(state)
    assert resized and coord.n_slices == 2
    assert coord.snapshotter.saves == 1

    op.reconcile("d", "train")            # checkpoint + teardown
    assert _pods(client, "d", "train") == []
    job = client.get(API_VERSION, TPUJOB_KIND, "d", "train")
    assert job["status"]["resize"]["lastCheckpointStep"] == 3
    op.reconcile("d", "train")            # re-gang
    pods = _pods(client, "d", "train")
    assert len(pods) == 2
    env = {e["name"]: e["value"]
           for e in pods[0]["spec"]["containers"][0]["env"]}
    assert env["KFTPU_NUM_PROCESSES"] == "2"
    assert env["MEGASCALE_NUM_SLICES"] == "2"
    job = client.get(API_VERSION, TPUJOB_KIND, "d", "train")
    conds = {(c["type"], c["reason"])
             for c in job["status"]["conditions"]}
    assert ("Resized", "ElasticResize") in conds
    assert job["status"]["resize"]["requested"] is False
    assert resizes.get(direction="shrink") == r0 + 1

    assert same(pre, snapshot_of(state))
    state, m = coord.step_fn(state, *data_fn(4))
    coord.step = 4
    assert int(state.step) == 4

    _set_phase(client, "d", "train", "Running")
    for w in range(2):
        publish_beacon(client, "d", "train", w,
                       {"step": 4, "stepsPerSec": 1.0}, job_uid=uid)
    op.reconcile("d", "train")
    job = client.get(API_VERSION, TPUJOB_KIND, "d", "train")
    assert job["status"]["telemetry"]["lastStep"] == 4
    assert job["status"]["telemetry"]["stragglers"] == []

    trace_id, root = jax_trace_ids("d", "train", uid)
    spans = [s for s in collector.spans()
             if s.trace_id == trace_id and s.name.startswith("elastic.")]
    assert [s.name for s in spans] == [
        "elastic.snapshot", "elastic.reshard", "elastic.resume"]
    assert all(s.parent_id == root for s in spans)

    from kubeflow_tpu.dashboard.server import DashboardApi

    api = DashboardApi(client, authorize=lambda *a: True)
    code, body = api.handle("GET", "/api/jobs/d/train/telemetry", None)
    assert code == 200
    assert body["resizes"]["count"] == 1
    assert body["resizes"]["inProgress"] is False
    assert body["resizes"]["direction"] == "shrink"
    assert body["resizes"]["lastCheckpointStep"] == 3


# -- Podracer -----------------------------------------------------------------


def test_podracer_scales_actors_learner_never_restarts():
    from kubeflow_tpu_torch.examples import podracer

    out = podracer.main(["--iterations", "6", "--envs-per-actor", "2",
                         "--hidden", "8", "--device", "cpu"])
    assert out["learner_steps"] == 6
    assert out["learner_monotone"] is True
    assert out["actor_resizes"] == 2          # 2 -> 1 -> 2
    assert out["actor_slices"] == 2
    assert np.isfinite(out["last_reward"])


def test_podracer_update_matches_the_reference():
    """Three REINFORCE updates (Adam 1e-2) on the same trajectories from
    the same parameters: loss, reward and every parameter within 1e-5 of
    the reference's ``make_update`` at f32."""
    from kubeflow_tpu.examples import podracer as ref
    from kubeflow_tpu_torch.examples import podracer

    import optax

    hidden, batch = 16, 6
    init = podracer.init_policy_params(hidden, seed=3)
    rng = np.random.default_rng(5)
    trajs = [(rng.standard_normal((podracer.HORIZON, batch,
                                   podracer.OBS_DIM), dtype=np.float32),
              rng.integers(0, podracer.N_ACTIONS,
                           (podracer.HORIZON, batch)).astype(np.int32),
              -rng.random((podracer.HORIZON, batch), dtype=np.float32) * 3)
             for _ in range(3)]

    flax_params = {layer: {leaf: jnp.asarray(init[f"{layer}.{leaf}"]
                                             .numpy())
                           for leaf in ("kernel", "bias")}
                   for layer in ("body", "head")}
    model = ref.Policy(hidden=hidden)
    jstate = JaxState.create(apply_fn=model.apply, params=flax_params,
                             tx=optax.adam(1e-2))
    jupdate = ref.make_update(jax_mesh_for_slices(
        1, devices=jax.devices()[:1]))
    pstate = podracer.TrainState.create(
        podracer.Policy({k: v.clone() for k, v in init.items()}),
        podracer.make_adam(1e-2))
    pupdate = podracer.make_update()
    for obs, acts, rews in trajs:
        jstate, jm = jupdate(jstate, jnp.asarray(obs), jnp.asarray(acts),
                             jnp.asarray(rews))
        pstate, pm = pupdate(pstate, torch.from_numpy(obs),
                             torch.from_numpy(acts), torch.from_numpy(rews))
        for key in ("loss", "reward"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       atol=1e-5, rtol=0, err_msg=key)
        assert pm["step"] == int(jm["step"])
    got = dict(pstate.module.named_parameters())
    for layer in ("body", "head"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                got[f"{layer}.{leaf}"].detach().numpy(),
                np.asarray(jstate.params[layer][leaf]), atol=1e-5, rtol=0,
                err_msg=f"{layer}.{leaf}")
