"""Worker-side elastic protocol: signal → barrier → save → re-init → reshard.

PyTorch port of ``kubeflow_tpu/elastic/coordinator.py``. The operator
edits the world (``spec.slices``), nudges (``status.resize.requested``
on the CR, SIGTERM when it tears the gang down) and re-gangs; each
worker runs this coordinator around its train loop:

1. **catch**: :class:`ResizeSignal` latches the resize from any source:
   :func:`install_sigterm` (the pod-deletion grace window; the handler
   only latches, it never saves), :func:`cr_resize_target` (the status
   nudge, polled between steps), or a direct call;
2. **barrier**: every rank must reach the same step before the
   snapshot, which is a collective in the port (each rank gathers its
   split tensors before rank 0 writes): a device sync and a barrier
   over the process group (:func:`_default_barrier`);
3. **save**: exactly one synchronous snapshot at the current step
   (:class:`~kubeflow_tpu_torch.elastic.snapshot.ElasticSnapshotter`);
4. **re-init**: a process group cannot shrink in place, so every rank
   leaves it, and the ranks of the new world enter a fresh one at the
   new world size, on a new store (:func:`_default_reinit`, from the
   refreshed env contract). A rank past the new world then exits:
   the departing ranks took part in the snapshot and leave;
5. **reshard + resume**: rebuild the mesh for the new slice count, build
   the module and step over it, restore the snapshot into it
   (:func:`~kubeflow_tpu_torch.elastic.reshard.restore_resharded`), and
   continue at ``step+1`` with the step clock intact.

Every resize records ``elastic.snapshot`` → ``elastic.reshard`` →
``elastic.resume`` spans under the job's identity-derived trace
(:func:`~kubeflow_tpu_torch.obs.steps.tpujob_trace_ids`), the trace of
the operator's root span and the workers' step spans.

No fallback: a barrier, a save, a re-init or a restore that fails
raises out of :meth:`ElasticCoordinator.maybe_resize`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from kubeflow_tpu_torch.elastic.reshard import (
    mesh_for_slices,
    restore_resharded,
)
from kubeflow_tpu_torch.elastic.snapshot import ElasticSnapshotter
from kubeflow_tpu_torch.obs.steps import tpujob_trace_ids
from kubeflow_tpu_torch.obs.trace import SpanContext, Tracer
from kubeflow_tpu_torch.parallel import mesh as pmesh
from kubeflow_tpu_torch.train.checkpoint import _rank
from kubeflow_tpu_torch.utils.clock import Clock
from kubeflow_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# SIGTERM carries no target topology: the re-ganged process learns its
# new world from the operator's refreshed env contract. The sentinel
# means "snapshot and stop; do not reshard in-process".
SHUTDOWN = 0


class ResizeSignal:
    """Thread-safe latch for one pending resize.

    ``request(n)`` arms it with the target slice count (or
    :data:`SHUTDOWN`); the train loop polls :meth:`pending` between
    steps and :meth:`clear`s after the reshard. The latest request wins:
    a grow nudge arriving while a shrink is still latched supersedes it
    (the operator's spec is the single source of truth)."""

    def __init__(self) -> None:
        self._target: Optional[int] = None
        self._lock = threading.Lock()

    def request(self, n_slices: int) -> None:
        with self._lock:
            self._target = int(n_slices)

    def pending(self) -> Optional[int]:
        with self._lock:
            return self._target

    def clear(self, if_target: Optional[int] = None) -> None:
        """Unlatch. With ``if_target``, clear only if the latched value
        is still that target (compare-and-clear): a NEWER request (a
        SIGTERM landing while the handled resize was mid-reshard) must
        survive to be handled on the next poll, not be wiped by the
        completion of the one it superseded."""
        with self._lock:
            if if_target is None or self._target == if_target:
                self._target = None


def install_sigterm(signal_obj: ResizeSignal) -> None:
    """Latch :data:`SHUTDOWN` on SIGTERM: the operator's teardown sends
    it to every pod, and the grace period is the snapshot window. The
    snapshot itself runs at the next between-steps poll, on every rank
    (it is a collective), never inside the handler."""
    import signal as _signal

    def handler(_signum, _frame):  # noqa: ANN001
        log.info("SIGTERM: latching elastic shutdown snapshot")
        signal_obj.request(SHUTDOWN)

    _signal.signal(_signal.SIGTERM, handler)


def cr_resize_target(client: Any, ns: str, name: str) -> Optional[int]:
    """The ``status.resize.requested`` nudge, resolved to a target slice
    count from the (already-edited) ``spec.slices``. None = no resize
    pending. This is the poll a worker runs between steps when it wants
    to resize in place instead of waiting for SIGTERM."""
    from kubeflow_tpu_torch.operators.tpujob import API_VERSION, TPUJOB_KIND

    job = client.get_or_none(API_VERSION, TPUJOB_KIND, ns, name)
    if job is None:
        return None
    resize = (job.get("status", {}) or {}).get("resize") or {}
    if not resize.get("requested"):
        return None
    try:
        return int((job.get("spec", {}) or {}).get("slices", 0)) or None
    except (TypeError, ValueError):
        return None


def _default_barrier() -> None:
    """Everything launched is done, and every rank is here, before the
    snapshot reads the state: a device sync, then a barrier over the
    process group (a single process: the sync alone)."""
    import torch
    import torch.distributed as tdist

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if tdist.is_initialized() and tdist.get_world_size() > 1:
        tdist.barrier()


def _default_reinit(n_slices: int) -> None:
    """Leave the process group and, for a rank of the new world, enter a
    fresh one at the new world size from the refreshed env contract
    (``parallel/distributed.py:initialize``: the new coordinator
    address, process count and this rank's id), on the backend the old
    one used. Every subgroup and mesh of the old group is dead after
    this. A new world of one process gets its one-rank group from the
    next ``create_mesh``. Outside a process group this is a no-op."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import distributed as dist

    del n_slices  # the env contract carries the new world
    if not tdist.is_initialized():
        return
    backend = tdist.get_backend()
    tdist.destroy_process_group()
    penv = dist.from_env()
    if penv.process_id < penv.num_processes:
        dist.initialize(penv, backend=backend)


class ElasticCoordinator:
    """Drives one worker's train loop through resizes.

    Everything is injectable (clock, tracer, barrier, re-init, mesh
    factory), so the protocol runs deterministically on the CPU; the
    defaults are the production wiring.

    - ``manager``: :class:`~kubeflow_tpu_torch.train.checkpoint.
      CheckpointManager` over the job's ``spec.checkpointDir``.
    - ``init_fn(mesh, device)``: builds a fresh train state over
      ``mesh`` on ``device`` (``elastic/reshard.py``'s contract; on the
      meta device, shapes only).
    - ``make_step(mesh)``: builds the step for a mesh (a
      :mod:`kubeflow_tpu_torch.train.trainer` factory).
    - ``mesh_factory(n_slices)``: the topology map; defaults to
      :func:`~kubeflow_tpu_torch.elastic.reshard.mesh_for_slices` over
      the process group that stands.
    - ``device``: where the state lives (CUDA unless ``"cpu"``).
    """

    def __init__(
        self,
        *,
        manager: Any,
        init_fn: Callable[[Any, Any], Any],
        make_step: Callable[[Any], Callable[..., Any]],
        mesh_factory: Optional[Callable[[int], Any]] = None,
        signal: Optional[ResizeSignal] = None,
        barrier: Optional[Callable[[], None]] = None,
        reinit: Optional[Callable[[int], None]] = None,
        clock: Optional[Clock] = None,
        tracer: Optional[Tracer] = None,
        job: str = "",
        namespace: str = "default",
        uid: str = "",
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        if mesh_factory is None:
            kind = self.device.type
            mesh_factory = lambda n: mesh_for_slices(  # noqa: E731
                n, device_type=kind)
        self.manager = manager
        self.init_fn = init_fn
        self.make_step = make_step
        self.mesh_factory = mesh_factory
        self.signal = signal if signal is not None else ResizeSignal()
        self.barrier = barrier if barrier is not None else _default_barrier
        self.reinit = reinit if reinit is not None else _default_reinit
        # wall clock: the resize spans join the operator's epoch-domain
        # root span in one tree
        self.clock: Clock = clock if clock is not None else time.time
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self.clock)
        self.trace_id, self.root_span_id = tpujob_trace_ids(
            namespace, job, uid)
        # the snapshotter keeps its own monotonic duration clock (the
        # coordinator's is wall time and would count an NTP step as save
        # time) and the job's labels for kftpu_checkpoint_save_seconds
        self.snapshotter = ElasticSnapshotter(
            manager, job=job, namespace=namespace)
        self.resizes = 0
        self.n_slices: Optional[int] = None
        self.mesh: Optional[Any] = None
        self.step_fn: Optional[Callable[..., Any]] = None
        self.step: int = 0

    # -- spans -------------------------------------------------------------

    def _span(self, name: str, start: float,
              attrs: Dict[str, Any]) -> None:
        self.tracer.record(
            name, start=start, end=self.clock(),
            parent=SpanContext(self.trace_id, self.root_span_id),
            attrs=attrs)

    # -- lifecycle ---------------------------------------------------------

    def start(self, n_slices: int) -> Tuple[Any, int]:
        """Boot at ``n_slices``: restore-or-init over the topology's mesh
        and return ``(state, start_step)``. The first boot and the
        re-ganged resume take this one path (the ``restore_or_init``
        restart contract); a checkpoint written on another topology
        reshards on the way in."""
        self.n_slices = n_slices
        self.mesh = self.mesh_factory(n_slices)
        self.step_fn = self.make_step(self.mesh)
        latest = self.manager.latest_step()
        if latest is None:
            self.step = 0
            return self.init_fn(self.mesh, self.device), 0
        t0 = self.clock()
        state = restore_resharded(self.manager, self.init_fn, self.mesh,
                                  step=latest, device=self.device)
        self.step = latest
        self._span("elastic.resume", t0,
                   {"step": latest + 1, "slices": n_slices})
        log.info("elastic resume at step %d on %d slice(s)", latest + 1,
                 n_slices)
        return state, latest

    def _stays(self, target: int) -> bool:
        """Whether this rank is one of the new world's: the first
        ``target`` slices of the current mesh's ranks per slice."""
        per_slice = pmesh.axis_size(self.mesh, ("dp", "pp", "tp"))
        return _rank() < target * per_slice

    def maybe_resize(self, state: Any) -> Tuple[Any, bool]:
        """Between-steps check: no signal → ``(state, False)``.

        On a latched resize: barrier, snapshot at the current step
        (every rank), re-init the process group, rebuild mesh, module
        and step, restore into them. Returns ``(resharded_state, True)``;
        the loop continues at ``self.step + 1``. A rank outside the new
        world, and every rank on a :data:`SHUTDOWN` signal, raises
        :class:`SystemExit` after the snapshot (a re-ganged process
        resumes through :meth:`start`)."""
        target = self.signal.pending()
        if target is None:
            return state, False
        if target == self.n_slices:
            # already at the target (the CR nudge keeps reporting the
            # resize until the operator closes it): a no-op, not another
            # snapshot-restore cycle per poll
            self.signal.clear(if_target=target)
            return state, False
        from_slices = self.n_slices
        t0 = self.clock()
        self.barrier()
        self.snapshotter.snapshot(self.step, state)
        self._span("elastic.snapshot", t0,
                   {"step": self.step, "fromSlices": from_slices,
                    "toSlices": target})
        if target == SHUTDOWN:
            log.info("elastic shutdown: snapshot landed at step %d, "
                     "exiting for re-gang", self.step)
            raise SystemExit(0)
        t1 = self.clock()
        stays = self._stays(target)
        self.reinit(target)
        if not stays:
            log.info("elastic resize %s -> %s slices: rank %d leaves "
                     "after the step-%d snapshot", from_slices, target,
                     _rank(), self.step)
            raise SystemExit(0)
        self.mesh = self.mesh_factory(target)
        self.step_fn = self.make_step(self.mesh)
        state = restore_resharded(self.manager, self.init_fn, self.mesh,
                                  step=self.step, device=self.device)
        self._span("elastic.reshard", t1,
                   {"step": self.step, "fromSlices": from_slices,
                    "toSlices": target})
        self.n_slices = target
        self.resizes += 1
        # compare-and-clear: a newer signal (a SHUTDOWN racing this
        # reshard) stays latched for the next between-steps poll
        self.signal.clear(if_target=target)
        t2 = self.clock()
        self._span("elastic.resume", t2,
                   {"step": self.step + 1, "slices": target})
        log.info("elastic resize %s -> %s slices at step %d",
                 from_slices, target, self.step)
        return state, True

    def run(self, *, total_steps: int, n_slices: int,
            data_fn: Callable[[int], Tuple[Any, ...]],
            on_metrics: Optional[Callable[[int, Any], None]] = None
            ) -> Any:
        """The whole elastic train loop: boot at ``n_slices``, train to
        ``total_steps`` checking the resize signal between steps, return
        the final state. ``data_fn(step)`` yields the step's batch args,
        host-side and step-keyed, so the stream is the same on every
        topology."""
        state, _start = self.start(n_slices)
        while self.step < total_steps:
            state, _resized = self.maybe_resize(state)
            step = self.step + 1
            state, metrics = self.step_fn(state, *data_fn(step))
            self.step = step
            if on_metrics is not None:
                on_metrics(step, metrics)
        return state
