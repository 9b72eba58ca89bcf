"""Exactly-once resize snapshots and the operator-side checkpoint binding.

PyTorch port of ``kubeflow_tpu/elastic/snapshot.py``. The worker half
(:class:`ElasticSnapshotter`) drives ONE ``CheckpointManager.save`` of
the train state per resize: the signal handler, the nudge poller and the
loop's own pre-teardown save may all fire for the same resize, and
exactly one of them must write. Saves are synchronous (``wait=True``):
teardown follows at once, and an asynchronous save racing pod deletion
loses the run. The port's save is a collective (every rank gathers its
split tensors before rank 0 writes, ``train/checkpoint.py``), so every
rank of the gang snapshots at the same step.

The operator half (:class:`DirCheckpointer`) is the production binding
of :class:`~kubeflow_tpu_torch.operators.tpujob.PreemptionCheckpointer`
over ``spec.checkpointDir``: the operator never holds device state, so
its ``save`` means "ensure a checkpoint exists": read what the workers'
snapshot landed (``latest_step``), the step the CR's
``resize.lastCheckpointStep`` / ``preemption.lastCheckpointStep`` then
records.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

from kubeflow_tpu_torch.obs.goodput import observe_checkpoint_save
from kubeflow_tpu_torch.operators.tpujob import PreemptionCheckpointer
from kubeflow_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)


class ElasticSnapshotter:
    """One synchronous snapshot per (resize, step) — never two writes.

    ``manager`` is a :class:`~kubeflow_tpu_torch.train.checkpoint.
    CheckpointManager` (or anything with its ``save(step, state,
    wait=)`` shape). Thread-safe: the SIGTERM handler and the train
    loop may race; the loser of the race observes the winner's step.

    Every save's wall time lands in the
    ``kftpu_checkpoint_save_seconds{source="worker"}`` histogram
    (labeled with ``namespace``/``job`` when known): it is the goodput
    ledger's ``checkpoint_save`` source AND the measurement behind the
    question whether ``spec.elastic`` needs a snapshot-deadline knob:
    the sync save holds the teardown grace window, so how long it takes
    decides. ``clock`` is injectable.
    """

    def __init__(self, manager: Any, *, clock: Optional[Clock] = None,
                 job: str = "", namespace: str = "") -> None:
        self.manager = manager
        self.clock: Clock = clock if clock is not None else time.monotonic
        self.job = job
        self.namespace = namespace
        self.saves = 0
        self._last_step: Optional[int] = None
        self._lock = threading.Lock()

    @property
    def last_step(self) -> Optional[int]:
        return self._last_step

    def snapshot(self, step: int, state: Any) -> int:
        """Persist ``state`` at ``step`` exactly once; re-entry for the
        same step is a no-op returning the already-persisted step."""
        with self._lock:
            if self._last_step == step:
                return step
            t0 = self.clock()
            self.manager.save(step, state, wait=True)
            observe_checkpoint_save(self.clock() - t0,
                                    namespace=self.namespace,
                                    job=self.job, source="worker")
            self.saves += 1
            self._last_step = step
            log.info("elastic snapshot landed at step %d", step)
            return step


class DirCheckpointer(PreemptionCheckpointer):
    """``spec.checkpointDir``-bound operator checkpointer.

    ``save(job)`` does not serialize anything — the workers own the
    device state and snapshot it on the resize/preemption nudge; this
    side answers "what step is durably on disk for this job?" so the
    CR status and the queue's victim-cost model read the truth.
    Managers are cached per directory (a ``CheckpointManager`` scans
    its directory at construction)."""

    def __init__(self, manager_factory: Any = None, *,
                 clock: Optional[Clock] = None) -> None:
        if manager_factory is None:
            from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

            manager_factory = CheckpointManager
        self.clock: Clock = clock if clock is not None else time.monotonic
        self._factory = manager_factory
        self._managers: Dict[str, Any] = {}
        # ns/name -> checkpointDir, learned from each save(job) call so
        # latest_step(ns, name) — the queue's victim-cost read, which
        # has no CR in hand — can resolve the directory
        self._dirs: Dict[Tuple[str, str], str] = {}
        self._lock = threading.Lock()

    def _manager_for(self, directory: str) -> Any:
        with self._lock:
            mgr = self._managers.get(directory)
        if mgr is not None:
            return mgr
        # construct OUTSIDE the lock (the factory stats/creates the
        # checkpoint directory: construction is I/O) and
        # publish first-wins: a racing duplicate is a throwaway reader
        # of the same directory, not an exclusive resource
        mgr = self._factory(directory)
        with self._lock:
            return self._managers.setdefault(directory, mgr)

    def _latest(self, directory: str) -> Optional[int]:
        mgr = self._manager_for(directory)
        # another process (the workers) writes this directory: refresh
        # the manager's step cache before reading, where supported
        reload = getattr(mgr, "reload", None)
        if callable(reload):
            try:
                reload()
            except Exception:  # noqa: BLE001 — stale read beats a crash
                log.debug("checkpoint reload failed", exc_info=True)
        return mgr.latest_step()

    def observe(self, ns: str, name: str, directory: str) -> None:
        """Teach the checkpointer a job's directory ahead of any save
        (the operator calls this as it reconciles specs)."""
        if directory:
            with self._lock:
                self._dirs[(ns, name)] = directory

    def save(self, job: Any) -> Optional[int]:
        md = job.get("metadata", {})
        directory = str((job.get("spec", {}) or {}).get("checkpointDir",
                                                        "") or "")
        if not directory:
            return None
        self.observe(md.get("namespace", ""), md.get("name", ""),
                     directory)
        t0 = self.clock()
        try:
            return self._latest(directory)
        except Exception:  # noqa: BLE001 — a broken sink must not wedge
            log.exception("checkpoint read for %s failed", directory)
            return None
        finally:
            # the control-plane half of the save cost: how long the
            # "ensure a checkpoint exists" read holds the reconcile
            # (source=operator — the ledger carves only from the
            # workers' source=worker series)
            observe_checkpoint_save(
                self.clock() - t0, namespace=md.get("namespace", ""),
                job=md.get("name", ""), source="operator")

    def latest_step(self, ns: str, name: str) -> Optional[int]:
        with self._lock:
            directory = self._dirs.get((ns, name))
        if not directory:
            return None
        try:
            return self._latest(directory)
        except Exception:  # noqa: BLE001
            log.exception("checkpoint read for %s failed", directory)
            return None

    def close(self) -> None:
        with self._lock:
            managers, self._managers = list(self._managers.values()), {}
        for mgr in managers:
            try:
                mgr.close()
            except Exception:  # noqa: BLE001
                log.debug("checkpoint manager close failed", exc_info=True)
