"""Model multiplexing: N small models on one card, weight-paged.

PyTorch port of ``kubeflow_tpu/serving/multiplex.py`` (a copy: the same
class, counters, snapshot keys and errors). A dedicated card per small
model wastes it: most fleets serve a long tail of models whose weights
fit device memory many times over but whose traffic never saturates
one card. The multiplexer gives that headroom back:

- **LRU weight paging** from the versioned model store
  (:func:`kubeflow_tpu_torch.serving.model_store.load_version`, onto
  ``device`` — CUDA unless asked otherwise — and, for an LM, over
  ``mesh``): at most ``max_resident`` models hold device memory;
  faulting a cold model in evicts the least-recently-used resident one
  (never a pinned or in-use model). An evicted model's last reference
  here is dropped, so its weights go back to the allocator once no
  caller still holds its handle or a lease;
- a **pinned hot set**: models named in ``pinned`` are loaded up front
  and never evicted;
- **single-flight faulting**: concurrent requests for the same cold
  model trigger exactly ONE store load; the rest wait on the leader's
  result;
- **cold-start accounting**: per-model fault wall time lands in
  ``snapshot()`` (``cold_start_ms``), the
  ``kftpu_multiplex_cold_start_ms`` gauge, and the faulting request's
  ``weight_fault`` phase on the request ledger (``obs/requests.py``).

``snapshot()`` merges an attached engine's snapshot, so the autoscaler
polls ONE object per backend (the reference's ``autoscale/metrics.py:
MetricsAggregator.observe_engine``) and its concurrency signal gains
model occupancy.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY

log = logging.getLogger(__name__)

_loads_c = DEFAULT_REGISTRY.counter(
    "kftpu_multiplex_loads_total", "model weight loads (cold faults)")
_evictions_c = DEFAULT_REGISTRY.counter(
    "kftpu_multiplex_evictions_total", "resident models paged out (LRU)")
_cold_ms_g = DEFAULT_REGISTRY.gauge(
    "kftpu_multiplex_cold_start_ms",
    "last cold-start fault wall time per model, milliseconds")
_resident_g = DEFAULT_REGISTRY.gauge(
    "kftpu_multiplex_resident_models", "models currently holding weights")


class MultiplexFull(RuntimeError):
    """Every resident model is pinned or in use — nothing can be paged
    out to make room. A load condition (shed or retry), not a bug."""


class _Fault:
    """One in-flight cold load: followers hold THIS object and read
    the leader's outcome off it after ``event`` sets — no global
    error dict that client-controlled unique model names could grow
    forever (each stored exception pins its traceback frames too)."""

    __slots__ = ("event", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class _Resident:
    __slots__ = ("handle", "tick", "inflight", "pinned", "cold_start_ms")

    def __init__(self, handle: Any, tick: int, pinned: bool,
                 cold_start_ms: float) -> None:
        self.handle = handle
        self.tick = tick
        self.inflight = 0
        self.pinned = pinned
        self.cold_start_ms = cold_start_ms


class ModelMultiplexer:
    """LRU weight pager over the model store, single-flight per model.

    ``loader(name) -> handle`` is injectable (tests fault fakes; the
    default binds the store root through
    :func:`~kubeflow_tpu_torch.serving.model_store.load_version` onto
    ``device``, CUDA unless asked otherwise, an LM built over ``mesh``
    when one is given). ``engine`` (optional) is the
    co-resident decode engine whose snapshot this object's
    ``snapshot()`` extends for the autoscaler poll.
    """

    def __init__(self, store_root: Optional[str] = None, *,
                 max_resident: int, pinned: Sequence[str] = (),
                 loader: Optional[Callable[[str], Any]] = None,
                 engine: Any = None, mesh: Any = None, device=None,
                 clock: Optional[Callable[[], float]] = None,
                 request_ledger=None) -> None:
        if max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        if len(set(pinned)) > max_resident:
            raise ValueError(
                f"{len(set(pinned))} pinned models cannot fit a "
                f"max_resident of {max_resident}")
        if loader is None:
            if store_root is None:
                raise ValueError("need store_root or loader")
            loader = self._store_loader(store_root, mesh, device)
        self.max_resident = int(max_resident)
        self.pinned = tuple(dict.fromkeys(pinned))
        self.loader = loader
        self.engine = engine
        self.clock = clock if clock is not None else time.monotonic
        # request-lifecycle ledger: a cold-start fault is the faulting
        # request's weight_fault phase (carved from whatever base phase
        # it overlaps), keyed by the caller's active trace
        from kubeflow_tpu_torch.obs import requests as _reqobs

        self.rledger = (request_ledger if request_ledger is not None
                        else _reqobs.DEFAULT_LEDGER)
        self._resident: Dict[str, _Resident] = {}
        self._loading: Dict[str, _Fault] = {}
        self._lock = threading.Lock()
        self._tick = 0
        self.loads = 0
        self.evictions = 0
        for name in self.pinned:
            self.get(name)

    @staticmethod
    def _store_loader(store_root: str, mesh: Any, device: Any):
        import os

        from kubeflow_tpu_torch.serving import model_store

        def load(name: str):
            base = os.path.join(store_root, name)
            versions = model_store.list_versions(base)
            if not versions:
                raise FileNotFoundError(
                    f"no versions of {name!r} under {store_root}")
            return model_store.load_version(base, versions[-1],
                                            device=device, mesh=mesh)

        return load

    # -- faulting ----------------------------------------------------------

    def get(self, name: str) -> Any:
        """The model's handle, faulting its weights in if cold.

        Raises :class:`MultiplexFull` when nothing can be evicted to
        make room, and re-raises the leader's load error to every
        waiter of the same fault (a failed load must fail the herd, not
        strand it)."""
        while True:
            with self._lock:
                res = self._resident.get(name)
                if res is not None:
                    self._tick += 1
                    res.tick = self._tick
                    return res.handle
                fault = self._loading.get(name)
                if fault is None:
                    # leader: room-make BEFORE claiming the fault (the
                    # claim would count itself toward the committed
                    # budget, and a MultiplexFull after installing it
                    # would strand followers on a never-set event),
                    # all under the lock so two faults cannot evict
                    # past the budget
                    self._evict_for_one_locked()
                    fault = self._loading[name] = _Fault()
                    break
            # follower: wait for the leader's outcome outside the lock
            # — read it off the shared fault object (a failed load
            # fails the whole herd; a success loops to residency).
            # The wait is THIS request's weight_fault stall too: every
            # member of the herd pays the cold start, and each record
            # shows its own share
            tw0 = self.clock()
            fault.event.wait()
            self._note_weight_fault(tw0, self.clock())
            if fault.error is not None:
                raise fault.error
        t0 = self.clock()
        try:
            handle = self.loader(name)
        except BaseException as e:
            with self._lock:
                del self._loading[name]
            fault.error = e
            fault.event.set()
            raise
        cold_ms = (self.clock() - t0) * 1000.0
        self._note_weight_fault(t0, t0 + cold_ms / 1000.0)
        with self._lock:
            self._tick += 1
            self._resident[name] = _Resident(
                handle, self._tick, name in self.pinned, cold_ms)
            del self._loading[name]
            self.loads += 1
            n_res = len(self._resident)
        fault.event.set()
        _loads_c.inc(model=name)
        _cold_ms_g.set(round(cold_ms, 3), model=name)
        _resident_g.set(n_res)
        log.info("multiplex: faulted %s in %.1f ms (%d resident)",
                 name, cold_ms, n_res)
        return handle

    def _note_weight_fault(self, t0: float, t1: float) -> None:
        """Attribute a cold-start window to the calling request's
        lifecycle record (keyed by the thread's active trace; callers
        outside any trace simply have no record to charge)."""
        from kubeflow_tpu_torch.obs.trace import current_context

        ctx = current_context()
        if ctx is not None:
            from kubeflow_tpu_torch.obs import requests as _reqobs

            self.rledger.stall(ctx.trace_id, _reqobs.WEIGHT_FAULT,
                               t0, t1)

    def _evict_for_one_locked(self) -> None:
        """Make room for one incoming model (caller holds the lock).

        Loads in flight count toward the budget — the leader that
        claimed a fault owns its slot before the weights arrive."""
        committed = len(self._resident) + len(self._loading)
        while committed + 1 > self.max_resident:
            victim = min(
                (r for r in self._resident.items()
                 if not r[1].pinned and r[1].inflight == 0),
                key=lambda kv: kv[1].tick, default=None)
            if victim is None:
                raise MultiplexFull(
                    f"{len(self._resident)} resident / "
                    f"{len(self._loading)} loading, all pinned or in "
                    f"use — cannot page anything out")
            del self._resident[victim[0]]
            self.evictions += 1
            committed -= 1
            _evictions_c.inc()
            _resident_g.set(len(self._resident))
            log.info("multiplex: paged out %s", victim[0])

    # -- request accounting ------------------------------------------------

    def lease(self, name: str) -> "_Lease":
        """``with mux.lease(name) as handle:`` — the in-use guard that
        keeps a model resident for the duration of a request (eviction
        skips models with live leases)."""
        while True:
            handle = self.get(name)
            with self._lock:
                res = self._resident.get(name)
                if res is not None:
                    res.inflight += 1
                    return _Lease(self, name, handle)
            # evicted between get() and the lock (a zero-inflight race
            # on a saturated pager): retry the fault — OUTSIDE the
            # lock, since get() takes it (recursing under the held
            # non-reentrant lock deadlocked the whole pager)

    def _release(self, name: str) -> None:
        with self._lock:
            res = self._resident.get(name)
            if res is not None:
                res.inflight = max(0, res.inflight - 1)

    # -- telemetry ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Engine-snapshot superset for the autoscaler poll: the
        attached engine's fields plus model-occupancy. ``models_held``
        (resident minus idle-evictable) over ``models_max`` is the
        resident-weight pressure; idle UNPINNED resident models are
        reclaimable cache, not load (the ``pages_evictable`` stance
        applied to weights). Pinned models are never evictable — a
        pager saturated by its pinned hot set must read as pressure,
        since no other model can fault in."""
        snap: Dict[str, Any] = (dict(self.engine.snapshot())
                                if self.engine is not None
                                else {"active_slots": 0, "pending": 0,
                                      "slots": 0, "closed": False})
        with self._lock:
            resident = {
                name: {"inflight": r.inflight, "pinned": r.pinned,
                       "cold_start_ms": round(r.cold_start_ms, 3)}
                for name, r in sorted(self._resident.items())}
            evictable = sum(1 for r in self._resident.values()
                            if r.inflight == 0 and not r.pinned)
            snap.update({
                "multiplex": True,
                "models_resident": len(resident),
                "models_max": self.max_resident,
                "models_evictable": evictable,
                "models_loading": len(self._loading),
                "models_pinned": len(self.pinned),
                "multiplex_loads": self.loads,
                "multiplex_evictions": self.evictions,
                "models": resident,
            })
        return snap

    def resident_models(self) -> List[str]:
        with self._lock:
            return sorted(self._resident)


class _Lease:
    def __init__(self, mux: ModelMultiplexer, name: str,
                 handle: Any) -> None:
        self.mux = mux
        self.name = name
        self.handle = handle

    def __enter__(self) -> Any:
        return self.handle

    def __exit__(self, *exc) -> None:
        self.mux._release(self.name)
