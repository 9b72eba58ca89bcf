"""Compile ledger, memory budgets and device-memory watermarks.

PyTorch port of ``kubeflow_tpu/obs/xprof.py``. Two halves:

**The compile ledger** (:class:`CompileLedger`). Eager PyTorch has no
XLA compile: the compile the port pays is the ``nvcc`` build of each
``ops/csrc/*.cu`` (``ops/_build.py``), one process a source, all of a
``build`` call's sources at once. That is what the ledger counts:
``install()`` subscribes to ``_build.listeners`` and every library
``nvcc`` produces becomes one ``record(module="<source>.cu",
seconds=<that nvcc's wall>, fingerprint=<the library's digest>)``: one
``kftpu_compile_seconds{module,shape_class,generation}`` observation, a
``compile/<source>.cu`` span under the job's identity-derived root, and
the job totals (:func:`job_compile_seconds`,
:func:`job_compile_totals`). A library found on disk is no compile and
records nothing. The builds of one call overlap, so a source's seconds
are its own process's wall while the job total adds only the time not
already covered by an earlier build's interval: the total never exceeds
the wall time the job spent building (the goodput fold's
``startup_compile`` counts each second once). :meth:`CompileLedger.
timed_compile` times the first call of any function (a first call pays
lazy builds and allocator growth) and records its memory budget beside
it.

**Memory.** :func:`memory_budget` / :func:`record_memory_budget` take
the caching allocator's measurement of one call: ``argument`` the bytes
of its CUDA tensor arguments, ``output`` the bytes of its outputs that
are not arguments (a state updated in place counts once, as an
argument), ``temp`` the peak during the call less what was allocated at
entry less those outputs. The reference's ``generated_code`` and
``alias`` kinds have no measurement here and are left out, as the
reference leaves out what a backend declines; without CUDA the budget is
``{}``. :class:`HbmSampler` samples the allocator into the watermark
gauges:

- ``bytes_in_use`` ← ``torch.cuda.memory_stats(d)["allocated_bytes.all.current"]``;
- ``peak_bytes_in_use`` ← ``["allocated_bytes.all.peak"]``;
- ``bytes_limit`` ← ``torch.cuda.mem_get_info(d)[1]`` (the card's total).

Series (names, help and labels the reference's):

- ``kftpu_compile_seconds{module,shape_class,generation[,namespace,
  job]}`` — histogram, one observation per build;
- ``kftpu_hbm_bytes{kind=in_use|peak|limit[,identity...]}``;
- ``kftpu_hbm_utilization{[identity...]}``, ``in_use/limit``;
- ``kftpu_hbm_budget_bytes{kind,module,shape_class,generation}``.

Nothing here may fail a build, a step or an admit: every hook logs and
carries on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from kubeflow_tpu_torch.obs.steps import tpujob_trace_ids
from kubeflow_tpu_torch.obs.trace import SpanContext, Tracer
from kubeflow_tpu_torch.ops.autotune import (
    backend_generation,
    dtype_name,
    seq_bucket,
)
from kubeflow_tpu_torch.utils.clock import Clock
from kubeflow_tpu_torch.utils.metrics import (
    DEFAULT_REGISTRY,
    STEP_TIME_BUCKETS,
)

log = logging.getLogger(__name__)

HBM_KINDS = ("in_use", "peak", "limit")
BUDGET_KINDS = ("temp", "argument", "output", "generated_code", "alias")
# the shape class of a library build: one library serves every shape
BUILD_SHAPE_CLASS = "all"

# -- exported series ---------------------------------------------------------

_compile_h = DEFAULT_REGISTRY.histogram(
    "kftpu_compile_seconds",
    "XLA compilation wall time, one observation per backend compile, "
    "keyed by module / shape class / backend generation",
    buckets=STEP_TIME_BUCKETS)
_hbm_g = DEFAULT_REGISTRY.gauge(
    "kftpu_hbm_bytes",
    "device memory watermark (kind=in_use|peak|limit), sampled from "
    "device.memory_stats()")
_hbm_util_g = DEFAULT_REGISTRY.gauge(
    "kftpu_hbm_utilization",
    "device memory in_use/limit fraction (absent when the backend "
    "reports no limit)")
_hbm_budget_g = DEFAULT_REGISTRY.gauge(
    "kftpu_hbm_budget_bytes",
    "static memory_analysis budget per compiled executable "
    "(kind=temp|argument|output|generated_code|alias)")


def _identity(namespace: str, job: str, worker: Optional[int],
              model: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    if job:
        labels.update({"namespace": namespace, "job": job})
    if worker is not None:
        labels["worker"] = str(worker)
    if model:
        labels["model"] = model
    return labels


def observe_compile(seconds: float, *, module: str, shape_class: str,
                    generation: str, namespace: str = "",
                    job: str = "") -> None:
    """One compile event into the histogram; job identity labels it
    where there is a job."""
    labels = {"module": module, "shape_class": shape_class,
              "generation": generation}
    if job:
        labels.update({"namespace": namespace, "job": job})
    _compile_h.observe(max(float(seconds), 0.0), **labels)


def set_hbm_bytes(kind: str, value: float, *, namespace: str = "",
                  job: str = "", worker: Optional[int] = None,
                  model: str = "") -> None:
    _hbm_g.set(float(value), kind=kind,
               **_identity(namespace, job, worker, model))


def set_hbm_utilization(value: float, *, namespace: str = "",
                        job: str = "", worker: Optional[int] = None,
                        model: str = "") -> None:
    _hbm_util_g.set(float(value),
                    **_identity(namespace, job, worker, model))


# -- shape-class / fingerprint vocabulary ------------------------------------


def shape_class_of(*args: Any) -> str:
    """Shape-class slug for a call's arguments, in the tile table's
    vocabulary: the pow2 :func:`seq_bucket` of the largest dimension
    seen plus the first array's dtype. Scalar-only calls class as
    ``scalar``."""
    max_dim = 0
    dt = ""
    queue: List[Any] = list(args)
    i = 0
    while i < len(queue):           # FIFO: first arg's dtype wins
        a = queue[i]
        i += 1
        if isinstance(a, (tuple, list)):
            queue.extend(a)
            continue
        if isinstance(a, dict):
            queue.extend(a.values())
            continue
        shape = getattr(a, "shape", None)
        if shape is None:
            continue
        for d in shape:
            try:
                max_dim = max(max_dim, int(d))
            except (TypeError, ValueError):
                continue
        dtype = getattr(a, "dtype", None)
        if dtype is not None and not dt:
            dt = dtype_name(dtype)
    if max_dim <= 0:
        return "scalar"
    return f"seq{seq_bucket(max_dim)}_{dt or 'any'}"


def call_fingerprint(fn: Any, *args: Any) -> str:
    """16-hex key of a first call: the function's qualified name and its
    arguments' shape class (the port has no program text to hash)."""
    name = (f"{getattr(fn, '__module__', '')}."
            f"{getattr(fn, '__qualname__', '') or type(fn).__name__}")
    return hashlib.sha256(
        f"{name}/{shape_class_of(*args)}".encode()).hexdigest()[:16]


def compile_span_id(trace_id: str, worker: int, module: str,
                    seq: int) -> str:
    """Stable span id for one worker's Nth compile of ``module``."""
    h = hashlib.sha256(
        f"{trace_id}/w{worker}/compile/{module}/{seq}".encode())
    return h.hexdigest()[:16]


# -- memory budgets: the allocator's measurement of one call -----------------

_BUDGETS: Dict[str, Dict[str, Any]] = {}
_BUDGETS_LOCK = threading.Lock()


def _cuda_tensors(obj: Any, out: Dict[int, int], seen: set) -> None:
    """Bytes of each CUDA tensor reachable from ``obj``, by storage
    address (aliases once): containers, modules and plain objects are
    walked."""
    import torch

    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            st = obj.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
        return
    if isinstance(obj, torch.nn.Module):
        for t in obj.state_dict(keep_vars=True).values():
            _cuda_tensors(t, out, seen)
        return
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return
    for item in items:
        _cuda_tensors(item, out, seen)


def measured_call(fn: Callable, *args: Any, **kwargs: Any
                  ) -> Tuple[Any, Dict[str, int]]:
    """``(fn(*args, **kwargs), budget)``: the call, and the caching
    allocator's measurement of it (see the module docstring). The budget
    is ``{}`` without CUDA or where no argument is a CUDA tensor."""
    import torch

    args_b: Dict[int, int] = {}
    if torch.cuda.is_available():
        _cuda_tensors((args, kwargs), args_b, set())
    if not args_b:
        return fn(*args, **kwargs), {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entry = torch.cuda.memory_allocated()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    outs: Dict[int, int] = {}
    _cuda_tensors(result, outs, set())
    output = sum(n for ptr, n in outs.items() if ptr not in args_b)
    return result, {"temp": max(0, peak - entry - output),
                    "argument": sum(args_b.values()), "output": output}


def memory_budget(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, int]:
    """The byte budget of one call of ``fn`` (:func:`measured_call`);
    ``{}`` where it cannot be measured or the call raises (budgets are
    a measurement, never a requirement)."""
    try:
        return measured_call(fn, *args, **kwargs)[1]
    except Exception:  # noqa: BLE001
        log.debug("memory budget failed (continuing)", exc_info=True)
        return {}


def _record_budget(budget: Dict[str, int], *, module: str, shape_class: str,
                   generation: str, fingerprint: str) -> None:
    for kind, v in budget.items():
        _hbm_budget_g.set(float(v), kind=kind, module=module,
                          shape_class=shape_class, generation=generation)
    if fingerprint and budget:
        with _BUDGETS_LOCK:
            _BUDGETS[fingerprint] = {
                "module": module, "shape_class": shape_class,
                "generation": generation, "bytes": dict(budget)}


def record_memory_budget(fn: Callable, *args: Any, module: str,
                         shape_class: str = "", generation: str = "",
                         fingerprint: str = "",
                         **kwargs: Any) -> Dict[str, int]:
    """Measure one call of ``fn(*args, **kwargs)`` and record its
    footprint: one ``kftpu_hbm_budget_bytes{kind}`` gauge row per budget
    kind, plus the per-fingerprint registry :func:`budget_for` serves
    (``shape_class`` defaults to the arguments', ``generation`` to the
    card's, ``fingerprint`` to :func:`call_fingerprint`)."""
    budget = memory_budget(fn, *args, **kwargs)
    _record_budget(budget, module=module,
                   shape_class=shape_class or shape_class_of(*args),
                   generation=generation or backend_generation(),
                   fingerprint=fingerprint or call_fingerprint(fn, *args))
    return budget


def budget_for(fingerprint: str) -> Optional[Dict[str, Any]]:
    with _BUDGETS_LOCK:
        b = _BUDGETS.get(fingerprint)
        return dict(b) if b else None


def budgets() -> Dict[str, Dict[str, Any]]:
    """Snapshot of every recorded fingerprint → budget."""
    with _BUDGETS_LOCK:
        return {fp: dict(b) for fp, b in _BUDGETS.items()}


# -- per-job ground-truth compile totals -------------------------------------

_JOB_COMPILE_TOTALS: Dict[Tuple[str, str], Dict[str, float]] = {}
_TOTALS_LOCK = threading.Lock()


def job_compile_seconds(namespace: str, job: str) -> Optional[float]:
    """Cumulative compile seconds for one job; ``None`` when no ledger
    has recorded for it (absence of evidence is not zero)."""
    with _TOTALS_LOCK:
        t = _JOB_COMPILE_TOTALS.get((namespace, job))
        return float(t["seconds"]) if t else None


def job_compile_totals(namespace: str, job: str) -> Dict[str, float]:
    with _TOTALS_LOCK:
        t = _JOB_COMPILE_TOTALS.get((namespace, job))
        return (dict(t) if t
                else {"seconds": 0.0, "count": 0})


def _reset_job_totals() -> None:
    """Test/smoke isolation hook."""
    with _TOTALS_LOCK:
        _JOB_COMPILE_TOTALS.clear()


# -- the compile-event ledger ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    """One recorded compilation."""

    module: str
    seconds: float
    shape_class: str
    generation: str
    fingerprint: str
    start: float
    end: float


def _uncovered(spans: List[Tuple[float, float]], start: float,
               end: float) -> float:
    """Seconds of ``[start, end]`` outside the merged ``spans``, which
    then take the interval in (kept sorted and disjoint)."""
    free = max(0.0, end - start)
    merged: List[Tuple[float, float]] = []
    lo, hi = start, end
    for a, b in spans:
        if b < lo or a > hi:
            merged.append((a, b))
            continue
        free -= max(0.0, min(b, end) - max(a, start))
        lo, hi = min(lo, a), max(hi, b)
    merged.append((lo, hi))
    spans[:] = sorted(merged)
    return max(0.0, free)


class CompileLedger:
    """Records every kernel build as metric + span + job total.

    >>> ledger = CompileLedger(namespace="default", job="lm", worker=0)
    >>> ledger.install()                 # ops/_build.py subscription
    >>> ...                              # nvcc builds are now ledgered
    >>> ledger.uninstall()               # explicit teardown

    Clock, tracer and generation are injectable; the clock is wall time
    so compile spans join the job's identity-derived trace. ``install``
    is idempotent per ledger and sweeps listeners left by another
    ledger (or a re-imported module), so one build never counts twice.
    """

    def __init__(self, *, namespace: str = "", job: str = "",
                 uid: str = "", worker: int = 0,
                 clock: Optional[Clock] = None,
                 tracer: Optional[Tracer] = None,
                 generation: Optional[str] = None,
                 capacity: int = 256) -> None:
        self.namespace = namespace
        self.job = job
        self.worker = worker
        self.clock: Clock = clock if clock is not None else time.time
        self.tracer = (tracer if tracer is not None
                       else Tracer(clock=self.clock))
        self.trace_id, self.root_span_id = tpujob_trace_ids(
            namespace, job, uid)
        self._generation = generation
        self.capacity = max(1, int(capacity))
        self.events: List[CompileEvent] = []
        self._seq_by_module: Dict[str, int] = {}
        self._charged = 0.0
        self._build_spans: List[Tuple[float, float]] = []
        self._lock = threading.Lock()
        self._listener: Optional[Callable[..., None]] = None
        # constructing with job identity announces the ground-truth
        # source: job_compile_seconds() reads 0.0 from here on
        if self.job:
            with _TOTALS_LOCK:
                _JOB_COMPILE_TOTALS.setdefault(
                    (self.namespace, self.job),
                    {"seconds": 0.0, "count": 0})

    @property
    def generation(self) -> str:
        if self._generation is None:
            try:
                self._generation = backend_generation()
            except Exception:  # noqa: BLE001
                self._generation = "unknown"
        return self._generation

    # -- recording ---------------------------------------------------------

    def record(self, module: str, seconds: float, *,
               shape_class: str = "", generation: str = "",
               fingerprint: str = "", end: Optional[float] = None,
               job_seconds: Optional[float] = None) -> CompileEvent:
        """Ledger one compilation: histogram observation, ``compile``
        span parented on the job's root, per-job total (``job_seconds``
        of it, default all of ``seconds``: a build that overlaps another
        adds only its own share), bounded event list. Never raises."""
        seconds = max(float(seconds), 0.0)
        charge = seconds if job_seconds is None else max(
            0.0, min(float(job_seconds), seconds))
        end_ts = float(end) if end is not None else float(self.clock())
        gen = generation or self.generation
        sc = shape_class or "unknown"
        ev = CompileEvent(module=module, seconds=seconds,
                          shape_class=sc, generation=gen,
                          fingerprint=fingerprint,
                          start=end_ts - seconds, end=end_ts)
        with self._lock:
            seq = self._seq_by_module.get(module, 0)
            self._seq_by_module[module] = seq + 1
            self.events.append(ev)
            self._charged += charge
            if len(self.events) > self.capacity:
                del self.events[:len(self.events) - self.capacity]
        try:
            observe_compile(seconds, module=module, shape_class=sc,
                            generation=gen, namespace=self.namespace,
                            job=self.job)
        except Exception:  # noqa: BLE001
            log.debug("compile metric failed (continuing)", exc_info=True)
        if self.job:
            with _TOTALS_LOCK:
                t = _JOB_COMPILE_TOTALS.setdefault(
                    (self.namespace, self.job),
                    {"seconds": 0.0, "count": 0})
                t["seconds"] += charge
                t["count"] += 1
        try:
            attrs: Dict[str, Any] = {
                "module": module, "shape_class": sc, "generation": gen,
                "seconds": round(seconds, 6), "worker": self.worker}
            if fingerprint:
                attrs["fingerprint"] = fingerprint
            self.tracer.record(
                f"compile/{module}", start=ev.start, end=ev.end,
                parent=SpanContext(self.trace_id, self.root_span_id),
                span_id=compile_span_id(self.trace_id, self.worker,
                                        module, seq),
                attrs=attrs)
        except Exception:  # noqa: BLE001
            log.debug("compile span failed (continuing)", exc_info=True)
        return ev

    def total_seconds(self) -> float:
        """Compile seconds charged to the job: overlapping builds once."""
        with self._lock:
            return self._charged

    def summary(self) -> Dict[str, Any]:
        """The bench-artifact ``compile`` block shape (``seconds`` as
        :meth:`total_seconds`; ``by_module`` each module's own)."""
        with self._lock:
            evs = list(self.events)
            charged = self._charged
        out: Dict[str, Any] = {
            "count": len(evs),
            "seconds": round(charged, 6),
        }
        if evs:
            by_mod: Dict[str, float] = {}
            for e in evs:
                by_mod[e.module] = by_mod.get(e.module, 0.0) + e.seconds
            out["by_module"] = {m: round(s, 6)
                                for m, s in sorted(by_mod.items())}
            out["generation"] = evs[-1].generation
        return out

    def events_payload(self) -> Dict[str, Any]:
        """Every ledgered event, JSON-serializable."""
        with self._lock:
            evs = list(self.events)
        return {"compile_events": [dataclasses.asdict(e) for e in evs]}

    # -- ops/_build.py subscription ----------------------------------------

    def _on_build(self, event: Any) -> None:
        """One library built: its nvcc's wall, charged to the job only
        where no earlier build of this ledger already covers it."""
        with self._lock:
            charge = _uncovered(self._build_spans, event.start, event.end)
        self.record(f"{event.name}.cu", event.seconds,
                    shape_class=BUILD_SHAPE_CLASS,
                    fingerprint=event.fingerprint, end=event.end,
                    job_seconds=charge)

    def install(self) -> bool:
        """Subscribe to ``ops/_build.py``'s build events. Idempotent per
        ledger (a second call is a no-op); a listener another ledger
        left is swept first, so a build is ledgered at most once.
        Returns True when a new listener was registered."""
        from kubeflow_tpu_torch.ops import _build

        with self._lock:
            if self._listener is not None:
                return False

            def _cb(event: Any) -> None:
                try:
                    self._on_build(event)
                except Exception:  # noqa: BLE001 — never fail the build
                    log.debug("compile listener failed (continuing)",
                              exc_info=True)

            _cb._kftpu_compile_listener = True
            for cb in [cb for cb in _build.listeners
                       if getattr(cb, "_kftpu_compile_listener", False)]:
                _build.listeners.remove(cb)
            _build.listeners.append(_cb)
            self._listener = _cb
        return True

    def uninstall(self) -> bool:
        """Remove ONLY this ledger's callback; True when it was still
        subscribed."""
        from kubeflow_tpu_torch.ops import _build

        with self._lock:
            cb, self._listener = self._listener, None
        if cb is None or cb not in _build.listeners:
            return False
        _build.listeners.remove(cb)
        return True

    def __enter__(self) -> "CompileLedger":
        self.install()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    # -- the first call of any function ------------------------------------

    def timed_compile(self, fn: Callable, *args: Any, module: str = "",
                      **kwargs: Any) -> Any:
        """Run the first call of ``fn`` under the ledger's clock and the
        allocator: one compile event (its wall, the arguments' shape
        class, :func:`call_fingerprint`) and its memory budget beside it.
        Returns the call's result."""
        name = module or getattr(fn, "__name__", "") or "call"
        sc = shape_class_of(*args)
        t0 = self.clock()
        result, budget = measured_call(fn, *args, **kwargs)
        t1 = self.clock()
        fp = call_fingerprint(fn, *args)
        self.record(name, t1 - t0, shape_class=sc, fingerprint=fp, end=t1)
        try:
            _record_budget(budget, module=name, shape_class=sc,
                           generation=self.generation, fingerprint=fp)
        except Exception:  # noqa: BLE001
            log.debug("memory budget failed (continuing)", exc_info=True)
        return result


# -- device-memory watermarks ------------------------------------------------


def _device_memory_stats(index: int = 0) -> Optional[Mapping[str, Any]]:
    """The reference's ``memory_stats()`` keys for CUDA device ``index``
    (clamped to the visible cards); None without CUDA or on any probe
    failure — the sampler's silent-degrade contract."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        dev = min(index, torch.cuda.device_count() - 1)
        stats = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                               0),
                "bytes_limit": torch.cuda.mem_get_info(dev)[1]}
    except Exception:  # noqa: BLE001
        return None


class HbmSampler:
    """Samples device-memory watermarks into the ``kftpu_hbm_*`` gauges
    and a beacon-ready snapshot.

    ``source`` is the injectable stats callable (tests inject a fake;
    the default reads the CUDA allocator of ``device_index``). A source
    returning None — every CPU run — degrades silently: no gauges, no
    beacon fields, no errors. ``peak`` is the max seen across samples."""

    def __init__(self, *, namespace: str = "", job: str = "",
                 worker: Optional[int] = None, model: str = "",
                 source: Optional[Callable[[], Optional[
                     Mapping[str, Any]]]] = None,
                 device_index: int = 0) -> None:
        self.namespace = namespace
        self.job = job
        self.worker = worker
        self.model = model
        self.source = source
        self.device_index = device_index
        self.peak_seen = 0.0
        self.last: Dict[str, float] = {}

    def sample(self) -> Optional[Dict[str, float]]:
        """One watermark sample → gauges; returns the kind → bytes
        dict, or None on silent degrade. Never raises."""
        try:
            stats = (self.source() if self.source is not None
                     else _device_memory_stats(self.device_index))
        except Exception:  # noqa: BLE001 — sampling never fails a step
            log.debug("hbm sample failed (continuing)", exc_info=True)
            return None
        if not stats:
            return None
        try:
            in_use = float(stats.get("bytes_in_use", 0) or 0)
            limit = float(stats.get("bytes_limit", 0) or 0)
            peak = float(stats.get("peak_bytes_in_use", 0) or 0)
            self.peak_seen = max(self.peak_seen, peak, in_use)
            out = {"in_use": in_use, "peak": self.peak_seen,
                   "limit": limit}
            ident = {"namespace": self.namespace, "job": self.job,
                     "worker": self.worker, "model": self.model}
            for kind in HBM_KINDS:
                set_hbm_bytes(kind, out[kind], **ident)
            if limit > 0:
                set_hbm_utilization(in_use / limit, **ident)
            self.last = out
            return out
        except Exception:  # noqa: BLE001
            log.debug("hbm sample failed (continuing)", exc_info=True)
            return None

    def beacon_fields(self) -> Dict[str, Any]:
        """The ``hbm`` block a step-telemetry beacon carries; empty
        before the first successful sample (always empty on the CPU)."""
        if not self.last:
            return {}
        return {"inUseBytes": int(self.last["in_use"]),
                "peakBytes": int(self.last["peak"]),
                "limitBytes": int(self.last["limit"])}
