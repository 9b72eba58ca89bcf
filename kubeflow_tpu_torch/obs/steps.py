"""Training-plane step telemetry: step clock, MFU/recompile accounting,
flight recorder, and per-host health beacons.

PyTorch port of ``kubeflow_tpu/obs/steps.py``; the pieces and their
contracts are the reference's:

- :class:`StepRecord` / :class:`FlightRecorder` — one record per train
  step in a thread-safe bounded ring, dumped when something goes wrong.
- :class:`StepTelemetry` — wraps any step callable on the
  injectable-Clock contract. Per step it records wall time, tokens/s /
  examples/s, MFU and recompile events; feeds the
  ``train_step_seconds`` histogram and the gauges and counters into a
  :class:`~kubeflow_tpu_torch.utils.metrics.Registry`, emits beacons,
  and dumps the flight ring through :mod:`kubeflow_tpu_torch.obs.export`
  on a step failure or a slow step.
- identity-derived trace ids (:func:`tpujob_trace_ids`), beacons over
  ConfigMaps (:func:`publish_beacon` / :func:`read_beacons` /
  :func:`kube_beacon_sink`, any client with ``apply``/``list``), and the
  straggler policy (:func:`flag_stragglers` / :func:`telemetry_view`),
  copied unchanged.

Where the reference leans on XLA, eager PyTorch differs:

- recompiles: eager torch has no jit cache, so :func:`_jit_cache_size`
  finds none on the port's steps and the detector takes the reference's
  step-time-outlier fallback;
- FLOPs: XLA's cost analysis compiles a step without running it; torch
  cannot count without running, so the FIRST step runs under
  ``torch.utils.flop_counter.FlopCounterMode`` and is the probe (no
  extra run). An explicit ``flops_per_step`` overrides it. The flash
  attention autograd function registers no flop formula, so on CUDA
  flash paths the count leaves attention out. The probe counts this
  rank's work; each of the ``n_chips`` ranks of a step does as much, so
  the step's FLOPs are ``n_chips`` times the count;
- peak FLOP/s: from ``torch.cuda.get_device_name`` (H100 SXM 989e12
  bf16 dense; ``KFTPU_PEAK_TFLOPS`` overrides), absent on the CPU;
- ``sync=True`` blocks with ``torch.cuda.synchronize()``; metrics are
  read (``.item()``) only then. The hot path keeps ``sync=False``.

Telemetry is best-effort BY CONTRACT: no code path here may fail a
training step — beacon sinks, dumps and the FLOP probe all degrade
silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from kubeflow_tpu_torch.obs.export import chrome_trace, otlp_lines
from kubeflow_tpu_torch.obs.trace import Span, SpanContext, Tracer
from kubeflow_tpu_torch.utils.clock import Clock
from kubeflow_tpu_torch.utils.metrics import (
    DEFAULT_REGISTRY,
    Registry,
    STEP_TIME_BUCKETS,
)

log = logging.getLogger(__name__)

# cross-component contract strings: the TpuJob operator's JOB_LABEL and
# CR identity (the reference's kubeflow_tpu/operators/tpujob.py and
# manifests/components/tpujob_operator.py; tests pin them equal)
TPUJOB_API_VERSION = "kubeflow-tpu.org/v1alpha1"
TPUJOB_KIND = "TpuJob"
JOB_NAME_LABEL = "kubeflow-tpu.org/job-name"
TELEMETRY_LABEL = "kubeflow-tpu.org/telemetry"
WORKER_KEY = "worker"
BEACON_KEY = "beacon"

ENV_FLIGHT_DIR = "KFTPU_FLIGHT_DIR"
ENV_JOB_UID = "KFTPU_JOB_UID"

DEFAULT_STRAGGLER_STEPS = 10


# -- identity-derived trace ids ----------------------------------------------


def tpujob_trace_ids(ns: str, name: str, uid: str = "") -> Tuple[str, str]:
    """Deterministic ``(trace_id, root span_id)`` for a TpuJob CR —
    the workflow controller's ``workflow_trace_ids``
    scheme for the training plane: every worker and every operator
    reconcile derives the SAME trace from object identity (the operator
    injects the uid as ``KFTPU_JOB_UID``), so per-step spans from eight
    hosts and the operator's root span assemble into one tree."""
    h = hashlib.sha256(f"tpujob/{ns}/{name}/{uid}".encode()).hexdigest()
    return h[:32], h[32:48]


def step_span_id(trace_id: str, worker: int, step: int) -> str:
    """Stable span id for one worker's step-window span, so a replayed
    emission re-records the identical span instead of forking."""
    h = hashlib.sha256(f"{trace_id}/w{worker}/step/{step}".encode())
    return h.hexdigest()[:16]


# -- flight recorder ---------------------------------------------------------


@dataclasses.dataclass
class StepRecord:
    """One training step as the flight recorder keeps it."""

    step: int
    start: float
    end: float
    tokens: int = 0
    examples: int = 0
    recompile: bool = False
    status: str = "OK"
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_span(self, trace_id: str, parent_id: Optional[str],
                worker: int = 0) -> Span:
        attrs: Dict[str, Any] = {"step": self.step, "worker": worker}
        if self.tokens:
            attrs["tokens"] = self.tokens
        if self.examples:
            attrs["examples"] = self.examples
        if self.recompile:
            attrs["recompile"] = True
        attrs.update(self.metrics)
        return Span(trace_id=trace_id,
                    span_id=step_span_id(trace_id, worker, self.step),
                    parent_id=parent_id, name=f"train.step/{self.step}",
                    start=self.start, end=self.end, attrs=attrs,
                    status=self.status)


class FlightRecorder:
    """Thread-safe bounded ring of recent :class:`StepRecord`.

    The black-box-recorder contract: always on, memory bounded hard
    (a week-long job keeps the last ``capacity`` steps, not an archive),
    snapshot-dumped when a step fails or goes slow."""

    def __init__(self, capacity: int = 512) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._records: List[StepRecord] = []
        self._next = 0          # ring write cursor
        self._seq = 0           # total records ever (eviction accounting)
        self._lock = threading.Lock()

    def record(self, rec: StepRecord) -> None:
        with self._lock:
            if len(self._records) < self.capacity:
                self._records.append(rec)
            else:
                self._records[self._next] = rec
                self._next = (self._next + 1) % self.capacity
            self._seq += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._seq

    def records(self) -> List[StepRecord]:
        """Snapshot, oldest first."""
        with self._lock:
            return self._records[self._next:] + self._records[:self._next]

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self._next = 0


# -- helpers -----------------------------------------------------------------


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0


def _jit_cache_size(fn: Any) -> Optional[int]:
    """Compiled-executable cache size of a callable that exposes one
    (``_cache_size``, as jax's jit wrappers do); None for the port's
    eager steps, which have no cache, so the recompile detector takes
    its step-time-outlier fallback."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:  # noqa: BLE001 — accounting only, never fails a step
        return None


def _flop_counter():
    """A ``FlopCounterMode`` that prints nothing, or None where torch
    lacks one (the probe then degrades: MFU needs ``flops_per_step``)."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        return FlopCounterMode(display=False)
    except Exception:  # noqa: BLE001
        return None


# bf16 dense peak FLOP/s by device-name fragment, most specific first
_PEAK_FLOPS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
               ("H100", 989e12), ("H200", 989e12))


def _detect_peak_flops() -> float:
    """bf16 peak FLOP/s of the attached card (0.0 = unknown/CPU);
    ``KFTPU_PEAK_TFLOPS`` overrides, as in the reference."""
    override = os.environ.get("KFTPU_PEAK_TFLOPS")
    if override:
        return float(override) * 1e12
    try:
        import torch

        if not torch.cuda.is_available():
            return 0.0
        name = torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001 — no device: MFU just absent
        return 0.0
    return next((peak for frag, peak in _PEAK_FLOPS if frag in name), 0.0)


# -- the step telemetry layer ------------------------------------------------


class StepTelemetry:
    """Wraps a trainer-built ``run`` callable and accounts every step.

    >>> telem = StepTelemetry(job="lm", namespace="default", worker=0,
    ...                       tokens_per_step=batch * seq)
    >>> step_fn = telem.wrap(make_lm_train_step(mesh))
    >>> for _ in range(steps):
    ...     state, metrics = step_fn(state, tokens)

    Everything is injectable (clock, registry, tracer, recorder, beacon
    sink) and everything degrades: telemetry never fails a train step.

    ``sync=True`` synchronizes the card before reading the end
    timestamp (and extracts float-able outputs into the record's
    metrics) — right for tests and log-cadence loops; leave False on
    the hot path so the launch queue keeps the card busy.
    """

    def __init__(
        self,
        *,
        job: str = "",
        namespace: str = "default",
        uid: str = "",
        worker: int = 0,
        clock: Optional[Clock] = None,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
        recorder: Optional[FlightRecorder] = None,
        capacity: int = 512,
        tokens_per_step: int = 0,
        examples_per_step: int = 0,
        flops_per_step: Optional[float] = None,
        peak_flops_per_chip: Optional[float] = None,
        n_chips: int = 1,
        use_cost_analysis: bool = True,
        sync: bool = False,
        slow_step_factor: float = 3.0,
        min_slow_history: int = 5,
        dump_cooldown_steps: int = 50,
        span_every: int = 0,
        beacon_sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        beacon_every: int = 1,
        dump_dir: Optional[str] = None,
        rate_window: int = 20,
        hbm_sampler: Optional[Any] = None,
    ) -> None:
        self.job = job
        self.namespace = namespace
        self.worker = worker
        # wall clock, not monotonic (the workflow controller's reasoning,
        # applied to training): the per-step spans this clock stamps join
        # the operator's terminal root span — recorded on ITS epoch
        # clock — in one identity-derived trace, and beacon ``ts`` values
        # are compared across hosts; monotonic is host-uptime-relative
        # and would scramble both
        self.clock: Clock = clock if clock is not None else time.time
        self.registry = registry if registry is not None else DEFAULT_REGISTRY
        self.recorder = (recorder if recorder is not None
                         else FlightRecorder(capacity))
        self.trace_id, self.root_span_id = tpujob_trace_ids(
            namespace, job, uid)
        # span timestamps share THIS clock (fake-clock determinism)
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self.clock)
        self.tokens_per_step = tokens_per_step
        self.examples_per_step = examples_per_step
        self.flops_per_step = flops_per_step
        self._peak = peak_flops_per_chip  # None = detect lazily
        self.n_chips = max(1, n_chips)
        self.use_cost_analysis = use_cost_analysis
        self.sync = sync
        self.slow_step_factor = slow_step_factor
        self.min_slow_history = min_slow_history
        self.dump_cooldown_steps = dump_cooldown_steps
        self.span_every = span_every
        self.beacon_sink = beacon_sink
        self.beacon_every = max(1, beacon_every)
        self.dump_dir = (dump_dir if dump_dir is not None
                         else os.environ.get(ENV_FLIGHT_DIR) or None)
        # an obs.xprof.HbmSampler (or anything with sample()/
        # beacon_fields()); sampled once per step so the beacon
        # carries live device-memory watermarks. None — and every
        # CPU backend, whose sampler returns None — degrades to no
        # hbm block at all (telemetry contract: never fails a step)
        self.hbm_sampler = hbm_sampler

        self.step = 0
        self.recompiles = 0
        self.dumps = 0
        self.last_dump: Optional[Tuple[str, Dict[str, Any]]] = None
        self._durations: List[float] = []   # rolling, rate_window-bounded
        self._rate_window = max(2, rate_window)
        self._last_dump_step = -(10 ** 9)
        self._probed_cost = False

        lbl = {"job": job} if job else {}
        self._labels = lbl
        self._h_step = self.registry.histogram(
            "train_step_seconds", "train step wall time",
            buckets=STEP_TIME_BUCKETS)
        self._c_steps = self.registry.counter(
            "train_steps_total", "train steps completed")
        self._c_recompiles = self.registry.counter(
            "train_recompiles_total", "train step recompile events")
        self._g_last_step = self.registry.gauge(
            "train_last_step", "last completed train step")
        self._g_steps_per_sec = self.registry.gauge(
            "train_steps_per_sec", "rolling steps/sec")
        self._g_tokens_per_sec = self.registry.gauge(
            "train_tokens_per_sec", "rolling tokens/sec")
        self._g_examples_per_sec = self.registry.gauge(
            "train_examples_per_sec", "rolling examples/sec")
        self._g_mfu = self.registry.gauge(
            "train_mfu", "model FLOPs utilization (0..1)")

    # -- wrapping ----------------------------------------------------------

    def wrap(self, run: Callable[..., Any]) -> Callable[..., Any]:
        """The instrumented step: times ``run``, accounts, re-raises.
        The first step runs under the FLOP counter unless FLOPs are
        given or ``use_cost_analysis`` is off."""
        jitted = getattr(run, "jitted", run)

        def instrumented(*args: Any, **kwargs: Any) -> Any:
            cache_before = _jit_cache_size(jitted)
            counter = self._probe_counter()
            start = self.clock()
            try:
                if counter is not None:
                    with counter:
                        out = run(*args, **kwargs)
                else:
                    out = run(*args, **kwargs)
                if self.sync:
                    out = _block(out)
            except BaseException as e:
                end = self.clock()
                self._on_step(start, end, cache_before, jitted,
                              status=f"ERROR: {type(e).__name__}",
                              out=None)
                raise
            end = self.clock()
            if counter is not None:
                self._read_probe(counter)
            self._on_step(start, end, cache_before, jitted, status="OK",
                          out=out)
            return out

        instrumented.telemetry = self  # introspection/bench handle
        if jitted is not run:
            instrumented.jitted = jitted
        return instrumented

    # -- per-step accounting ----------------------------------------------

    def _probe_counter(self) -> Any:
        if (self._probed_cost or not self.use_cost_analysis
                or self.flops_per_step is not None):
            return None
        self._probed_cost = True
        return _flop_counter()

    def _read_probe(self, counter: Any) -> None:
        try:
            flops = float(counter.get_total_flops()) * self.n_chips
            self.flops_per_step = flops if flops > 0 else None
        except Exception:  # noqa: BLE001 — telemetry must not fail the step
            self.flops_per_step = None

    def _on_step(self, start: float, end: float,
                 cache_before: Optional[int], jitted: Any, *,
                 status: str, out: Any) -> None:
        self.step += 1
        dur = max(end - start, 0.0)
        recompile = self._detect_recompile(cache_before, jitted, dur)
        if recompile:
            self.recompiles += 1
            self._c_recompiles.inc(**self._labels)
        rec = StepRecord(step=self.step, start=start, end=end,
                         tokens=self.tokens_per_step,
                         examples=self.examples_per_step,
                         recompile=recompile, status=status,
                         metrics=_extract_metrics(out) if self.sync else {})
        self.recorder.record(rec)
        self._durations.append(dur)
        if len(self._durations) > self._rate_window:
            self._durations.pop(0)

        self._h_step.observe(dur, **self._labels)
        self._c_steps.inc(**self._labels)
        self._g_last_step.set(self.step, **self._labels)
        rates = self._rates()
        self._g_steps_per_sec.set(rates["steps_per_sec"], **self._labels)
        if self.tokens_per_step:
            self._g_tokens_per_sec.set(rates["tokens_per_sec"],
                                       **self._labels)
        if self.examples_per_step:
            self._g_examples_per_sec.set(rates["examples_per_sec"],
                                         **self._labels)
        mfu = self.mfu()
        if mfu is not None:
            self._g_mfu.set(mfu, **self._labels)

        if self.hbm_sampler is not None:
            try:
                self.hbm_sampler.sample()
            except Exception:  # noqa: BLE001 — watermarks never fail a step
                log.debug("hbm sample failed (continuing)", exc_info=True)
        if self.span_every and (self.step % self.span_every == 0
                                or status != "OK"):
            self._record_step_span(rec)
        if status != "OK":
            self.dump("failure")
        elif self._is_slow(dur):
            self.dump("slow_step")
        if self.beacon_sink is not None and (
                self.step % self.beacon_every == 0 or status != "OK"):
            try:
                self.beacon_sink(self.beacon())
            except Exception:  # noqa: BLE001 — beacons never fail a step
                log.debug("beacon sink failed (continuing)", exc_info=True)

    def _detect_recompile(self, cache_before: Optional[int], jitted: Any,
                          dur: float) -> bool:
        cache_after = _jit_cache_size(jitted)
        if cache_before is not None and cache_after is not None:
            # includes the first fill (0 -> 1): the initial compile is a
            # compile — the flight record for step 1 should say so
            return cache_after > cache_before
        # fallback: a step-time outlier against the rolling median —
        # recompiles stall the host for seconds while neighbors take ms
        history = self._durations
        if len(history) < self.min_slow_history:
            return False
        return dur > self.slow_step_factor * _median(history)

    def _is_slow(self, dur: float) -> bool:
        prior = self._durations[:-1]  # exclude the step under test
        if len(prior) < self.min_slow_history:
            return False
        if dur <= self.slow_step_factor * _median(prior):
            return False
        if self.step - self._last_dump_step < self.dump_cooldown_steps:
            return False  # cooldown: one dump per incident, not per step
        return True

    def _record_step_span(self, rec: StepRecord) -> None:
        try:
            self.tracer.record(
                f"train.step/{rec.step}", start=rec.start, end=rec.end,
                parent=SpanContext(self.trace_id, self.root_span_id),
                span_id=step_span_id(self.trace_id, self.worker, rec.step),
                attrs={"worker": self.worker, "step": rec.step,
                       "recompile": rec.recompile},
                status=rec.status)
        except Exception:  # noqa: BLE001
            log.debug("step span record failed (continuing)", exc_info=True)

    # -- derived views -----------------------------------------------------

    def _rates(self) -> Dict[str, float]:
        total = sum(self._durations)
        n = len(self._durations)
        sps = (n / total) if total > 0 else 0.0
        return {
            "steps_per_sec": sps,
            "tokens_per_sec": sps * self.tokens_per_step,
            "examples_per_sec": sps * self.examples_per_step,
        }

    def mfu(self) -> Optional[float]:
        """Rolling-window MFU; None when FLOPs or peak are unknown."""
        if not self.flops_per_step:
            return None
        if self._peak is None:
            self._peak = _detect_peak_flops()
        if not self._peak or not self._durations:
            return None
        sec = _median(self._durations)
        if sec <= 0:
            return None
        return (self.flops_per_step / sec) / (self._peak * self.n_chips)

    def beacon(self) -> Dict[str, Any]:
        """The per-host health beacon the operator aggregates."""
        rates = self._rates()
        mfu = self.mfu()
        hbm: Dict[str, Any] = {}
        if self.hbm_sampler is not None:
            try:
                hbm = self.hbm_sampler.beacon_fields() or {}
            except Exception:  # noqa: BLE001
                hbm = {}
        return {
            "worker": self.worker,
            "job": self.job,
            "step": self.step,
            "stepsPerSec": round(rates["steps_per_sec"], 4),
            "tokensPerSec": round(rates["tokens_per_sec"], 2),
            "examplesPerSec": round(rates["examples_per_sec"], 2),
            "mfu": round(mfu, 4) if mfu is not None else None,
            "recompiles": self.recompiles,
            "lastStepSeconds": round(self._durations[-1], 6)
            if self._durations else None,
            "hbm": hbm,
            "ts": self.clock(),
        }

    def summary(self) -> Dict[str, Any]:
        """Step-regularity summary (the BENCH-artifact shape): p50/p99
        step time, recompile count, MFU."""
        durs = sorted(r.duration for r in self.recorder.records())
        out: Dict[str, Any] = {
            "steps": self.step,
            "p50_step_s": round(_percentile(durs, 0.50), 6),
            "p99_step_s": round(_percentile(durs, 0.99), 6),
            "recompiles": self.recompiles,
        }
        mfu = self.mfu()
        if mfu is not None:
            out["mfu"] = round(mfu, 4)
        return out

    def objective_series(self, metric: str) -> List[Tuple[int, float]]:
        """Per-step ``(step, value)`` series for a named metric — what
        the tuning plane's history reads (``append_history_from_telemetry``
        in the reference). Resolves recorded step metrics (e.g.
        ``loss`` under ``sync=True``) first, then the derived series
        ``step_seconds`` / ``steps_per_sec`` / ``tokens_per_sec`` /
        ``examples_per_sec`` / ``mfu``."""
        out: List[Tuple[int, float]] = []
        peak_mfu_ready = bool(self.flops_per_step) and bool(
            self._peak if self._peak is not None else _detect_peak_flops())
        for rec in self.recorder.records():
            if rec.status != "OK":
                continue
            if metric in rec.metrics:
                out.append((rec.step, float(rec.metrics[metric])))
                continue
            dur = rec.duration
            if dur <= 0:
                continue
            if metric == "step_seconds":
                out.append((rec.step, dur))
            elif metric == "steps_per_sec":
                out.append((rec.step, 1.0 / dur))
            elif metric == "tokens_per_sec" and rec.tokens:
                out.append((rec.step, rec.tokens / dur))
            elif metric == "examples_per_sec" and rec.examples:
                out.append((rec.step, rec.examples / dur))
            elif metric == "mfu" and peak_mfu_ready:
                if self._peak is None:
                    self._peak = _detect_peak_flops()
                out.append((rec.step, (self.flops_per_step / dur)
                            / (self._peak * self.n_chips)))
        return out

    # -- flight-recorder dump ----------------------------------------------

    def dump(self, reason: str) -> Dict[str, Any]:
        """Dump the flight ring through the Chrome-trace exporter (and
        ndjson when a dump dir is configured). Returns the Chrome trace
        dict; failures degrade to an empty dict — a broken disk must
        never fail the training step that triggered the dump."""
        try:
            spans = [r.to_span(self.trace_id, self.root_span_id,
                               worker=self.worker)
                     for r in self.recorder.records()]
            chrome = chrome_trace(spans)
            self.dumps += 1
            self._last_dump_step = self.step
            self.last_dump = (reason, chrome)
            if self.dump_dir:
                os.makedirs(self.dump_dir, exist_ok=True)
                stem = f"flight-w{self.worker}-{reason}-step{self.step}"
                path = os.path.join(self.dump_dir, stem + ".trace.json")
                with open(path, "w") as f:
                    json.dump(chrome, f)
                with open(os.path.join(self.dump_dir,
                                       stem + ".ndjson"), "w") as f:
                    f.write(otlp_lines(spans))
                log.warning("flight recorder dumped (%s) to %s",
                            reason, path)
            return chrome
        except Exception:  # noqa: BLE001 — never fail the step
            log.warning("flight-recorder dump failed (continuing)",
                        exc_info=True)
            return {}


def _block(out: Any) -> Any:
    """Wait for the card to finish the step's work (sync mode)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    except Exception:  # noqa: BLE001 — never fail the step
        pass
    return out


def _extract_metrics(out: Any) -> Dict[str, float]:
    """Float-able scalars from a ``(state, metrics)`` step result (the
    trainer contract) — only under ``sync=True``, where reading a device
    scalar (``.item()``) costs no extra wait."""
    metrics: Any = None
    if isinstance(out, tuple) and len(out) == 2 and isinstance(
            out[1], Mapping):
        metrics = out[1]
    elif isinstance(out, Mapping):
        metrics = out
    if metrics is None:
        return {}
    extracted: Dict[str, float] = {}
    for k, v in metrics.items():
        try:
            if hasattr(v, "__float__") or isinstance(v, (int, float)):
                f = float(v)
                if f == f:  # drop NaN — it poisons downstream medians
                    extracted[str(k)] = f
        except (TypeError, ValueError):
            continue
    return extracted


# -- beacons over ConfigMaps -------------------------------------------------


def beacon_configmap_name(job: str, worker: int) -> str:
    return f"{job}-telemetry-w{worker}"


def publish_beacon(client: Any, ns: str, job: str, worker: int,
                   beacon: Mapping[str, Any], job_uid: str = "") -> None:
    """Write one worker's beacon into its own ConfigMap. One ConfigMap
    per worker: the gang's hosts never read-modify-write a shared
    object, so there is no lost-update race at any world size.
    ``job_uid`` (the operator-injected CR uid) stamps an ownerReference
    so beacons are garbage-collected with the TpuJob instead of
    accumulating across job churn."""
    md: Dict[str, Any] = {"name": beacon_configmap_name(job, worker)}
    if ns:
        md["namespace"] = ns
    cm = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": md,
          "data": {BEACON_KEY: json.dumps(dict(beacon)),
                   WORKER_KEY: str(worker)}}
    cm["metadata"]["labels"] = {JOB_NAME_LABEL: job,
                                TELEMETRY_LABEL: "beacon"}
    if job_uid:
        cm["metadata"]["ownerReferences"] = [{
            "apiVersion": TPUJOB_API_VERSION, "kind": TPUJOB_KIND,
            "name": job, "uid": job_uid, "controller": True}]
    client.apply(cm)


def read_beacons(client: Any, ns: str, job: str,
                 max_workers: Optional[int] = None
                 ) -> Dict[int, Dict[str, Any]]:
    """worker index -> latest beacon, from the labeled ConfigMaps.

    ``max_workers`` filters out beacons beyond the CURRENT world size —
    after an elastic downsize, the departed workers' last beacons would
    otherwise drag the gang median and flag every live worker as a
    straggler."""
    out: Dict[int, Dict[str, Any]] = {}
    for cm in client.list("v1", "ConfigMap", ns,
                          label_selector={JOB_NAME_LABEL: job,
                                          TELEMETRY_LABEL: "beacon"}):
        data = cm.get("data") or {}
        try:
            worker = int(data.get(WORKER_KEY, ""))
            if max_workers is not None and worker >= max_workers:
                continue
            out[worker] = json.loads(data.get(BEACON_KEY, "{}"))
        except (TypeError, ValueError):
            continue  # a garbled beacon must not hide the others
    return out


def kube_beacon_sink(client: Any, ns: str, job: str, worker: int,
                     job_uid: str = "") -> Callable[[Dict[str, Any]], None]:
    """A :class:`StepTelemetry` ``beacon_sink`` publishing to the
    cluster. Transport errors are swallowed (telemetry contract)."""

    def sink(beacon: Dict[str, Any]) -> None:
        try:
            publish_beacon(client, ns, job, worker, beacon,
                           job_uid=job_uid)
        except Exception:  # noqa: BLE001
            log.debug("beacon publish failed (continuing)", exc_info=True)

    return sink


# -- straggler policy + the aggregated view ----------------------------------


def flag_stragglers(
    steps_by_worker: Mapping[Any, int], k: int = DEFAULT_STRAGGLER_STEPS,
) -> Tuple[float, Dict[Any, int], List[Any]]:
    """``(median_step, lag_by_worker, stragglers)``: a worker ≥``k``
    steps behind the gang's median step is a straggler. Median, not max:
    one runaway-ahead worker (clock skew, restarted counter) must not
    flag the whole healthy gang."""
    if not steps_by_worker:
        return 0.0, {}, []
    k = max(1, int(k))
    median = _median([float(s) for s in steps_by_worker.values()])
    lags = {w: max(0, int(median - s)) for w, s in steps_by_worker.items()}
    stragglers = sorted((w for w, lag in lags.items() if lag >= k),
                        key=str)
    return median, lags, stragglers


def _hbm_view(beacons: Mapping[int, Mapping[str, Any]]) -> Dict[str, Any]:
    """Gang-level HBM watermark from the per-worker beacon ``hbm``
    blocks: MAX across workers (the fullest device gates the gang —
    it OOMs first), same shape whether zero or all workers report."""
    blocks = [b.get("hbm") for b in beacons.values()
              if isinstance(b.get("hbm"), Mapping) and b.get("hbm")]
    if not blocks:
        return {"inUseBytes": 0, "peakBytes": 0, "limitBytes": 0,
                "workersReporting": 0}
    return {
        "inUseBytes": max(int(b.get("inUseBytes", 0) or 0)
                          for b in blocks),
        "peakBytes": max(int(b.get("peakBytes", 0) or 0)
                         for b in blocks),
        "limitBytes": max(int(b.get("limitBytes", 0) or 0)
                          for b in blocks),
        "workersReporting": len(blocks),
    }


def telemetry_view(beacons: Mapping[int, Mapping[str, Any]],
                   straggler_k: int = DEFAULT_STRAGGLER_STEPS
                   ) -> Dict[str, Any]:
    """Aggregate per-worker beacons into the job-level telemetry shape
    served in CR status AND by the dashboard route — one function so the
    two surfaces cannot drift.

    ``stepsPerSec`` is the gang's MEDIAN worker rate (SPMD throughput is
    gated by the slowest collective participant; the median is the
    honest central figure next to the per-worker lags), ``lastStep`` the
    max observed step, ``recompiles`` the gang total."""
    if not beacons:
        # SAME keys as the populated branch — consumers must never have
        # to guess which shape they got
        return {"lastStep": 0, "medianStep": 0.0, "stepsPerSec": 0.0,
                "tokensPerSec": 0.0, "mfu": None, "recompiles": 0,
                "hbm": _hbm_view(beacons),
                "workers": {}, "stragglers": [],
                "stragglerThreshold": max(1, int(straggler_k))}
    steps_by = {w: int(b.get("step", 0)) for w, b in beacons.items()}
    median, lags, stragglers = flag_stragglers(steps_by, straggler_k)
    rates = [float(b.get("stepsPerSec") or 0.0) for b in beacons.values()]
    mfus = [float(b["mfu"]) for b in beacons.values()
            if b.get("mfu") is not None]
    workers = {
        str(w): {
            "step": steps_by[w],
            "stepsPerSec": float(beacons[w].get("stepsPerSec") or 0.0),
            "lag": lags[w],
            "recompiles": int(beacons[w].get("recompiles") or 0),
        }
        for w in sorted(beacons)
    }
    return {
        "lastStep": max(steps_by.values()),
        "medianStep": median,
        "stepsPerSec": round(_median(rates), 4),
        "tokensPerSec": round(sum(
            float(b.get("tokensPerSec") or 0.0)
            for b in beacons.values()), 2),
        "mfu": round(_median(mfus), 4) if mfus else None,
        "recompiles": sum(int(b.get("recompiles") or 0)
                          for b in beacons.values()),
        "hbm": _hbm_view(beacons),
        "workers": workers,
        "stragglers": [str(w) for w in stragglers],
        "stragglerThreshold": max(1, int(straggler_k)),
    }
