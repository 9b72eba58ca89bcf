"""Device and host trace capture with ``torch.profiler``.

PyTorch port of ``kubeflow_tpu/utils/profiler.py``: the XLA trace becomes
a ``torch.profiler`` capture of the CPU and, where there is a card, CUDA
activity, written as a Chrome trace (``*.pt.trace.json``, which
TensorBoard's profiler plugin and ``chrome://tracing`` read) under the
log directory.

- :func:`trace` — context manager around any block.
- :class:`StepProfiler` — captures a step window ``[start, start+n)``
  inside a training loop, driven by the operator's env contract
  (``KFTPU_PROFILE_DIR``, ``KFTPU_PROFILE_START``,
  ``KFTPU_PROFILE_STEPS``), so any job can switch it on without a code
  change.
- :func:`annotate` — a named span on the trace's host timeline
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from typing import Iterator, Optional

import torch

from kubeflow_tpu_torch.utils.clock import Clock

log = logging.getLogger(__name__)

ENV_PROFILE_DIR = "KFTPU_PROFILE_DIR"
ENV_PROFILE_START = "KFTPU_PROFILE_START"
ENV_PROFILE_STEPS = "KFTPU_PROFILE_STEPS"
TRACE_SUFFIX = ".pt.trace.json"


def _start(logdir: str) -> torch.profiler.profile:
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, logdir: str) -> str:
    """Stop ``prof`` and write its Chrome trace under ``logdir``; returns
    the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()       # the kernels launched end inside
    prof.stop()
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device and host trace of the enclosed block into
    ``logdir``."""
    prof = _start(logdir)
    try:
        yield
    finally:
        log.info("profiler trace written to %s", _stop(prof, logdir))


def annotate(name: str):
    """Named span on the profiler's host timeline (cheap when idle)."""
    return torch.profiler.record_function(name)


class StepProfiler:
    """Captures steps ``[start, start+n)`` of a training loop.

    Call :meth:`step` once per loop iteration with the global step
    number; the profiler starts and stops the trace on the right
    boundaries. Inactive (no logdir) it costs one compare per step.

    >>> prof = StepProfiler.from_env()          # or StepProfiler(dir, 10, 3)
    >>> for step in range(steps):
    ...     prof.step(step)
    ...     state, m = train_step(state, batch)
    >>> prof.close()                            # safety stop at loop exit

    ``clock`` follows the injectable-clock contract
    (:mod:`kubeflow_tpu_torch.utils.clock`): ``last_capture_s`` is the
    capture window's wall time, trace export included, which step
    telemetry subtracts so profiler overhead never reads as a slow step.
    ``last_trace`` is the path of the last trace written.
    """

    def __init__(self, logdir: Optional[str], start: int = 10,
                 n_steps: int = 3, clock: Optional[Clock] = None) -> None:
        self.logdir = logdir
        self.start = start
        self.stop = start + n_steps
        self.clock: Clock = clock if clock is not None else time.monotonic
        self.last_capture_s: Optional[float] = None
        self.last_trace: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None
        self._t_start = 0.0

    @classmethod
    def from_env(cls, environ=None,
                 clock: Optional[Clock] = None) -> "StepProfiler":
        """Build from the operator's env contract.

        A malformed window int must never kill the worker at boot: a
        typo'd annotation would crash every pod in the gang before the
        first step. Warn and come up with profiling disabled instead.
        """
        env = os.environ if environ is None else environ
        logdir = env.get(ENV_PROFILE_DIR) or None
        window = {ENV_PROFILE_START: 10, ENV_PROFILE_STEPS: 3}
        for key in list(window):
            raw = env.get(key)
            if raw is None or raw == "":
                continue
            try:
                window[key] = int(raw)
            except (TypeError, ValueError):
                log.warning(
                    "%s=%r is not an integer; profiling disabled for "
                    "this run", key, raw)
                logdir = None
        return cls(logdir, start=window[ENV_PROFILE_START],
                   n_steps=window[ENV_PROFILE_STEPS], clock=clock)

    @property
    def enabled(self) -> bool:
        return bool(self.logdir)

    def step(self, step: int) -> None:
        if not self.logdir:
            return
        if self._prof is None and self.start <= step < self.stop:
            self._prof = _start(self.logdir)
            self._t_start = self.clock()
        elif self._prof is not None and step >= self.stop:
            self._finish()
            log.info("profiler trace (steps %d..%d, %.3fs) written to %s",
                     self.start, self.stop - 1, self.last_capture_s,
                     self.last_trace)

    def _finish(self) -> None:
        self.last_trace = _stop(self._prof, self.logdir)
        self._prof = None
        self.last_capture_s = self.clock() - self._t_start

    def close(self) -> None:
        if self._prof is not None:
            self._finish()
            log.info("profiler trace (%.3fs) written to %s",
                     self.last_capture_s, self.last_trace)
