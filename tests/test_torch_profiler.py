"""The port's trace capture (``torch.profiler``): the cases of
``tests/test_profiler.py`` on the port, on the CPU."""

import json
import logging
import os

import torch

from kubeflow_tpu_torch.utils.profiler import (
    TRACE_SUFFIX,
    StepProfiler,
    annotate,
    trace,
)


def _traces(d):
    return [os.path.join(root, f) for root, _, files in os.walk(d)
            for f in files if f.endswith(TRACE_SUFFIX)]


def _event_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_context_manager_writes_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones((64, 64))
    with trace(logdir):
        with annotate("kftpu-matmul"):
            x @ x
    (path,) = _traces(logdir)
    names = _event_names(path)
    assert "kftpu-matmul" in names
    assert any(n and "mm" in n for n in names), sorted(n for n in names
                                                       if n)[:20]


def test_step_profiler_captures_window(tmp_path):
    """Steps [2, 4) land in one trace; the fake clock's window is
    ``last_capture_s``; steps outside the window are not traced."""
    logdir = str(tmp_path / "steps")
    ticks = iter(range(100))
    prof = StepProfiler(logdir, start=2, n_steps=2,
                        clock=lambda: float(next(ticks)))
    x = torch.ones(8)
    for step in range(6):
        prof.step(step)
        with annotate(f"step-{step}"):
            x * 2
    prof.close()
    (path,) = _traces(logdir)
    assert prof.last_trace == path
    assert prof.last_capture_s == 1.0
    names = _event_names(path)
    assert {"step-2", "step-3"} <= names
    assert not names & {"step-0", "step-1", "step-4", "step-5"}


def test_step_profiler_close_stops_an_open_window(tmp_path):
    logdir = str(tmp_path / "open")
    prof = StepProfiler(logdir, start=0, n_steps=10)
    prof.step(0)
    torch.ones(4) + 1
    prof.close()
    assert len(_traces(logdir)) == 1 and prof.last_capture_s is not None


def test_step_profiler_disabled_is_noop(tmp_path):
    prof = StepProfiler(None)
    for step in range(5):
        prof.step(step)
    prof.close()
    assert not prof.enabled and prof.last_trace is None


def test_step_profiler_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("KFTPU_PROFILE_DIR", str(tmp_path / "envtrace"))
    monkeypatch.setenv("KFTPU_PROFILE_START", "0")
    monkeypatch.setenv("KFTPU_PROFILE_STEPS", "1")
    prof = StepProfiler.from_env()
    assert prof.enabled and prof.start == 0 and prof.stop == 1


def test_step_profiler_from_env_malformed_window(monkeypatch, tmp_path,
                                                 caplog):
    """A typo'd window env var must not crash the worker at boot: the
    profiler warns and comes up disabled."""
    monkeypatch.setenv("KFTPU_PROFILE_DIR", str(tmp_path / "t"))
    monkeypatch.setenv("KFTPU_PROFILE_START", "ten")
    monkeypatch.setenv("KFTPU_PROFILE_STEPS", "3")
    with caplog.at_level(logging.WARNING):
        prof = StepProfiler.from_env()
    assert not prof.enabled
    assert any("KFTPU_PROFILE_START" in r.message for r in caplog.records)
    for step in range(3):
        prof.step(step)
    prof.close()
    assert not os.path.exists(tmp_path / "t")

    monkeypatch.setenv("KFTPU_PROFILE_START", "2")
    monkeypatch.setenv("KFTPU_PROFILE_STEPS", "2.5")
    with caplog.at_level(logging.WARNING):
        prof = StepProfiler.from_env()
    assert not prof.enabled


def test_step_profiler_from_env_malformed_without_dir(monkeypatch, caplog):
    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    monkeypatch.setenv("KFTPU_PROFILE_START", "")
    monkeypatch.setenv("KFTPU_PROFILE_STEPS", "-")
    with caplog.at_level(logging.WARNING):
        prof = StepProfiler.from_env()
    assert not prof.enabled
