"""Launcher scaffolding for the port's training entry points.

PyTorch port of ``kubeflow_tpu/examples/common.py``: ``setup_logging``,
``log_metrics`` (the scrape contract: one JSON line a record on stdout,
and ``<KFTPU_RESULTS_DIR>/<KFTPU_JOB_NAME>.jsonl`` when the operator sets
a results directory), ``checkpoint_dir``, ``launcher_init`` and
``make_step_telemetry``.

``launcher_init`` parses the operator's env contract and resolves the
device. It brings up one process on one device: a job of more than one
process or slice, or with tensor or pipeline parallelism, raises
``NotImplementedError`` (the mesh is ROADMAP Queue A 7) rather than run
on one device in silence.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch.parallel import distributed as dist
from kubeflow_tpu_torch.utils.device import resolve_device


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format=("%(levelname)s|%(asctime)s|%(pathname)s|%(lineno)d| "
                "%(message)s"),
        datefmt="%Y-%m-%dT%H:%M:%S",
        stream=sys.stderr,
    )


def log_metrics(step: int, **metrics: Any) -> None:
    """One JSON line a record on stdout; with ``KFTPU_RESULTS_DIR`` set,
    the same line appended to ``<dir>/<job-name>.jsonl``."""
    rec: Dict[str, Any] = {"step": step, "ts": round(time.time(), 3)}
    for k, v in metrics.items():
        rec[k] = float(v) if hasattr(v, "__float__") else v
    line = json.dumps(rec)
    print(line, flush=True)
    results_dir = os.environ.get("KFTPU_RESULTS_DIR")
    if results_dir:
        job = os.environ.get("KFTPU_JOB_NAME", "job")
        try:
            os.makedirs(results_dir, exist_ok=True)
            with open(os.path.join(results_dir, f"{job}.jsonl"), "a") as f:
                f.write(line + "\n")
        except OSError:
            logging.exception("cannot write results to %s", results_dir)


def launcher_init(*, pp: int = 1, tp: Optional[int] = None, device=None
                  ) -> Tuple[dist.ProcessEnv, torch.device]:
    """The env contract and the device (CUDA unless ``"cpu"`` is asked
    for) of a single-process job."""
    setup_logging()
    penv = dist.from_env()
    refused = [what for what, bad in (
        (f"{penv.num_processes} processes", penv.is_distributed),
        (f"{penv.num_slices} slices", penv.is_multislice),
        (f"tp={tp}", (tp or 1) > 1),
        (f"pp={pp}", pp > 1)) if bad]
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)}: the port runs one process on one "
            "device until the mesh is ported (ROADMAP Queue A 7)")
    dev = resolve_device(device)
    logging.info("launcher up: rank %d/%d, device %s", penv.process_id,
                 penv.num_processes, dev)
    return penv, dev


def checkpoint_dir(default: str = "") -> str:
    return os.environ.get("KFTPU_CHECKPOINT_DIR", default)


def make_step_telemetry(*, tokens_per_step: int = 0,
                        examples_per_step: int = 0, client=None,
                        **kwargs):
    """A :class:`~kubeflow_tpu_torch.obs.steps.StepTelemetry` wired from
    the operator's env contract: job/namespace/uid identity (so the step
    spans join the operator's trace), the worker index, and an
    ``HbmSampler`` of the card's allocator (silent on the CPU).

    Inside a TpuJob gang (``KFTPU_JOB_NAME`` set, ``KFTPU_BEACONS`` not
    0) beacons go to ``client`` through ``kube_beacon_sink``. The port
    has no Kubernetes client of its own yet, so with none given beacons
    are off and the log says so; the reference builds its
    ``HttpKubeClient`` there. ``n_chips`` is 1: the port runs one
    process on one card (:func:`launcher_init`)."""
    from kubeflow_tpu_torch.obs.steps import (
        ENV_JOB_UID,
        StepTelemetry,
        kube_beacon_sink,
    )
    from kubeflow_tpu_torch.obs.xprof import HbmSampler

    penv = dist.from_env()
    job_uid = os.environ.get(ENV_JOB_UID, "")
    sink = None
    if penv.job_name and os.environ.get("KFTPU_BEACONS", "1") != "0":
        if client is None:
            logging.info("step telemetry: no cluster client, beacons off "
                         "for job %s", penv.job_name)
        else:
            sink = kube_beacon_sink(client, penv.namespace, penv.job_name,
                                    penv.process_id, job_uid=job_uid)
    kwargs.setdefault("beacon_every", 10)
    kwargs.setdefault("span_every", 10)
    kwargs.setdefault("n_chips", 1)
    if "hbm_sampler" not in kwargs:
        kwargs["hbm_sampler"] = HbmSampler(
            namespace=penv.namespace, job=penv.job_name,
            worker=penv.process_id)
    return StepTelemetry(
        job=penv.job_name, namespace=penv.namespace, uid=job_uid,
        worker=penv.process_id, tokens_per_step=tokens_per_step,
        examples_per_step=examples_per_step, beacon_sink=sink, **kwargs)
