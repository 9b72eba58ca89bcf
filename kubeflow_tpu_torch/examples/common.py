"""Launcher scaffolding for the port's training entry points.

PyTorch port of ``kubeflow_tpu/examples/common.py``: ``setup_logging``,
``log_metrics`` (the scrape contract: one JSON line a record on stdout,
and ``<KFTPU_RESULTS_DIR>/<KFTPU_JOB_NAME>.jsonl`` when the operator sets
a results directory), ``checkpoint_dir``, ``launcher_init``,
``make_step_telemetry``, ``make_compile_ledger`` (the kernel builds this
worker pays, ledgered under the job's identity) and
``report_tuning_metrics`` (a trial's metrics into its study's
ConfigMap).

``launcher_init`` parses the operator's env contract, resolves the
device (``cuda:(process_id % device count)`` unless the CPU is asked
for), joins the process group (NCCL on the card, gloo on the CPU) and
builds the mesh as the reference's does: ``dcn`` over the slices of a
multi-slice job, ``dp × pp × tp`` from ``auto_mesh_config`` within
each (``pp`` the pipeline stages, for ``make_pipelined_lm_train_step``).
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
from kubeflow_tpu_torch.parallel.mesh import (
    MeshConfig,
    auto_mesh_config,
    create_mesh,
)
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


def rank_logger(penv: dist.ProcessEnv):
    """:func:`log_metrics` on rank 0, and a no-op on the other ranks of
    a job: rank 0 alone logs."""
    if penv.is_coordinator:
        return log_metrics
    return lambda step, **metrics: None


def launcher_init(*, pp: int = 1, tp: Optional[int] = None, device=None
                  ) -> Tuple[dist.ProcessEnv, Any, torch.device]:
    """``(env contract, mesh, device)``: the process group up from the
    env contract and the mesh over every rank, on this rank's device
    (CUDA unless ``"cpu"`` is asked for). On a multi-slice job
    (``MEGASCALE_NUM_SLICES > 1``) the mesh gets a ``dcn`` axis across
    slices, and pp and tp stay within a slice."""
    setup_logging()
    penv = dist.from_env()
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           penv.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.initialize(penv, backend="nccl" if dev.type == "cuda" else "gloo")
    world = penv.num_processes
    if penv.is_multislice:
        slice_cfg = auto_mesh_config(world // penv.num_slices, pp=pp, tp=tp)
        mesh = dist.multislice_mesh(penv, pp=slice_cfg.pp, tp=slice_cfg.tp,
                                    device_type=dev.type)
        config = MeshConfig(dcn=penv.num_slices, dp=slice_cfg.dp,
                            pp=slice_cfg.pp, tp=slice_cfg.tp)
    else:
        config = auto_mesh_config(world, pp=pp, tp=tp)
        mesh = create_mesh(config, device_type=dev.type)
    logging.info(
        "launcher up: rank %d/%d, device %s, mesh dcn=%d dp=%d pp=%d tp=%d",
        penv.process_id, penv.num_processes, dev, config.dcn, config.dp,
        config.pp, config.tp)
    return penv, mesh, dev


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
    0) beacons go to ``client`` through ``kube_beacon_sink``. The port's
    ``k8s/client.py:HttpKubeClient`` carries only the ConfigMap calls of
    the trial reporters, not the TpuJob status writes a beacon makes, so
    with no client given beacons are off and the log says so; the
    reference builds its ``HttpKubeClient`` there. ``n_chips`` is the world size: one rank a
    card."""
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
    kwargs.setdefault("n_chips", penv.num_processes)
    if "hbm_sampler" not in kwargs:
        kwargs["hbm_sampler"] = HbmSampler(
            namespace=penv.namespace, job=penv.job_name,
            worker=penv.process_id)
    return StepTelemetry(
        job=penv.job_name, namespace=penv.namespace, uid=job_uid,
        worker=penv.process_id, tokens_per_step=tokens_per_step,
        examples_per_step=examples_per_step, beacon_sink=sink, **kwargs)


def make_compile_ledger(*, install: bool = True):
    """A :class:`~kubeflow_tpu_torch.obs.xprof.CompileLedger` wired from
    the operator's env contract (job/namespace/uid identity, so compile
    spans join the job's trace tree) and, by default, subscribed to the
    kernel builds (``ops/_build.py``): from here on every ``nvcc`` this
    worker pays becomes a ``kftpu_compile_seconds`` observation and
    counts toward the job's compile seconds. Call ``.uninstall()`` at
    shutdown (or use it as a context manager)."""
    from kubeflow_tpu_torch.obs.steps import ENV_JOB_UID
    from kubeflow_tpu_torch.obs.xprof import CompileLedger

    penv = dist.from_env()
    ledger = CompileLedger(
        namespace=penv.namespace, job=penv.job_name,
        uid=os.environ.get(ENV_JOB_UID, ""), worker=penv.process_id)
    if install:
        ledger.install()
    return ledger


def report_tuning_metrics(step: int, metrics: Dict[str, Any],
                          *, final: bool = False, client=None,
                          telemetry=None) -> None:
    """Publish trial metrics when running inside a study (no-op outside).

    The study controller injects ``KFTPU_TRIAL_NAME`` and
    ``KFTPU_OBJECTIVE_METRIC``; this appends the objective's step series
    (what median early stopping reads) and, on ``final``, the metrics the
    controller harvests. With ``telemetry`` (a
    :class:`~kubeflow_tpu_torch.obs.steps.StepTelemetry`) the objective
    series comes from its per-step records and the final report carries
    its summary. Only process 0 of a gang reports (the workers share the
    trial's one ConfigMap). Failures only log: a metrics hiccup never
    kills a training step."""
    trial = os.environ.get("KFTPU_TRIAL_NAME")
    if not trial:
        return
    if dist.from_env().process_id != 0:
        return
    ns = os.environ.get("KFTPU_NAMESPACE", "default")
    objective = os.environ.get("KFTPU_OBJECTIVE_METRIC", "")
    try:
        from kubeflow_tpu_torch.tuning.study import (
            append_history_points,
            append_trial_history,
            report_trial_metrics,
        )

        if client is None:
            from kubeflow_tpu_torch.k8s.client import HttpKubeClient

            # one client for the trial's lifetime, not one per step
            client = getattr(report_tuning_metrics, "_client", None)
            if client is None:
                client = HttpKubeClient()
                report_tuning_metrics._client = client
        series = (telemetry.objective_series(objective)
                  if objective and telemetry is not None else [])
        if series:
            # the telemetry series is the objective history: nothing
            # appended from a non-empty series means it is persisted
            append_history_points(client, ns, trial, series)
        elif objective and objective in metrics:
            append_trial_history(client, ns, trial, step,
                                 float(metrics[objective]))
        if final:
            harvest = {k: float(v) for k, v in metrics.items()
                       if hasattr(v, "__float__")}
            if telemetry is not None:
                harvest.update({k: float(v)
                                for k, v in telemetry.summary().items()
                                if isinstance(v, (int, float))})
            report_trial_metrics(client, ns, trial, harvest)
    except Exception:  # noqa: BLE001
        logging.exception("trial metrics report failed (continuing)")
