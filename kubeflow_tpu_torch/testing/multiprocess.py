"""A gang of ``torch.distributed`` ranks on one machine.

PyTorch port of ``kubeflow_tpu/testing/multiprocess.py``: N
subprocesses wired with the SAME env contract the TpuJob operator
injects into worker pods (:mod:`kubeflow_tpu_torch.parallel.
distributed`: coordinator address, process count and id), so
cross-process collectives run end to end on localhost. Process 0 hosts
the rendezvous store, as worker 0 does behind the headless Service.

Each run takes a free port, so gangs may run side by side, and each
process has ``timeout_s``: a rendezvous that never completes ends as
one failed result (return code -9), not a hung caller. The ranks are
fresh interpreters (never forks of the caller), with the repository on
``PYTHONPATH`` and one CPU thread each unless the caller says otherwise.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from kubeflow_tpu_torch.parallel import distributed as dist

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class ProcResult:
    process_id: int
    returncode: int
    stdout: str
    stderr: str


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multiprocess(
    workload: Sequence[str],
    num_processes: int,
    *,
    env: Optional[Dict[str, str]] = None,
    env_per_process: Optional[Sequence[Dict[str, str]]] = None,
    timeout_s: float = 180.0,
    job_name: str = "mp-test",
) -> List[ProcResult]:
    """Run ``workload`` (argv after the interpreter) in N coordinated
    processes; returns per-process results (the caller asserts).
    ``env_per_process[i]`` adds rank-specific vars (e.g. the operator's
    per-slice ``MEGASCALE_SLICE_ID``). Every process still running
    ``timeout_s`` after the start is killed."""
    if env_per_process is not None and len(env_per_process) != num_processes:
        raise ValueError(
            f"env_per_process has {len(env_per_process)} entries for "
            f"{num_processes} processes")
    port = _free_port()
    procs = []
    for pid in range(num_processes):
        penv = dict(os.environ)
        penv["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, penv.get("PYTHONPATH")) if p)
        penv.setdefault("OMP_NUM_THREADS", "1")
        penv.update(env or {})
        if env_per_process is not None:
            penv.update(env_per_process[pid])
        penv.update({
            dist.ENV_COORDINATOR: f"127.0.0.1:{port}",
            dist.ENV_NUM_PROCESSES: str(num_processes),
            dist.ENV_PROCESS_ID: str(pid),
            dist.ENV_JOB_NAME: job_name,
        })
        procs.append(subprocess.Popen(
            [sys.executable, *workload],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out: List[ProcResult] = []
    deadline = time.monotonic() + timeout_s
    try:
        for pid, proc in enumerate(procs):
            try:
                stdout, stderr = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
                out.append(ProcResult(pid, -9, stdout, stderr))
                continue
            out.append(ProcResult(pid, proc.returncode, stdout, stderr))
    finally:
        for proc in procs:              # an error above leaves none behind
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out
