"""The operator's distributed env contract, parsed.

Copied from ``kubeflow_tpu/parallel/distributed.py`` (``ProcessEnv`` and
``from_env``; the port imports nothing of the JAX package). The TpuJob
operator injects:

- ``KFTPU_COORDINATOR_ADDRESS``  host:port of process 0
- ``KFTPU_NUM_PROCESSES``        total host processes in the job
- ``KFTPU_PROCESS_ID``           this process's rank
- ``KFTPU_JOB_NAME`` / ``KFTPU_NAMESPACE``  identity, for logging/metrics
- ``MEGASCALE_SLICE_ID`` / ``MEGASCALE_NUM_SLICES``  multi-slice topology

Bringing up more than one process (``torch.distributed``) is ROADMAP
Queue A 7; until then the launcher refuses such a job
(``examples/common.py:launcher_init``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

ENV_COORDINATOR = "KFTPU_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KFTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "KFTPU_PROCESS_ID"
ENV_JOB_NAME = "KFTPU_JOB_NAME"
ENV_NAMESPACE = "KFTPU_NAMESPACE"
ENV_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_NUM_SLICES = "MEGASCALE_NUM_SLICES"


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    """Parsed view of the operator-injected distributed environment."""

    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    job_name: str = ""
    namespace: str = "default"
    slice_id: int = 0
    num_slices: int = 1

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


def from_env(environ=None) -> ProcessEnv:
    env = os.environ if environ is None else environ
    return ProcessEnv(
        coordinator_address=env.get(ENV_COORDINATOR),
        num_processes=int(env.get(ENV_NUM_PROCESSES, "1")),
        process_id=int(env.get(ENV_PROCESS_ID, "0")),
        job_name=env.get(ENV_JOB_NAME, ""),
        namespace=env.get(ENV_NAMESPACE, "default"),
        slice_id=int(env.get(ENV_SLICE_ID, "0")),
        num_slices=int(env.get(ENV_NUM_SLICES, "1")),
    )
