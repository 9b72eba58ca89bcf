"""Multi-process bootstrap from the operator's distributed env contract.

PyTorch port of ``kubeflow_tpu/parallel/distributed.py``: ``ProcessEnv``
and ``from_env`` (copied; the port imports nothing of the JAX package),
:func:`initialize` and :func:`multislice_mesh`. The TpuJob operator
injects:

- ``KFTPU_COORDINATOR_ADDRESS``  host:port of process 0
- ``KFTPU_NUM_PROCESSES``        total host processes in the job
- ``KFTPU_PROCESS_ID``           this process's rank
- ``KFTPU_JOB_NAME`` / ``KFTPU_NAMESPACE``  identity, for logging/metrics
- ``MEGASCALE_SLICE_ID`` / ``MEGASCALE_NUM_SLICES``  multi-slice topology

Where the reference brings up ``jax.distributed`` with process 0 as the
coordinator, :func:`initialize` starts ``torch.distributed``: process 0
hosts the rendezvous store at the coordinator address, and every rank
joins the default process group (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from datetime import timedelta
from typing import Optional

log = logging.getLogger(__name__)

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


def initialize(penv: Optional[ProcessEnv] = None, *, backend: str = "nccl",
               timeout_s: float = 300.0,
               retry_interval_s: float = 5.0) -> ProcessEnv:
    """Join the default process group from the env contract, with
    retries.

    Process 0 hosts the ``TCPStore`` at ``KFTPU_COORDINATOR_ADDRESS``;
    the others retry with backoff until it answers, as the reference
    retries ``jax.distributed.initialize`` until the coordinator's
    Service resolves. A single-process job returns at once without
    touching ``torch.distributed``, and so does a process whose group is
    already up (a second entry point in the same process)."""
    import torch.distributed as tdist

    penv = penv or from_env()
    if not penv.is_distributed:
        log.info("single-process job; skipping torch.distributed")
        return penv
    if tdist.is_initialized():
        return penv
    if not penv.coordinator_address:
        raise RuntimeError(
            f"{ENV_NUM_PROCESSES}>1 but {ENV_COORDINATOR} is not set"
        )
    host, _, port = penv.coordinator_address.rpartition(":")
    deadline = time.monotonic() + timeout_s
    attempt = 0
    while True:
        attempt += 1
        remaining = max(deadline - time.monotonic(), retry_interval_s)
        try:
            store = tdist.TCPStore(
                host, int(port), penv.num_processes,
                is_master=penv.is_coordinator,
                timeout=timedelta(seconds=remaining))
            tdist.init_process_group(
                backend, store=store, rank=penv.process_id,
                world_size=penv.num_processes,
                timeout=timedelta(seconds=timeout_s))
            log.info("torch.distributed up: rank %d/%d via %s (%s)",
                     penv.process_id, penv.num_processes,
                     penv.coordinator_address, backend)
            return penv
        except (RuntimeError, OSError) as e:  # DistNetworkError included
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"could not reach coordinator {penv.coordinator_address} "
                    f"after {attempt} attempts") from e
            log.warning("coordinator not ready (attempt %d): %s", attempt, e)
            time.sleep(retry_interval_s)


def multislice_mesh(penv: Optional[ProcessEnv] = None, *, pp: int = 1,
                    tp: int = 1, device_type: str = "cuda"):
    """The cross-slice training mesh from the env contract: ``dcn =
    MEGASCALE_NUM_SLICES`` (outer data parallelism: only the gradient
    average crosses slices), each slice's ranks factored into ``dp × pp
    × tp``. Ranks are slice-major, as the operator assigns them."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    penv = penv or from_env()
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    n_slices = penv.num_slices
    if world % n_slices:
        raise ValueError(
            f"{world} devices do not divide into {n_slices} slices")
    per_slice = world // n_slices
    if per_slice % (pp * tp):
        raise ValueError(
            f"pp*tp={pp * tp} does not divide slice size {per_slice}")
    config = MeshConfig(
        dcn=n_slices, dp=per_slice // (pp * tp), pp=pp, tp=tp)
    return create_mesh(config, device_type=device_type)
