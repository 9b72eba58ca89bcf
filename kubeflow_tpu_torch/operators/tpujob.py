"""The TpuJob operator's checkpointer interface and CR identity: a copy.

``PreemptionCheckpointer`` is a copy of
``kubeflow_tpu/operators/tpujob.py:407-423`` (``elastic/snapshot.py:
DirCheckpointer`` subclasses it), and ``API_VERSION``/``TPUJOB_KIND``
of ``kubeflow_tpu/manifests/components/tpujob_operator.py:20-23``
(``elastic/coordinator.py:cr_resize_target`` reads the CR by them).
The operator's reconciler is control plane: it stays in the JAX
package, and a port worker runs beside it unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

GROUP = "kubeflow-tpu.org"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
TPUJOB_KIND = "TpuJob"


class PreemptionCheckpointer:
    """How the operator persists a victim's step clock at preemption.

    Production binds this to the job's ``spec.checkpointDir`` through
    :class:`kubeflow_tpu_torch.train.checkpoint.CheckpointManager`
    (workers save on teardown, ``latest_step`` reads what landed); tests
    inject a fake and count ``save`` calls. Both methods return the
    persisted step, or ``None`` when nothing is known: the queue's
    victim-cost model treats ``None`` as maximal lost work.
    """

    def save(self, job: Dict[str, Any]) -> Optional[int]:
        """Ensure a checkpoint exists for this job; return its step."""
        raise NotImplementedError

    def latest_step(self, ns: str, name: str) -> Optional[int]:
        raise NotImplementedError
