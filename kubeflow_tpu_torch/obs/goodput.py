"""The checkpoint-save histogram of the goodput ledger: a trimmed copy.

A copy of ``kubeflow_tpu/obs/goodput.py``'s save-time series
(``kftpu_checkpoint_save_seconds``, :116-120) with
:func:`observe_checkpoint_save` and :func:`checkpoint_save_seconds`
(:123-140), which ``elastic/snapshot.py`` reports into. The series'
name, help text, buckets and labels are the reference's, registered in
the port's ``utils/metrics.py:DEFAULT_REGISTRY``. The ledger itself is
control plane and stays in the JAX package (the port imports nothing
of it).
"""

from __future__ import annotations

from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY

CKPT_SAVE_BUCKETS = (0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0)
_ckpt_save_h = DEFAULT_REGISTRY.histogram(
    "kftpu_checkpoint_save_seconds",
    "checkpoint save wall time (source=worker: the snapshot itself; "
    "source=operator: the control-plane ensure/read)",
    buckets=CKPT_SAVE_BUCKETS)


def observe_checkpoint_save(seconds: float, *, namespace: str = "",
                            job: str = "",
                            source: str = "worker") -> None:
    """Record one save's wall time. Job identity labels the series the
    ledger carves ``checkpoint_save`` from; an unlabeled observation
    (no job context) still lands in the fleet histogram."""
    labels = {"source": source}
    if job:
        labels.update({"namespace": namespace, "job": job})
    _ckpt_save_h.observe(max(float(seconds), 0.0), **labels)


def checkpoint_save_seconds(namespace: str, job: str,
                            source: str = "worker") -> float:
    """Cumulative save seconds for one job, from the in-process
    registry."""
    return _ckpt_save_h.sum(namespace=namespace, job=job, source=source)
