"""Trial-metrics reporters: the workload side of a Study.

A trimmed copy of ``kubeflow_tpu/tuning/study.py`` (:152-272): a trial
publishes its metrics into the ConfigMap ``<trial>-metrics`` (labelled
with the trial), where the study controller harvests them. Final
metrics are JSON floats under their names; the objective's step history
is one JSON list of ``[step, value]`` pairs under ``__history__``, what
the median early-stopping rule reads. The ConfigMaps written here equal
the reference's for the same inputs.

``client`` is anything with the ConfigMap calls of
``k8s/client.py:HttpKubeClient`` (``get``, ``get_or_none``, ``create``,
``update``, ``apply``), raising an error whose ``code`` is the HTTP
status.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

from kubeflow_tpu_torch.k8s import objects as o
from kubeflow_tpu_torch.k8s.client import API_CONFLICT

TRIAL_LABEL = "kubeflow-tpu.org/trial-name"
HISTORY_KEY = "__history__"


def metrics_configmap_name(trial_name: str) -> str:
    return f"{trial_name}-metrics"


def report_trial_metrics(client: Any, ns: str, trial_name: str,
                         metrics: Mapping[str, float]) -> None:
    """Publish final metrics, merged over existing data so a step
    history reported earlier (:func:`append_trial_history`) survives."""
    name = metrics_configmap_name(trial_name)
    existing = client.get_or_none("v1", "ConfigMap", ns, name)
    data = dict((existing or {}).get("data") or {})
    data.update({k: json.dumps(float(v)) for k, v in metrics.items()})
    cm = o.config_map(name, ns, data)
    cm["metadata"]["labels"] = {TRIAL_LABEL: trial_name}
    client.apply(cm)


def read_trial_metrics(client: Any, ns: str,
                       trial_name: str) -> Optional[Dict[str, float]]:
    cm = client.get_or_none("v1", "ConfigMap", ns,
                            metrics_configmap_name(trial_name))
    if cm is None:
        return None
    return {k: float(json.loads(v))
            for k, v in (cm.get("data") or {}).items()
            if k != HISTORY_KEY}


def _metrics_configmap(client: Any, ns: str, trial_name: str) -> Dict:
    """The trial's metrics ConfigMap, created (labelled) if missing; a
    create that loses a race reads the winner's."""
    name = metrics_configmap_name(trial_name)
    cm = client.get_or_none("v1", "ConfigMap", ns, name)
    if cm is None:
        cm = o.config_map(name, ns, {})
        cm["metadata"]["labels"] = {TRIAL_LABEL: trial_name}
        try:
            client.create(cm)
        except Exception as e:  # noqa: BLE001 — the client's ApiError
            if getattr(e, "code", None) != API_CONFLICT:
                raise
            cm = client.get("v1", "ConfigMap", ns, name)
    return cm


def append_trial_history(client: Any, ns: str, trial_name: str,
                         step: int, value: float) -> None:
    """One intermediate point of the objective's step series."""
    cm = _metrics_configmap(client, ns, trial_name)
    data = dict(cm.get("data") or {})
    history = json.loads(data.get(HISTORY_KEY, "[]"))
    history.append([int(step), float(value)])
    data[HISTORY_KEY] = json.dumps(history)
    cm = dict(cm)
    cm["data"] = data
    client.update(cm)


def read_trial_history(client: Any, ns: str,
                       trial_name: str) -> List[Tuple[int, float]]:
    cm = client.get_or_none("v1", "ConfigMap", ns,
                            metrics_configmap_name(trial_name))
    if cm is None:
        return []
    raw = (cm.get("data") or {}).get(HISTORY_KEY, "[]")
    return [(int(s), float(v)) for s, v in json.loads(raw)]


def append_history_from_telemetry(client: Any, ns: str, trial_name: str,
                                  telemetry: Any, metric: str) -> int:
    """Publish the objective series from step telemetry (anything with
    ``objective_series(metric)``, e.g. ``obs/steps.py:StepTelemetry``).
    Returns the number of points appended."""
    return append_history_points(client, ns, trial_name,
                                 telemetry.objective_series(metric))


def append_history_points(client: Any, ns: str, trial_name: str,
                          series: List[Tuple[int, float]]) -> int:
    """Batch-append ``(step, value)`` points; idempotent per step (only
    points newer than the last persisted step are appended, in one
    read-modify-write). Returns the number appended."""
    if not series:
        return 0
    cm = _metrics_configmap(client, ns, trial_name)
    data = dict(cm.get("data") or {})
    history = json.loads(data.get(HISTORY_KEY, "[]"))
    last_step = max((int(s) for s, _ in history), default=-1)
    fresh = [[int(s), float(v)] for s, v in series if int(s) > last_step]
    if not fresh:
        return 0
    history.extend(fresh)
    data[HISTORY_KEY] = json.dumps(history)
    cm = dict(cm)
    cm["data"] = data
    client.update(cm)
    return len(fresh)
