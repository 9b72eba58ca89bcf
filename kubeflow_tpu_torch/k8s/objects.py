"""Kubernetes object builders: a trimmed copy.

A copy of ``metadata``, ``container`` and ``pod_spec`` from
``kubeflow_tpu/k8s/objects.py`` (:21, :93, :120), which
``serving/batch_predict.py:batch_predict_job`` builds its Job from.
Objects are canonical Kubernetes dicts, as there.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

Obj = Dict[str, Any]


def metadata(
    name: str,
    namespace: Optional[str] = None,
    labels: Optional[Mapping[str, str]] = None,
    annotations: Optional[Mapping[str, str]] = None,
) -> Obj:
    md: Obj = {"name": name}
    if namespace:
        md["namespace"] = namespace
    if labels:
        md["labels"] = dict(labels)
    if annotations:
        md["annotations"] = dict(annotations)
    return md


def container(
    name: str,
    image: str,
    *,
    command: Optional[Sequence[str]] = None,
    args: Optional[Sequence[str]] = None,
    env: Optional[Mapping[str, str]] = None,
    ports: Optional[Sequence[int]] = None,
    resources: Optional[Mapping[str, Any]] = None,
    volume_mounts: Optional[Sequence[Mapping[str, str]]] = None,
) -> Obj:
    c: Obj = {"name": name, "image": image}
    if command:
        c["command"] = list(command)
    if args:
        c["args"] = list(args)
    if env:
        c["env"] = [{"name": k, "value": str(v)} for k, v in env.items()]
    if ports:
        c["ports"] = [{"containerPort": p} for p in ports]
    if resources:
        c["resources"] = dict(resources)
    if volume_mounts:
        c["volumeMounts"] = [dict(m) for m in volume_mounts]
    return c


def pod_spec(
    containers: Sequence[Obj],
    *,
    service_account_name: Optional[str] = None,
    volumes: Optional[Sequence[Obj]] = None,
    node_selector: Optional[Mapping[str, str]] = None,
    restart_policy: Optional[str] = None,
    scheduler_name: Optional[str] = None,
    host_network: bool = False,
) -> Obj:
    spec: Obj = {"containers": [dict(c) for c in containers]}
    if service_account_name:
        spec["serviceAccountName"] = service_account_name
    if volumes:
        spec["volumes"] = [dict(v) for v in volumes]
    if node_selector:
        spec["nodeSelector"] = dict(node_selector)
    if restart_policy:
        spec["restartPolicy"] = restart_policy
    if scheduler_name:
        spec["schedulerName"] = scheduler_name
    if host_network:
        spec["hostNetwork"] = True
    return spec
