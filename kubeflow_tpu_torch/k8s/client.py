"""A stdlib HTTP client of the Kubernetes API: a trimmed copy.

A copy of ``kubeflow_tpu/k8s/client.py``'s ``HttpKubeClient`` (:282)
with the calls ``tuning/study.py``'s trial-metrics reporters make on a
ConfigMap: ``create``, ``get``, ``update``, and the shared conveniences
``get_or_none`` and ``apply``. Service-account token auth and the
in-cluster defaults are the reference's; an HTTP error raises
:class:`ApiError` with its status code.
"""

from __future__ import annotations

import copy
import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Any, Optional, Tuple

from kubeflow_tpu_torch.k8s.objects import Obj

API_NOT_FOUND = 404
API_CONFLICT = 409

SA_TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
SA_CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

_PLURALS = {"ConfigMap": "configmaps"}


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


def _meta(obj: Obj) -> Tuple[str, str]:
    md = obj.get("metadata", {})
    return md.get("namespace", ""), md["name"]


class HttpKubeClient:
    """Talks to a real API server with stdlib urllib; in-cluster defaults."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        ca_path: Optional[str] = None,
        verify: bool = True,
    ) -> None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST",
                              "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = (base_url or f"https://{host}:{port}").rstrip("/")
        if token is None and os.path.exists(SA_TOKEN_PATH):
            with open(SA_TOKEN_PATH) as f:
                token = f.read().strip()
        self.token = token
        ca = ca_path or (SA_CA_PATH if os.path.exists(SA_CA_PATH) else None)
        if not verify:
            self._ctx = ssl._create_unverified_context()  # noqa: S323
        else:
            self._ctx = ssl.create_default_context(cafile=ca)

    def _path(self, api_version: str, kind: str, namespace: str,
              name: Optional[str] = None) -> str:
        plural = _PLURALS.get(kind, kind.lower() + "s")
        prefix = "/api/v1" if api_version == "v1" else f"/apis/{api_version}"
        p = (f"{prefix}/namespaces/{namespace}/{plural}" if namespace
             else f"{prefix}/{plural}")
        return p + (f"/{name}" if name else "")

    def _request(self, method: str, path: str,
                 body: Optional[Obj] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base_url + path, data=data,
                                     method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, context=self._ctx,
                                        timeout=60) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.read().decode(errors="replace")) from e

    def create(self, obj: Obj) -> Obj:
        ns, _ = _meta(obj)
        return self._request(
            "POST", self._path(obj["apiVersion"], obj["kind"], ns), obj)

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> Obj:
        return self._request("GET",
                             self._path(api_version, kind, namespace, name))

    def update(self, obj: Obj) -> Obj:
        ns, name = _meta(obj)
        return self._request(
            "PUT", self._path(obj["apiVersion"], obj["kind"], ns, name), obj)

    def get_or_none(self, api_version: str, kind: str, namespace: str,
                    name: str) -> Optional[Obj]:
        try:
            return self.get(api_version, kind, namespace, name)
        except ApiError as e:
            if e.code == API_NOT_FOUND:
                return None
            raise

    def apply(self, obj: Obj) -> Obj:
        """Create-or-update by name."""
        ns, name = _meta(obj)
        existing = self.get_or_none(obj["apiVersion"], obj["kind"], ns, name)
        if existing is None:
            return self.create(obj)
        merged = copy.deepcopy(obj)
        md = merged.setdefault("metadata", {})
        md["resourceVersion"] = existing["metadata"].get("resourceVersion")
        md["uid"] = existing["metadata"].get("uid")
        if "status" in existing and "status" not in merged:
            merged["status"] = existing["status"]
        return self.update(merged)
