"""Device-memory watermarks: the ``kftpu_hbm_*`` gauges and their sampler.

PyTorch port of the memory half of ``kubeflow_tpu/obs/xprof.py``
(``_device_memory_stats`` :576, ``HbmSampler`` :591, ``set_hbm_bytes``,
``set_hbm_utilization``). The source is the CUDA caching allocator:

- ``bytes_in_use`` ← ``torch.cuda.memory_stats(d)["allocated_bytes.all.current"]``;
- ``peak_bytes_in_use`` ← ``["allocated_bytes.all.peak"]``;
- ``bytes_limit`` ← ``torch.cuda.mem_get_info(d)[1]`` (the card's total).

On the CPU (no CUDA) the stats are None and the sampler stays silent,
as the reference's does on CPU backends. The compile ledger
(``CompileLedger``) waits for ROADMAP Queue A 3: eager PyTorch has no
compile events to count.

Series (names, help and labels the reference's):

- ``kftpu_hbm_bytes{kind=in_use|peak|limit[,identity...]}``;
- ``kftpu_hbm_utilization{[identity...]}``, ``in_use/limit``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Mapping, Optional

from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY

log = logging.getLogger(__name__)

HBM_KINDS = ("in_use", "peak", "limit")

_hbm_g = DEFAULT_REGISTRY.gauge(
    "kftpu_hbm_bytes",
    "device memory watermark (kind=in_use|peak|limit), sampled from "
    "device.memory_stats()")
_hbm_util_g = DEFAULT_REGISTRY.gauge(
    "kftpu_hbm_utilization",
    "device memory in_use/limit fraction (absent when the backend "
    "reports no limit)")


def _identity(namespace: str, job: str, worker: Optional[int],
              model: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    if job:
        labels.update({"namespace": namespace, "job": job})
    if worker is not None:
        labels["worker"] = str(worker)
    if model:
        labels["model"] = model
    return labels


def set_hbm_bytes(kind: str, value: float, *, namespace: str = "",
                  job: str = "", worker: Optional[int] = None,
                  model: str = "") -> None:
    _hbm_g.set(float(value), kind=kind,
               **_identity(namespace, job, worker, model))


def set_hbm_utilization(value: float, *, namespace: str = "",
                        job: str = "", worker: Optional[int] = None,
                        model: str = "") -> None:
    _hbm_util_g.set(float(value),
                    **_identity(namespace, job, worker, model))


def _device_memory_stats(index: int = 0) -> Optional[Mapping[str, Any]]:
    """The reference's ``memory_stats()`` keys for CUDA device ``index``
    (clamped to the visible cards); None without CUDA or on any probe
    failure — the sampler's silent-degrade contract."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        dev = min(index, torch.cuda.device_count() - 1)
        stats = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                               0),
                "bytes_limit": torch.cuda.mem_get_info(dev)[1]}
    except Exception:  # noqa: BLE001
        return None


class HbmSampler:
    """Samples device-memory watermarks into the ``kftpu_hbm_*`` gauges
    and a beacon-ready snapshot.

    ``source`` is the injectable stats callable (tests inject a fake;
    the default reads the CUDA allocator of ``device_index``). A source
    returning None — every CPU run — degrades silently: no gauges, no
    beacon fields, no errors. ``peak`` is the max seen across samples."""

    def __init__(self, *, namespace: str = "", job: str = "",
                 worker: Optional[int] = None, model: str = "",
                 source: Optional[Callable[[], Optional[
                     Mapping[str, Any]]]] = None,
                 device_index: int = 0) -> None:
        self.namespace = namespace
        self.job = job
        self.worker = worker
        self.model = model
        self.source = source
        self.device_index = device_index
        self.peak_seen = 0.0
        self.last: Dict[str, float] = {}

    def sample(self) -> Optional[Dict[str, float]]:
        """One watermark sample → gauges; returns the kind → bytes
        dict, or None on silent degrade. Never raises."""
        try:
            stats = (self.source() if self.source is not None
                     else _device_memory_stats(self.device_index))
        except Exception:  # noqa: BLE001 — sampling never fails a step
            log.debug("hbm sample failed (continuing)", exc_info=True)
            return None
        if not stats:
            return None
        try:
            in_use = float(stats.get("bytes_in_use", 0) or 0)
            limit = float(stats.get("bytes_limit", 0) or 0)
            peak = float(stats.get("peak_bytes_in_use", 0) or 0)
            self.peak_seen = max(self.peak_seen, peak, in_use)
            out = {"in_use": in_use, "peak": self.peak_seen,
                   "limit": limit}
            ident = {"namespace": self.namespace, "job": self.job,
                     "worker": self.worker, "model": self.model}
            for kind in HBM_KINDS:
                set_hbm_bytes(kind, out[kind], **ident)
            if limit > 0:
                set_hbm_utilization(in_use / limit, **ident)
            self.last = out
            return out
        except Exception:  # noqa: BLE001
            log.debug("hbm sample failed (continuing)", exc_info=True)
            return None

    def beacon_fields(self) -> Dict[str, Any]:
        """The ``hbm`` block a step-telemetry beacon carries; empty
        before the first successful sample (always empty on the CPU)."""
        if not self.last:
            return {}
        return {"inUseBytes": int(self.last["in_use"]),
                "peakBytes": int(self.last["peak"]),
                "limitBytes": int(self.last["limit"])}
