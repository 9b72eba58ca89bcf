"""Versioned model store for the port: a jax-free reader and writer.

Same layout as ``kubeflow_tpu/serving/model_store.py``:
``<base>/<model>/<version>/{model.yaml,params.npz}`` with ``/``-joined
leaf paths, so an export written by the JAX package's ``export_model``
loads here unchanged, and the port's exports load there. Both metadata
records are honoured:

- ``quantized_leaves``: large leaves stored as symmetric per-channel
  int8 plus ``<key>::scale`` f32 scales, dequantized at load;
- ``cast_leaves``: leaves npz cannot hold (bf16) stored as f32 with
  their dtype recorded, restored at load.

This slice serves the ``transformer`` kind only.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import yaml

from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    torch_dtype,
)
from kubeflow_tpu_torch.utils.device import resolve_device

MODEL_FILE = "model.yaml"
PARAMS_FILE = "params.npz"
_QUANT_MIN_ELEMS = 4096
_QUANT_SCALE_SUFFIX = "::scale"


def transformer_export_config(config: TransformerConfig,
                              **overrides) -> Dict[str, Any]:
    """The serving-relevant config fields as an export dict (the
    reference's ``transformer_export_config``)."""
    out: Dict[str, Any] = {
        "vocab_size": config.vocab_size,
        "d_model": config.d_model,
        "n_layers": config.n_layers,
        "n_heads": config.n_heads,
        "n_kv_heads": config.n_kv_heads,
        "d_ff": config.d_ff,
        "max_seq_len": config.max_seq_len,
        "n_experts": config.n_experts,
        "experts_per_token": config.experts_per_token,
        "logits_softcap": config.logits_softcap,
        "rope_theta": config.rope_theta,
        "scan_layers": config.scan_layers,
        "dtype": str(config.dtype).replace("torch.", ""),
        "remat": False,
    }
    out.update(overrides)
    return out


def _quantize_leaf(arr: np.ndarray):
    """Symmetric per-output-channel int8 (last axis = channels)."""
    flat = arr.reshape(-1, arr.shape[-1]).astype(np.float32)
    scale = np.maximum(np.abs(flat).max(axis=0), 1e-12) / 127.0
    q = np.clip(np.rint(flat / scale), -127, 127).astype(np.int8)
    return q.reshape(arr.shape), scale.astype(np.float32)


def export_model(path: str, kind: str, params: Dict[str, Any], *,
                 config: Optional[Dict[str, Any]] = None, version: int = 1,
                 quantize: bool = False) -> str:
    """Write ``<path>/<version>/{model.yaml,params.npz}``; returns the
    version dir. ``params`` is a flat (``/``-joined) or nested dict of
    numpy f32 arrays in the JAX layout (``models/convert.py``). The yaml
    is written last and atomically: its presence publishes the version."""
    vdir = os.path.join(path, str(version))
    os.makedirs(vdir, exist_ok=True)
    meta: Dict[str, Any] = {"kind": kind, "config": config or {}}
    flat = {k: np.asarray(v) for k, v in convert.flatten(params).items()}
    if quantize:
        stored: Dict[str, np.ndarray] = {}
        quantized: Dict[str, str] = {}
        for key, arr in flat.items():
            if (arr.dtype.kind == "f" and arr.size >= _QUANT_MIN_ELEMS
                    and arr.ndim >= 2):
                stored[key], stored[key + _QUANT_SCALE_SUFFIX] = \
                    _quantize_leaf(arr)
                quantized[key] = arr.dtype.name
            else:
                stored[key] = arr
        meta["quantized_leaves"] = quantized
        flat = stored
    np.savez(os.path.join(vdir, PARAMS_FILE), **flat)
    fd, tmp = tempfile.mkstemp(dir=vdir, prefix=f".{MODEL_FILE}.")
    with os.fdopen(fd, "wb") as f:
        f.write(yaml.safe_dump(meta).encode())
    os.replace(tmp, os.path.join(vdir, MODEL_FILE))
    return vdir


def list_versions(base_path: str) -> List[int]:
    if not os.path.isdir(base_path):
        return []
    return sorted(
        int(d) for d in os.listdir(base_path)
        if d.isdigit() and os.path.isfile(os.path.join(base_path, d,
                                                       MODEL_FILE)))


def read_params(vdir: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    """The flat param dict of one version, dequantized and restored to
    its recorded dtypes (bf16 leaves come back as torch tensors: numpy
    has no bf16 without ml_dtypes)."""
    with np.load(os.path.join(vdir, PARAMS_FILE)) as npz:
        raw: Dict[str, Any] = {k: npz[k] for k in npz.files}
    quantized = meta.get("quantized_leaves") or {}
    if isinstance(quantized, list):  # early artifacts: no dtype record
        quantized = {k: "float32" for k in quantized}
    for k, dtype_name in quantized.items():
        scale = raw.pop(k + _QUANT_SCALE_SUFFIX)
        deq = (raw[k].astype(np.float32) * scale).astype(np.float32)
        raw[k] = torch.from_numpy(deq).to(torch_dtype(dtype_name))
    for k, dtype_name in (meta.get("cast_leaves") or {}).items():
        if k in raw:
            raw[k] = torch.from_numpy(np.asarray(raw[k], np.float32)).to(
                torch_dtype(dtype_name))
    return raw


@dataclasses.dataclass
class LoadedModel:
    kind: str
    version: int
    lm_config: TransformerConfig
    lm_params: Transformer   # the loaded module, on the serving device
    max_seq_len: int
    vocab_size: int


def load_version(base_path: str, version: int, *,
                 device=None) -> LoadedModel:
    """Load one transformer version onto ``device`` (default CUDA)."""
    dev = resolve_device(device)
    vdir = os.path.join(base_path, str(version))
    with open(os.path.join(vdir, MODEL_FILE)) as f:
        meta = yaml.safe_load(f)
    kind = meta["kind"]
    if kind != "transformer":
        raise NotImplementedError(
            f"model kind {kind!r} is not ported to kubeflow_tpu_torch yet "
            "(ROADMAP.md Queue A)")
    config = TransformerConfig(**(meta.get("config") or {}))
    model = convert.to_module(config, read_params(vdir, meta), device=dev)
    return LoadedModel(kind=kind, version=version, lm_config=config,
                       lm_params=model, max_seq_len=config.max_seq_len,
                       vocab_size=config.vocab_size)
