"""Carry JAX ``Transformer`` weights into the port's modules.

A JAX param tree arrives as numpy: a nested dict (``jax.tree_util`` leaves
through ``np.asarray``) or the flat ``/``-joined keys of a model-store
``params.npz``. Both layer layouts are handled:

- ``scan_layers=True``: one ``blocks/...`` subtree whose leaves carry a
  leading layer axis (``blocks/attn/q_proj`` is ``(L, D, H, Dh)``);
- unrolled: ``block_{i}/...`` per layer.

No transposes anywhere: the port keeps the reference's einsum layouts
(``(D, H, Dh)``, ``(H, Dh, D)``, ``(D, F)``, ``(F, D)``, ``(V, D)``), so
port parameter ``blocks.{i}.<path>`` is JAX leaf ``blocks/<path>[i]`` or
``block_{i}/<path>`` with dots for slashes, and top-level names map
one for one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.utils.device import resolve_device


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict → flat ``/``-joined keys (leaves untouched)."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten(val, path))
        else:
            flat[path] = val
    return flat


def _as_tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes bf16 → exact f32
    return torch.from_numpy(np.array(arr, copy=True))


def _source_key(name: str, flat: Mapping[str, Any]):
    """(JAX key, layer index or None) for one port parameter name."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), None
    i, rest = int(parts[1]), "/".join(parts[2:])
    unrolled = f"block_{i}/{rest}"
    if unrolled in flat:
        return unrolled, None
    return f"blocks/{rest}", i


def load_params(model: Transformer, params: Mapping[str, Any]) -> Transformer:
    """Copy a JAX param tree (nested or flat, scanned or unrolled) into
    ``model`` in place; every port parameter must be found, with its
    exact shape. Returns ``model``."""
    flat = flatten(params)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            key, layer = _source_key(name, flat)
            if key not in flat:
                raise KeyError(f"param {key!r} (for {name}) not in the "
                               f"JAX tree")
            src = _as_tensor(flat[key])
            if layer is not None:
                src = src[layer]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} != "
                                 f"port {name} {tuple(p.shape)}")
            p.copy_(src.to(device=p.device, dtype=p.dtype))
            used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"JAX leaves with no port parameter: {extra[:8]}")
    return model


def to_module(config: TransformerConfig, params: Mapping[str, Any], *,
              device) -> Transformer:
    """A loaded, frozen port ``Transformer`` on ``device``."""
    model = Transformer(config)
    load_params(model, params)
    model = model.to(device).eval()
    model.requires_grad_(False)
    return model


def to_trainable(config: TransformerConfig, params: Mapping[str, Any], *,
                 device=None, return_hidden: bool = False) -> Transformer:
    """A loaded port ``Transformer`` on ``device`` (CUDA unless ``"cpu"``
    is asked for), left trainable: every parameter requires a gradient
    and the module is in train mode."""
    model = Transformer(config, return_hidden=return_hidden)
    load_params(model, params)
    return model.to(resolve_device(device)).train()


def random_params(config: TransformerConfig, seed: int, *,
                  scan_layers: bool = True) -> Dict[str, np.ndarray]:
    """Random f32 weights in the JAX package's flat layout, from a numpy
    seed: normal(0, d_model**-0.5) for every matrix (the reference's
    initializer scale), ones for the norm scales."""
    c = config
    rng = np.random.default_rng(seed)
    D, F, H, KH, Dh = c.d_model, c.d_ff, c.n_heads, c.n_kv_heads, c.head_dim
    std = D ** -0.5

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    layer_shapes = {
        "attn/q_proj": (D, H, Dh), "attn/k_proj": (D, KH, Dh),
        "attn/v_proj": (D, KH, Dh), "attn/o_proj": (H, Dh, D),
        "mlp/gate_proj": (D, F), "mlp/up_proj": (D, F),
        "mlp/down_proj": (F, D),
    }
    flat: Dict[str, np.ndarray] = {"token_embed": normal(c.vocab_size, D),
                                   "final_norm/scale": np.ones(D, np.float32)}
    L = c.n_layers
    for key, shape in layer_shapes.items():
        if scan_layers:
            flat[f"blocks/{key}"] = normal(L, *shape)
        else:
            for i in range(L):
                flat[f"block_{i}/{key}"] = normal(*shape)
    for norm in ("attn_norm/scale", "mlp_norm/scale"):
        if scan_layers:
            flat[f"blocks/{norm}"] = np.ones((L, D), np.float32)
        else:
            for i in range(L):
                flat[f"block_{i}/{norm}"] = np.ones(D, np.float32)
    return flat
