"""Carry JAX ``Transformer``, ``Bert``, ``ViT`` and ``ResNet`` weights into
the port.

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
one for one. A JAX ``Bert`` is the same tree plus ``type_embed`` and
``mlm_transform`` (:func:`bert_to_module`, :func:`bert_to_trainable`);
:func:`bert_params` goes back, in either layer layout. A JAX ``ViT`` is
the same blocks with ``patch_embed`` (its HWIO kernel kept as flax stores
it), ``final_norm`` and the ``head`` Dense (:func:`vit_to_module`,
:func:`vit_to_trainable`); :func:`bert_params` goes back for it too.

A JAX ``ResNet`` arrives as its variables, ``{"params": ...,
"batch_stats": ...}`` (nested or flat), in the fused (``bn2conv3``) or
unfused layout. Port parameter ``a.b.kernel`` is ``params/a/b/kernel``
and BN buffer ``a.b.mean`` is ``batch_stats/a/b/mean``; conv kernels are
moved from flax's ``(kh, kw, I, O)`` to torch's ``(O, I, kh, kw)``, the
fused layer's ``(1, 1, C, F)`` kernel becomes its ``(C, F)`` matrix, and
the Dense kernel stays ``(in, out)``. :func:`resnet_variables` goes back.

A model-store servable (``serving/model_store.py:build_model``, built
without weights) is filled by :func:`load_servable`: the ResNet loader
for a ``resnet`` export, :func:`load_params` for ``mnist`` (flax's
names and layouts, kept by ``models/mnist.py``), ``bert`` and
``transformer``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.models.bert import Bert, BertConfig
from kubeflow_tpu_torch.models.resnet import ResNet, ResNetConfig
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from kubeflow_tpu_torch.models.vit import ViT, ViTConfig
from kubeflow_tpu_torch.parallel import mesh as pmesh
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


def _jax_key(name: str, scan_layers: bool):
    """(JAX key, layer index or None) of port parameter ``name`` in the
    scanned (stacked ``blocks/...``) or unrolled layout."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), None
    i, rest = int(parts[1]), "/".join(parts[2:])
    if scan_layers:
        return f"blocks/{rest}", i
    return f"block_{i}/{rest}", None


def _source_key(name: str, flat: Mapping[str, Any]):
    """(JAX key, layer index or None) for one port parameter name, in
    the layout ``flat`` holds."""
    unrolled = _jax_key(name, scan_layers=False)
    return unrolled if unrolled[0] in flat else _jax_key(name, True)


def _other_stages(flat: Mapping[str, Any], model) -> set:
    """The unrolled ``block_{i}/...`` keys of layers a stage-built model
    (one pipeline stage) does not hold: another stage's rank loads them."""
    held = {name.split(".")[1] for name, _ in model.named_parameters()
            if name.startswith("blocks.")}
    return {key for key in flat if key.startswith("block_")
            and key.split("/")[0][len("block_"):] not in held}


def _stage_built(model) -> bool:
    split = getattr(model, "split", None)
    return split is not None and getattr(split, "pp", 1) > 1


def load_params(model: torch.nn.Module,
                params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX param tree (nested or flat, scanned or unrolled) into a
    port ``Transformer`` or ``Bert`` in place; every port parameter must
    be found, with its exact shape. A model built over a mesh takes this
    rank's block of each full leaf: its stage's layers under ``pp``, its
    experts under ``dp``, its columns under ``tp``. Returns ``model``."""
    specs = getattr(model, "param_specs", {})
    flat = flatten(params)
    used = _other_stages(flat, model) if _stage_built(model) else set()
    leaves: Dict[str, torch.Tensor] = {}  # a stacked leaf, converted once
    with torch.no_grad():
        for name, p in model.named_parameters():
            key, layer = _source_key(name, flat)
            if key not in flat:
                raise KeyError(f"param {key!r} (for {name}) not in the "
                               f"JAX tree")
            if key not in leaves:
                leaves[key] = _as_tensor(flat[key])
            src = leaves[key]
            if layer is not None:
                src = src[layer]
            if pmesh.is_sharded(specs.get(name)):
                src = pmesh.local_block(src, pmesh.tensor_spec(specs[name]),
                                        model.mesh)
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
              device, mesh=None) -> Transformer:
    """A loaded, frozen port ``Transformer`` on ``device``; with
    ``mesh``, built over it and holding this rank's blocks of the full
    ``params`` (the reference's ``shard_lm_params``: the whole model
    never lands on one card). A served model is never pipelined: over
    ``pp`` > 1 it keeps every block, replicated over the stages, as the
    reference's ``stage`` rule reaches only pipelined train states."""
    with torch.device(resolve_device(device)):
        model = Transformer(config, mesh=mesh)
    load_params(model, params).eval()
    model.requires_grad_(False)
    return model


def to_trainable(config: TransformerConfig, params: Mapping[str, Any], *,
                 device=None, return_hidden: bool = False,
                 mesh=None, pipelined: bool = False) -> Transformer:
    """A loaded port ``Transformer`` on ``device`` (CUDA unless ``"cpu"``
    is asked for), left trainable: every parameter requires a gradient
    and the module is in train mode. With ``mesh``, this rank's blocks
    of the full ``params`` (``pipelined`` as ``Transformer``'s)."""
    with torch.device(resolve_device(device)):
        model = Transformer(config, return_hidden=return_hidden, mesh=mesh,
                            pipelined=pipelined)
    return load_params(model, params).train()


def gather_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` whole, by name: a model built over a
    mesh gathers each split one from the ranks that share it, and a
    stage-built one every stage's layers (a collective: every rank calls
    it). The names are the whole model's, in its order."""
    specs = getattr(model, "param_specs", {})
    return gather_named({n: p.detach() for n, p in model.named_parameters()},
                        specs, model)


def gather_named(tensors: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """``tensors`` (a subset of ``model``'s parameters, by name, in its
    order) gathered whole under ``specs``: each split dim from the ranks
    that share it, then, for a stage-built model, each stage leaf from
    every stage (an all-gather over ``pp``), under the names that stage
    gives it, in the whole model's order. A collective."""
    mesh = getattr(model, "mesh", None)
    out: Dict[str, torch.Tensor] = {}
    for name, t in tensors.items():
        spec = specs.get(name)
        if pmesh.is_sharded(spec):
            t = pmesh.gather_block(t, pmesh.tensor_spec(spec), mesh)
        out[name] = t
    if not _stage_built(model):
        return out
    from kubeflow_tpu_torch.models.transformer import stage_peer

    pp = model.split.pp
    per = model.config.n_layers // pp
    staged = {name: pmesh.gather_block(t[None], pmesh.PartitionSpec("pp"),
                                       mesh)
              for name, t in out.items() if pmesh.is_stage_spec(
                  specs.get(name))}
    names = list(out)           # the stage's blocks lie together
    blocks = [n for n in names if n in staged]
    first = names.index(blocks[0])
    ordered = {n: out[n] for n in names[:first]}
    for stage in range(pp):
        for n in blocks:
            ordered[stage_peer(n, stage, per)] = staged[n][stage]
    ordered.update((n, out[n]) for n in names[first + len(blocks):])
    return ordered


def unsharded(model: Transformer) -> Transformer:
    """A plain (mesh-less) copy of a ``Transformer`` built over a mesh,
    from its gathered parameters, on the same device: what decoding and
    the export read (a collective, as :func:`gather_params`)."""
    full = gather_params(model)
    with torch.device(next(model.parameters()).device):
        plain = Transformer(model.config, return_hidden=model.return_hidden)
    with torch.no_grad():
        for name, p in plain.named_parameters():
            p.copy_(full[name])
    return plain


def _random_flat(model: torch.nn.Module, d_model: int, seed: int, *,
                 scan_layers: bool) -> Dict[str, np.ndarray]:
    """Random f32 weights for ``model`` (built on the meta device) in the
    JAX package's flat layout, scanned or unrolled, from a numpy seed:
    normal(0, d_model**-0.5) for every matrix (the reference's
    initializer scale), ones for the norm scales. A stacked leaf is drawn
    whole, at its first layer."""
    rng = np.random.default_rng(seed)
    std = np.float32(d_model ** -0.5)
    L = len(model.blocks)
    flat: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        key, layer = _jax_key(name, scan_layers)
        if key in flat:
            continue
        shape = (L,) + tuple(p.shape) if layer is not None else tuple(p.shape)
        if name.endswith(".scale"):
            flat[key] = np.ones(shape, np.float32)
        else:
            flat[key] = rng.standard_normal(shape, dtype=np.float32) * std
    return flat


def random_params(config: TransformerConfig, seed: int, *,
                  scan_layers: bool = True) -> Dict[str, np.ndarray]:
    """Random f32 ``Transformer`` weights (:func:`_random_flat`)."""
    with torch.device("meta"):
        model = Transformer(config)
    return _random_flat(model, config.d_model, seed,
                        scan_layers=scan_layers)


# -- BERT --------------------------------------------------------------------


def bert_to_module(config: BertConfig, params: Mapping[str, Any], *,
                   device) -> Bert:
    """A loaded, frozen port ``Bert`` in eval mode on ``device``."""
    model = load_params(Bert(config), params)
    model = model.to(resolve_device(device)).eval()
    model.requires_grad_(False)
    return model


def bert_to_trainable(config: BertConfig, params: Mapping[str, Any], *,
                      device=None, mesh=None) -> Bert:
    """A loaded port ``Bert`` on ``device`` (CUDA unless ``"cpu"`` is
    asked for), in train mode with every parameter trainable. With
    ``mesh``, built over it: this rank's blocks of the full ``params``
    (:func:`bert_params` gathers them back)."""
    return load_params(Bert(config, mesh=mesh), params).to(
        resolve_device(device)).train()


def random_bert_params(config: BertConfig,
                       seed: int) -> Dict[str, np.ndarray]:
    """Random f32 ``Bert`` weights (:func:`_random_flat`) in the layout
    ``config.scan_layers`` names."""
    with torch.device("meta"):
        model = Bert(config)
    return _random_flat(model, config.d_model, seed,
                        scan_layers=config.scan_layers)


def bert_params(model: torch.nn.Module, *,
               scan_layers: bool = True) -> Dict[str, Any]:
    """A port ``Bert``, ``Transformer`` or ``ViT``'s parameters as a nested
    JAX-layout param tree of f32 numpy arrays (the inverse of
    :func:`load_params`), in the scanned or the unrolled layout. A model
    built over a mesh is gathered whole first (:func:`gather_params`, a
    collective)."""
    flat: Dict[str, Any] = {}
    for name, p in gather_params(model).items():
        key, layer = _jax_key(name, scan_layers)
        arr = p.detach().float().cpu().numpy()
        if layer is None:
            flat[key] = np.array(arr)
        else:
            flat.setdefault(key, []).append(arr)
    return unflatten({k: np.stack(v) if isinstance(v, list) else v
                      for k, v in flat.items()})


# -- ViT ---------------------------------------------------------------------


def vit_to_module(config: ViTConfig, params: Mapping[str, Any], *,
                  device) -> ViT:
    """A loaded, frozen port ``ViT`` in eval mode on ``device``."""
    model = load_params(ViT(config), params)
    model = model.to(resolve_device(device)).eval()
    model.requires_grad_(False)
    return model


def vit_to_trainable(config: ViTConfig, params: Mapping[str, Any], *,
                     device=None, mesh=None) -> ViT:
    """A loaded port ``ViT`` on ``device`` (CUDA unless ``"cpu"`` is
    asked for), in train mode with every parameter trainable. With
    ``mesh``, built over it: this rank's blocks of the full ``params``."""
    return load_params(ViT(config, mesh=mesh), params).to(
        resolve_device(device)).train()


def random_vit_params(config: ViTConfig, seed: int) -> Dict[str, np.ndarray]:
    """Random f32 ``ViT`` weights (:func:`_random_flat`: the patch
    kernel, the head and the biases too) in the layout
    ``config.scan_layers`` names."""
    with torch.device("meta"):
        model = ViT(config)
    return _random_flat(model, config.d_model, seed,
                        scan_layers=config.scan_layers)


# -- ResNet ------------------------------------------------------------------


def _resnet_tensors(model: ResNet):
    """(JAX key, port name, tensor) for every parameter and BN buffer."""
    for kind, items in (("params", model.named_parameters()),
                        ("batch_stats", model.named_buffers())):
        for name, t in items:
            yield f"{kind}/{name.replace('.', '/')}", name, t


def _jax_shape(name: str, shape) -> tuple:
    """The JAX leaf shape of port tensor ``name`` of ``shape``."""
    shape = tuple(shape)
    if len(shape) == 4:                      # (O, I, kh, kw)
        O, I, kh, kw = shape
        return (kh, kw, I, O)
    if name.endswith("bn2conv3.kernel"):     # (C, F)
        return (1, 1) + shape
    return shape


def _from_jax(name: str, src: torch.Tensor, shape) -> torch.Tensor:
    if len(shape) == 4:
        return src.permute(3, 2, 0, 1)
    if name.endswith("bn2conv3.kernel"):
        return src.reshape(tuple(shape))
    return src


def _to_jax(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    if name.endswith("bn2conv3.kernel"):
        return t.reshape(1, 1, *t.shape)
    return t


def load_resnet(model: ResNet, variables: Mapping[str, Any]) -> ResNet:
    """Copy JAX ResNet variables (``params`` + ``batch_stats``) into
    ``model`` in place; every port tensor must be found with its shape,
    and every JAX leaf used. Returns ``model``."""
    flat = flatten(variables)
    used = set()
    with torch.no_grad():
        for key, name, t in _resnet_tensors(model):
            if key not in flat:
                raise KeyError(f"leaf {key!r} (for {name}) not in the JAX "
                               f"variables")
            src = _from_jax(name, _as_tensor(flat[key]), t.shape)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(flat[key].shape)} "
                                 f"does not fit port {name} "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(device=t.device, dtype=t.dtype))
            used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"JAX leaves with no port tensor: {extra[:8]}")
    return model


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat ``/``-joined keys → nested dict (the inverse of
    :func:`flatten`)."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def resnet_variables(model: ResNet) -> Dict[str, Any]:
    """The module's weights and BN statistics as nested JAX-layout
    variables of f32 numpy arrays (the inverse of :func:`load_resnet`)."""
    flat = {key: np.array(_to_jax(name, t.detach()).float().cpu().numpy())
            for key, name, t in _resnet_tensors(model)}
    return unflatten(flat)


def resnet_grads(model: ResNet, grads) -> Dict[str, Any]:
    """Gradients aligned with ``model.parameters()`` as a nested
    JAX-layout ``{"params": ...}`` tree of f32 numpy arrays."""
    names = [name for name, _ in model.named_parameters()]
    return unflatten({
        f"params/{name.replace('.', '/')}":
            np.array(_to_jax(name, g.detach()).float().cpu().numpy())
        for name, g in zip(names, grads)})


def unfuse_bn_conv(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Fused-layout ResNet variables in the unfused layout: each block's
    ``bn2conv3`` becomes ``bn2`` (scale, bias and statistics) and
    ``conv3`` (the kernel), the same weights."""
    flat = {}
    for key, val in flatten(variables).items():
        if "/bn2conv3/" in key:
            part = "conv3" if key.endswith("/kernel") else "bn2"
            key = key.replace("/bn2conv3/", f"/{part}/")
        flat[key] = val
    return unflatten(flat)


def _place(model: ResNet, device) -> ResNet:
    # NHWC bytes for the 4-D conv kernels too, as the activations are
    return model.to(device=resolve_device(device),
                    memory_format=torch.channels_last)


def resnet_to_module(config: ResNetConfig, variables: Mapping[str, Any], *,
                     device) -> ResNet:
    """A loaded, frozen port ``ResNet`` in eval mode on ``device``."""
    model = _place(load_resnet(ResNet(config), variables), device).eval()
    model.requires_grad_(False)
    return model


def resnet_to_trainable(config: ResNetConfig, variables: Mapping[str, Any],
                        *, device=None) -> ResNet:
    """A loaded port ``ResNet`` on ``device`` (CUDA unless ``"cpu"`` is
    asked for), in train mode with every parameter trainable."""
    return _place(load_resnet(ResNet(config), variables), device).train()


def random_resnet_params(config: ResNetConfig,
                         seed: int) -> Dict[str, Any]:
    """Random JAX-layout ResNet variables from a numpy seed: every kernel
    normal(0, fan_in**-0.5) (the scale of flax's lecun_normal), BN scales
    one except bn3's, which are zero as in the reference, biases zero,
    running means zero and variances one; all f32."""
    with torch.device("meta"):
        model = ResNet(config)
    rng = np.random.default_rng(seed)
    flat: Dict[str, np.ndarray] = {}
    for key, name, t in _resnet_tensors(model):
        shape = _jax_shape(name, t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            std = float(np.prod(shape[:-1])) ** -0.5
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                std)
        elif leaf == "var" or (leaf == "scale" and
                               not name.endswith("bn3.scale")):
            arr = np.ones(shape, np.float32)
        else:                                # biases, means, bn3 scales
            arr = np.zeros(shape, np.float32)
        flat[key] = arr
    return unflatten(flat)


# -- servables (the model store's kinds) ---------------------------------------


def load_servable(kind: str, model: torch.nn.Module,
                  flat: Mapping[str, Any], *, device) -> torch.nn.Module:
    """Fill a servable built without weights (on the meta device, as
    ``serving/model_store.py:build_model`` builds it) with a model-store
    export's leaves: frozen, in eval mode, on ``device``. A ``resnet``
    export holds ``params/...`` and ``batch_stats/...`` (its activations
    and 4-D kernels then go channels-last); the other kinds hold their
    param tree."""
    model = model.to_empty(device=resolve_device(device))
    if kind == "resnet":
        model = load_resnet(model, flat).to(memory_format=torch.channels_last)
    else:
        load_params(model, flat)
    model.eval().requires_grad_(False)
    return model


def random_mnist_params(seed: int) -> Dict[str, Any]:
    """Random f32 ``MnistCnn`` params in flax's layout from a numpy seed:
    kernels normal(0, fan_in**-0.5), biases zero."""
    from kubeflow_tpu_torch.models.mnist import MnistCnn

    with torch.device("meta"):
        model = MnistCnn()
    rng = np.random.default_rng(seed)
    flat: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".kernel"):
            std = np.float32(float(np.prod(shape[:-1])) ** -0.5)
            flat[name.replace(".", "/")] = rng.standard_normal(
                shape, dtype=np.float32) * std
        else:
            flat[name.replace(".", "/")] = np.zeros(shape, np.float32)
    return unflatten(flat)
