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

The four servable kinds of the reference's ``build_model``: ``mnist``,
``resnet``, ``bert`` and ``transformer``. A loaded version carries
:meth:`LoadedModel.predict` (host → device, the forward under
``torch.inference_mode``, device → host) and, for the ``transformer``
kind, the unary path's :meth:`LoadedModel.generate`. ``export_model``
records the per-sample ``input_shape``/``input_dtype`` (the reference's
defaults for ``mnist`` and ``resnet``), which the server warms and
checks requests against. An export with ``draft_of:
"<model>[@<version>]"`` in its ``model.yaml`` is a speculative-decoding
draft of that model: :func:`find_draft_for` finds it and the server
pairs it as one :class:`DraftPair`.

``load_version(..., mesh=)`` loads a ``transformer`` export split over a
mesh: the LM is built over it on the meta device and each rank keeps
only its block of every split leaf as it fills it (the reference's
``shard_lm_params``; from a param tree in memory,
``models/convert.py:to_module(..., mesh=)`` does the same). Over a
lockstep mesh a split LM's ``link`` sends each device call's plan to the
follower ranks first (``serving/server.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

from kubeflow_tpu_torch.models import convert, decode
from kubeflow_tpu_torch.models.bert import Bert, BertConfig
from kubeflow_tpu_torch.models.mnist import MnistCnn
from kubeflow_tpu_torch.models.resnet import ResNet, ResNetConfig
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

# per-sample input shapes for warm-up when the exporter does not say
_DEFAULT_INPUT_SHAPES: Dict[str, Tuple[int, ...]] = {
    "mnist": (28, 28, 1),
    "resnet": (224, 224, 3),
}

Apply = Callable[[torch.nn.Module, torch.Tensor], torch.Tensor]


def _lm_apply(m: Transformer, x: torch.Tensor) -> torch.Tensor:
    """The LM's inference forward: full logits, its vocabulary blocks
    gathered over ``tp`` when the model is split over a mesh."""
    return m.full_logits(m(x))


def build_model(kind: str, config: Dict[str, Any], *, mesh=None
                ) -> Tuple[torch.nn.Module, Apply]:
    """A servable by kind name, without weights (on the meta device):
    ``(module, apply)``, ``apply(module, x)`` its inference forward. As
    the reference's: a ``resnet`` config's stem defaults to ``"conv"``
    here, not to ``ResNetConfig``'s default, because exports made before
    the space-to-depth stem existed hold ``stem_conv`` params; dtype
    names (``"bfloat16"``) become torch dtypes in the configs. ``mesh``
    (the ``transformer`` kind only) builds the LM over it: each rank
    holds its block of every split leaf, and every block (a served
    model is not pipelined: ``pp`` replicates it)."""
    with torch.device("meta"):
        if kind == "mnist":
            return MnistCnn(), lambda m, x: m(x)
        if kind == "resnet":
            cfg = ResNetConfig(**{
                **config, "stem": config.get("stem", "conv"),
                "stage_sizes": tuple(config.get("stage_sizes",
                                                (3, 4, 6, 3)))})
            return ResNet(cfg), lambda m, x: m(x, train=False)
        if kind == "bert":
            return Bert(BertConfig(**config)), lambda m, x: m(x)
        if kind == "transformer":
            return Transformer(TransformerConfig(**config),
                               mesh=mesh), _lm_apply
    raise ValueError(f"unknown model kind {kind!r}")



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
                 input_shape: Optional[Tuple[int, ...]] = None,
                 input_dtype: str = "float32",
                 quantize: bool = False,
                 draft_of: Optional[str] = None) -> str:
    """Write ``<path>/<version>/{model.yaml,params.npz}``; returns the
    version dir. ``params`` is a flat (``/``-joined) or nested dict of
    numpy f32 arrays in the JAX layout (``models/convert.py``); a
    ``resnet`` export's are its variables (``params`` and
    ``batch_stats``). ``input_shape`` (without the batch dim; the
    reference's default for ``mnist`` and ``resnet``) and
    ``input_dtype`` let the server warm every padded batch bucket and
    refuse a wrong-shaped request with a 400. The yaml is written last
    and atomically: its presence publishes the version.
    ``draft_of="<model>"`` or ``"<model>@<version>"`` marks the export as
    that model's speculative draft (an unversioned pairing follows the
    target's served version)."""
    vdir = os.path.join(path, str(version))
    os.makedirs(vdir, exist_ok=True)
    meta: Dict[str, Any] = {"kind": kind, "config": config or {}}
    if draft_of:
        meta["draft_of"] = str(draft_of)
    if input_shape is None:
        input_shape = _DEFAULT_INPUT_SHAPES.get(kind)
    if input_shape is not None:
        meta["input_shape"] = [int(d) for d in input_shape]
        meta["input_dtype"] = input_dtype
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


@dataclasses.dataclass(frozen=True)
class DraftPair:
    """A paired speculative draft. Immutable and swapped through ONE
    ``LoadedModel.draft`` reference, so a request snapshots config,
    module and ref together across a repair or detach by the poll
    thread."""

    config: TransformerConfig
    params: Transformer      # the loaded draft module
    ref: str                 # "<draft name>@<version>"


# the kinds whose input is token ids (B, S)
TOKEN_KINDS = ("bert", "transformer")


@dataclasses.dataclass
class LoadedModel:
    kind: str
    version: int
    module: torch.nn.Module  # the loaded model, on the serving device
    apply: Apply             # its inference forward (build_model)
    input_shape: Optional[Tuple[int, ...]] = None  # per sample
    input_dtype: str = "float32"
    # the paired draft (server.py:ModelRepository._attach_draft), or None
    draft: Optional[DraftPair] = None
    # an LM split over a lockstep mesh: ``link(op, *args)`` sends each
    # device call's plan to the follower ranks first (``serving/
    # server.py:ModelRepository``); None otherwise
    link: Optional[Callable[..., Any]] = None

    def _lockstep(self, op: str, *args):
        return (self.link(op, *args) if self.link is not None
                else contextlib.nullcontext())

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    # the transformer kind's config and module (the unary path's and the
    # decode engine's) and its bounds; None for the other kinds

    @property
    def lm_config(self) -> Optional[TransformerConfig]:
        return self.module.config if self.kind == "transformer" else None

    @property
    def lm_params(self) -> Optional[Transformer]:
        return self.module if self.kind == "transformer" else None

    @property
    def max_seq_len(self) -> Optional[int]:
        cfg = self.lm_config
        return cfg.max_seq_len if cfg is not None else None

    @property
    def vocab_size(self) -> Optional[int]:
        cfg = self.lm_config
        return cfg.vocab_size if cfg is not None else None

    def input_error(self, shape: Tuple[int, ...],
                    dtype: np.dtype) -> Optional[str]:
        """Why a ``(B, ...)`` batch of ``dtype`` cannot run, or None.
        The reference's JAX forward raises TypeError or ValueError
        (a 400) on such input; torch raises RuntimeError, the type of an
        execution fault, or reads a float id as an integer, so the port
        checks before the launch."""
        if self.input_shape is not None:
            if tuple(shape[1:]) != tuple(self.input_shape):
                return (f"instance shape {tuple(shape[1:])} != model "
                        f"input {tuple(self.input_shape)}")
            return None
        if self.kind in TOKEN_KINDS:
            if len(shape) != 2 or shape[1] < 1:
                return (f"token ids must be (batch, seq), got shape "
                        f"{tuple(shape)}")
            if dtype.kind not in "biu":
                return f"token ids must be integers, got {dtype}"
            return None
        channels = {"mnist": 1, "resnet": ResNet.IN_CHANNELS}[self.kind]
        if len(shape) != 4 or shape[3] != channels:
            return (f"images must be (batch, H, W, {channels}), got shape "
                    f"{tuple(shape)}")
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The model's inference forward on a batch on its device."""
        with torch.inference_mode():
            return self.apply(self.module, x)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Host → device, :meth:`forward`, device → host; the outputs
        as f32 numpy (logits, as the reference's)."""
        x = np.asarray(x)
        with self._lockstep("predict", x):
            t = torch.as_tensor(x).to(self.device)
            return self.forward(t).float().cpu().numpy()

    def warmup(self, batch_sizes) -> int:
        """Run :meth:`predict` once at each batch bucket (on the card:
        the first cuDNN and cuBLAS setups of each shape); returns the
        count warmed, 0 without an ``input_shape``."""
        if self.input_shape is None:
            return 0
        for b in batch_sizes:
            self.predict(np.zeros((int(b), *self.input_shape),
                                  np.dtype(self.input_dtype)))
        return len(batch_sizes)

    def generate(self, prompt, true_len, max_new: int, temperature,
                 seed: int, *, greedy: bool, top_k=0, top_p=1.0,
                 filtered: bool = False) -> np.ndarray:
        """The unary path's batch generate (the reference's jitted
        closure): ``(B, S)`` right-padded prompts with lengths ``(B,)``
        → ``(B, max_new)`` int32 tokens. ``greedy`` and ``filtered``
        decide, as there, whether the temperature and the filters are
        read at all."""
        dev = self.lm_params.token_embed.device
        prompt = np.asarray(prompt, np.int32)
        true_len = np.asarray(true_len, np.int32)
        with self._lockstep("generate", prompt, true_len, int(max_new),
                            float(temperature), int(seed), bool(greedy),
                            int(top_k), float(top_p), bool(filtered)):
            out = decode.generate(
                self.lm_params, torch.as_tensor(prompt, device=dev),
                max_new_tokens=int(max_new),
                true_len=torch.as_tensor(true_len, device=dev),
                temperature=0.0 if greedy else float(temperature),
                top_k=int(top_k) if filtered else 0,
                top_p=float(top_p) if filtered else 1.0,
                seed=int(seed))
            return out.cpu().numpy()

    def speculate(self, draft: DraftPair, prompt, true_len,
                  max_new: int, draft_len: int):
        """Greedy speculative decoding of ``(B, S)`` right-padded prompts
        with lengths ``(B,)`` through ``draft`` (whole on every rank
        beside a split target, as the reference keeps it replicated):
        ``((B, max_new) int32 tokens, stats)``."""
        dev = self.lm_params.token_embed.device
        prompt = np.asarray(prompt, np.int32)
        true_len = np.asarray(true_len, np.int32)
        with self._lockstep("speculate", draft.ref, prompt, true_len,
                            int(max_new), int(draft_len)):
            toks, stats = decode.speculative_generate_jit(
                self.lm_params, draft.params,
                torch.as_tensor(prompt, device=dev),
                max_new_tokens=int(max_new), draft_len=int(draft_len),
                true_len=torch.as_tensor(true_len, device=dev))
            return toks.cpu().numpy(), stats


def read_kind(base_path: str, version: int) -> str:
    """The servable kind one version's ``model.yaml`` records."""
    with open(os.path.join(base_path, str(version), MODEL_FILE)) as f:
        return yaml.safe_load(f)["kind"]


def load_version(base_path: str, version: int, *, device=None,
                 mesh=None) -> LoadedModel:
    """Load one version of any servable kind onto ``device`` (default
    CUDA). ``mesh`` (the ``transformer`` kind only, as in the
    reference): the LM is built over it and each rank keeps only its
    block of every split leaf as it reads the export; the other kinds
    load whole."""
    dev = resolve_device(device)
    vdir = os.path.join(base_path, str(version))
    with open(os.path.join(vdir, MODEL_FILE)) as f:
        meta = yaml.safe_load(f)
    kind = meta["kind"]
    module, apply = build_model(
        kind, meta.get("config") or {},
        mesh=mesh if kind == "transformer" else None)
    module = convert.load_servable(kind, module, read_params(vdir, meta),
                                   device=dev)
    shape = meta.get("input_shape")
    return LoadedModel(kind=kind, version=version, module=module,
                       apply=apply,
                       input_shape=tuple(shape) if shape else None,
                       input_dtype=meta.get("input_dtype", "float32"))


def load_latest(base_path: str, *, device=None) -> Optional[LoadedModel]:
    """The newest version under ``base_path`` (:func:`load_version`), or
    None when there is none (the reference's ``load_latest``)."""
    versions = list_versions(base_path)
    if not versions:
        return None
    return load_version(base_path, versions[-1], device=device)


def find_draft_for(store_root: str, target_name: str,
                   target_version: int) -> Optional[Tuple[str, int]]:
    """The store sibling declaring itself this target's draft:
    ``model.yaml`` carries ``draft_of: "<target>"`` (follows the target
    across versions) or ``"<target>@<version>"`` (pinned). Returns
    ``(draft_name, draft_version)`` — the newest matching version of the
    first matching model name — or None."""
    if not os.path.isdir(store_root):
        return None
    want = {target_name, f"{target_name}@{target_version}"}
    for d in sorted(os.listdir(store_root)):
        mdir = os.path.join(store_root, d)
        if d == target_name or not os.path.isdir(mdir):
            continue
        for v in reversed(list_versions(mdir)):
            try:
                with open(os.path.join(mdir, str(v), MODEL_FILE)) as f:
                    meta = yaml.safe_load(f) or {}
            except (OSError, yaml.YAMLError):
                continue  # a mid-write or corrupt sibling
            if isinstance(meta, dict) and meta.get("draft_of") in want:
                return d, v
    return None
