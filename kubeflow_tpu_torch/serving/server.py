"""Model server for the port: ``:predict`` for every servable kind, and
``:generate``, unary or through the decode engine.

PyTorch port of ``kubeflow_tpu/serving/server.py``, with the same request
and response JSON and the same status codes:

- ``GET /v1/models``, ``GET /v1/models/<name>``, ``GET /metrics`` (the
  exemplar suffixes only for a scraper that sends ``X-Kftpu-Exemplars``),
  ``GET /healthz``;
- ``POST /v1/models/<name>[/versions/<v>]:predict`` with ``{"instances":
  [...]}`` for the ``mnist``, ``resnet``, ``bert`` and ``transformer``
  kinds: float64 instances are cast to f32, the batch is padded to a
  bucket (1, 2, 4, 8, ... up to ``max_batch_size``) and the
  ``predictions`` sliced back; a missing ``instances``, scalar or ragged
  instances, a batch over ``max_batch_size`` and a shape other than the
  export's ``input_shape`` answer 400. ``warmup=True`` runs every bucket
  once at load for a kind whose export records its ``input_shape``;
- ``POST /v1/models/<name>[/versions/<v>]:generate`` with
  ``{"prompt_tokens": [[...], ...], "max_new_tokens", "temperature",
  "top_k", "top_p", "seed", "eos_id", "prefix_len", "true_len",
  "stream", "speculative", "draft_len"}``; ``stream: true`` answers with
  JSON lines over chunked transfer, one ``{"tokens": [...]}`` per decode
  position.

With ``decode_slots`` 0 (the default, as in the reference) a request is
served UNARY: the batch is padded to a prompt bucket, a new-token bucket
and a batch bucket, and one ``LoadedModel.generate`` decodes it;
``eos_id`` and ``prefix_len`` need the engine and answer 400. With
``decode_slots`` > 0 each prompt row becomes one engine request sharing
the decode batch.

``speculative: true`` routes a greedy request through the model's
paired draft (an export declaring ``draft_of`` this model, paired at
load and re-paired, repaired or detached on later polls): the draft
proposes ``draft_len`` tokens a round and the target verifies them in
one forward (``models/decode.py:speculative_generate``). The response
adds ``speculative: {draft, draft_len, rounds, draft_tokens, accepted,
acceptance_rate}``; without a draft, or with sampling, streaming,
``eos_id`` or ``prefix_len``, it answers 400 with the reference's error.

Every POST opens a ``serving.predict`` or ``serving.generate`` span
that continues the caller's ``traceparent`` and carries the response's
``http.status``; engine submits made inside it parent their spans on it
and key their ledger record by its trace id. A streamed response charges
the ledger's ``stream_stall`` phase for every write the client takes
longer than :data:`STREAM_STALL_MIN_S` to drain.

With ``decode_mesh`` (``KFTPU_SERVING_MESH`` in :func:`main`: the
reference's multi-chip serving), each LM version loads split over the
mesh (``model_store.py:load_version(mesh=)``: each rank its block of
every split leaf) and its engine's cache is created split; the other
kinds load whole on rank 0. Over more than one rank the mesh serves in
lockstep (``serving/lockstep.py``): rank 0 runs the front ends and the
scheduler and sends a plan before every program on a split model (a
load, a version's drop, an engine's creation and its programs, a unary
or speculative generate, an LM ``:predict``); every other rank runs
:func:`serve_follower`, a :class:`MeshFollower` with no front end that
runs each plan on its shard. The speculative draft loads whole on every
rank beside the split target, as the reference keeps it replicated.
Rank 0 exits with an error when a follower is gone; a follower exits
with one when the plans stop.

:func:`main` also serves the gRPC prediction service
(``serving/grpc_server.py``) on ``KFTPU_GRPC_PORT`` (9000; 0 turns it
off) over the same repository, and serves REST alone, with a warning,
where ``grpc`` cannot be imported.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from kubeflow_tpu_torch.obs import requests as reqobs
from kubeflow_tpu_torch.obs.trace import (
    TRACER,
    SpanCollector,
    Tracer,
    extract,
)
from kubeflow_tpu_torch.parallel.mesh import parse_serving_mesh
from kubeflow_tpu_torch.serving.engine import (
    DecodeEngine,
    EngineClosed,
    pow2_bucket,
)
from kubeflow_tpu_torch.serving.lockstep import Lockstep
from kubeflow_tpu_torch.serving.model_store import (
    DraftPair,
    LoadedModel,
    find_draft_for,
    list_versions,
    load_version,
    read_kind,
)
from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY
from kubeflow_tpu_torch.utils.device import resolve_device
from kubeflow_tpu_torch.utils.metrics import exposition

log = logging.getLogger(__name__)

_requests = DEFAULT_REGISTRY.counter(
    "kftpu_serving_requests_total", "predict requests")
_latency = DEFAULT_REGISTRY.gauge(
    "kftpu_serving_last_latency_seconds", "last predict latency")
# a streamed-generate write suspended longer than this charges the
# request ledger's stream_stall phase; below it is scheduling jitter
STREAM_STALL_MIN_S = 0.05
_gen_requests = DEFAULT_REGISTRY.counter(
    "kftpu_serving_generate_requests_total", "generate requests")
_gen_latency = DEFAULT_REGISTRY.gauge(
    "kftpu_serving_generate_last_latency_seconds", "last generate latency")
_spec_requests = DEFAULT_REGISTRY.counter(
    "kftpu_serving_speculative_requests_total",
    "generate requests served through a speculative draft pair")
_spec_draft_tokens = DEFAULT_REGISTRY.counter(
    "kftpu_serving_speculative_draft_tokens_total",
    "draft tokens proposed to the target verifier")
_spec_accepted_tokens = DEFAULT_REGISTRY.counter(
    "kftpu_serving_speculative_accepted_tokens_total",
    "draft tokens the target verifier accepted")
_spec_rate = DEFAULT_REGISTRY.gauge(
    "kftpu_serving_speculative_last_acceptance_rate",
    "acceptance rate (accepted/proposed) of the last speculative request")


_PAD_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _pad_batch(arr: np.ndarray, max_batch: int) -> Tuple[np.ndarray, int]:
    """Pad the leading dim up to a fixed bucket (one shape per bucket)."""
    n = arr.shape[0]
    bucket = next((b for b in _PAD_BUCKETS if b >= n and b <= max_batch),
                  max_batch)
    if n == bucket:
        return arr, n
    pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0), n


def _parse(model: LoadedModel, body: Dict[str, Any], max_batch_size: int,
           unary: bool):
    """Validate a generate body; (error tuple, None) or (None, args)."""
    prompts = body.get("prompt_tokens")
    if prompts is None:
        return (400, {"error": "request must carry 'prompt_tokens' "
                               "(batch of int token lists)"}), None
    try:
        max_new = int(body.get("max_new_tokens", 16))
        temperature = float(body.get("temperature", 0.0))
        top_k = int(body.get("top_k", 0))
        top_p = float(body.get("top_p", 1.0))
        seed = int(body.get("seed", 0))
        row_lens = [len(p) for p in prompts]
        if not row_lens:
            return (400, {"error": "prompt_tokens batch is empty"}), None
        if min(row_lens) < 1:
            return (400, {"error": "empty prompt row"}), None
        width = max(row_lens)
        arr = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            arr[i, :row_lens[i]] = np.asarray(p, dtype=np.int64)
        explicit = int(body.get("true_len", 0))
        if explicit:
            if not 1 <= explicit <= width:
                return (400, {"error": f"true_len {explicit} must be in "
                                       f"[1, {width}]"}), None
            row_lens = [explicit] * arr.shape[0]
            arr = arr[:, :explicit]
        prefix_len = int(body.get("prefix_len", 0))
    except (TypeError, ValueError) as e:
        return (400, {"error": f"bad prompt_tokens: {e}"}), None
    if max_new < 1:
        return (400, {"error": "max_new_tokens must be >= 1"}), None
    if temperature < 0:
        return (400, {"error": "temperature must be >= 0"}), None
    if not 0 <= top_k < 2**31:
        return (400, {"error": "top_k must be in [0, 2**31) "
                               "(0 = no filter)"}), None
    if not 0.0 < top_p <= 1.0:
        return (400, {"error": "top_p must be in (0, 1]"}), None
    if not -2**31 <= seed < 2**31:
        return (400, {"error": "seed must fit in int32"}), None
    if prefix_len and unary:
        return (400, {"error": "prefix_len requires the decode engine "
                               "(server started with decode_slots=0)"}), None
    if prefix_len and not 0 < prefix_len < min(row_lens):
        return (400, {"error": f"prefix_len {prefix_len} must be in "
                               f"(0, shortest prompt row "
                               f"{min(row_lens)})"}), None
    eos_id = body.get("eos_id")
    if eos_id is not None:
        try:
            eos_id = int(eos_id)
        except (TypeError, ValueError):
            return (400, {"error": "eos_id must be an int token id"}), None
        if not 0 <= eos_id < model.vocab_size:
            return (400, {"error": f"eos_id must be in [0, "
                                   f"{model.vocab_size})"}), None
        if unary:
            # only the engine watches for EOS
            return (400, {"error": "eos_id requires the decode engine "
                                   "(server started with decode_slots=0)"}
                    ), None
    if arr.shape[0] > max_batch_size:
        return (400, {"error": f"batch {arr.shape[0]} exceeds max "
                               f"{max_batch_size}"}), None
    real = np.concatenate([arr[i, :n] for i, n in enumerate(row_lens)])
    if real.min() < 0 or real.max() >= model.vocab_size:
        return (400, {"error": f"token ids must be in [0, "
                               f"{model.vocab_size})"}), None
    return None, dict(arr=arr, row_lens=row_lens, max_new=max_new,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, eos_id=eos_id, prefix_len=prefix_len)


def run_generate(model: LoadedModel, body: Dict[str, Any],
                 max_batch_size: int, *,
                 engine: Optional[DecodeEngine] = None,
                 model_name: str = "", stream: bool = False
                 ) -> Tuple[int, Dict[str, Any]]:
    """The generate core: validation, then a dense ``(B, max_new)``
    token matrix or, with ``stream=True``, a ``token_stream`` iterator
    of per-step rows. Without an engine the batch is served unary;
    with one, each prompt row is one engine request (row ``i`` samples
    from ``seed + i``) and EOS-finished rows are right-padded with their
    final token. Returns (http status, payload)."""
    if model.lm_config is None:
        return 400, {"error": f"model {model_name!r} (kind "
                              f"{model.kind!r}) does not support generate"}
    err, a = _parse(model, body, max_batch_size, engine is None)
    if err is not None:
        return err
    if body.get("speculative"):
        return _run_generate_speculative(model, body, a,
                                         model_name=model_name,
                                         stream=stream)
    over = [n for n in a["row_lens"] if n + a["max_new"] > model.max_seq_len]
    if over:
        return 400, {"error": f"prompt ({max(over)}) + max_new_tokens "
                              f"({a['max_new']}) exceed the model context "
                              f"({model.max_seq_len})"}
    if engine is None:
        return _run_generate_unary(model, a, max_batch_size,
                                   model_name=model_name, stream=stream)
    t0 = time.perf_counter()
    try:
        reqs = [engine.submit(
            a["arr"][i, :a["row_lens"][i]], max_new=a["max_new"],
            temperature=a["temperature"], top_k=a["top_k"],
            top_p=a["top_p"],
            seed=int((np.int64(a["seed"]) + i) & 0x7FFFFFFF),
            eos_id=a["eos_id"], prefix_len=a["prefix_len"])
            for i in range(a["arr"].shape[0])]
    except ValueError as e:
        return 400, {"error": str(e)}
    except EngineClosed as e:
        return 503, {"error": str(e)}
    _gen_requests.inc(model=model_name)

    if stream:
        def steps():
            # time suspended at a yield is the client not draining (the
            # writer is parked in its socket write): it charges the rows'
            # records as stream_stall, on the engine's clock
            clock = engine.clock
            try:
                iters = [r.stream() for r in reqs]
                lasts = [0] * len(iters)
                done = [False] * len(iters)
                while True:
                    fresh = False
                    for i, it in enumerate(iters):
                        if done[i]:
                            continue
                        try:
                            lasts[i] = next(it)
                            fresh = True
                        except StopIteration:
                            done[i] = True
                    if not fresh:
                        return
                    ty0 = clock()
                    yield [int(t) for t in lasts]
                    ty1 = clock()
                    if ty1 - ty0 >= STREAM_STALL_MIN_S:
                        for r in reqs:
                            engine.rledger.stall(r.rid, reqobs.STREAM_STALL,
                                                 ty0, ty1)
            finally:
                _gen_latency.set(time.perf_counter() - t0, model=model_name)

        return 200, {"token_stream": steps(),
                     "model_version": str(model.version)}

    try:
        rows = [r.result() for r in reqs]
    except EngineClosed as e:
        return 503, {"error": f"generate failed: {e}"}
    except Exception as e:  # noqa: BLE001 — engine/runtime fault
        return 500, {"error": f"generate failed: {type(e).__name__}: {e}"}
    dt = time.perf_counter() - t0
    out = [row + [row[-1]] * (a["max_new"] - len(row)) for row in rows]
    _gen_latency.set(dt, model=model_name)
    return 200, {"tokens": out, "model_version": str(model.version),
                 "tokens_per_sec": round(sum(map(len, rows)) / dt, 1)}


def _run_generate_unary(model: LoadedModel, a: Dict[str, Any],
                        max_batch_size: int, *, model_name: str,
                        stream: bool) -> Tuple[int, Dict[str, Any]]:
    """The engine-less half of :func:`run_generate`: one padded batch
    through ``model.generate``. The prompt pads to a power-of-two
    bucket; the new tokens to a power of two no larger than the context
    left after the longest prompt (or the exact ask where only that
    fits: :func:`_parse` refused any ask past the context); the rows to
    a batch bucket, filler rows of length 1."""
    arr, row_lens, max_new = a["arr"], a["row_lens"], a["max_new"]
    true_len = max(row_lens)
    ctx = model.max_seq_len
    bucket = pow2_bucket(true_len, ctx)
    new_bucket = pow2_bucket(max_new, 1 << 30)
    while new_bucket > ctx - true_len:
        new_bucket //= 2
    new_bucket = max(new_bucket, max_new)
    padded = np.zeros((arr.shape[0], bucket), np.int32)
    padded[:, :arr.shape[1]] = arr
    padded, n = _pad_batch(padded, max_batch_size)
    lens = np.ones((padded.shape[0],), np.int32)
    lens[:n] = row_lens
    temperature = a["temperature"]
    greedy = temperature == 0.0
    t0 = time.perf_counter()
    try:
        out = model.generate(
            padded, lens, new_bucket, temperature, a["seed"],
            greedy=greedy, top_k=a["top_k"], top_p=a["top_p"],
            filtered=(a["top_k"] > 0 or a["top_p"] < 1.0) and not greedy
        )[:n, :max_new]
    except (TypeError, ValueError) as e:
        return 400, {"error": f"generate failed: {type(e).__name__}: {e}"}
    except Exception as e:  # noqa: BLE001 — model or runtime fault
        return 500, {"error": f"generate failed: {type(e).__name__}: {e}"}
    dt = time.perf_counter() - t0
    _gen_requests.inc(model=model_name)
    _gen_latency.set(dt, model=model_name)
    if stream:
        return 200, {"token_stream": (out[:, t].tolist()
                                      for t in range(out.shape[1])),
                     "model_version": str(model.version)}
    return 200, {"tokens": out.tolist(),
                 "model_version": str(model.version),
                 "tokens_per_sec": round(out.size / dt, 1)}


def _run_generate_speculative(model: LoadedModel, body: Dict[str, Any],
                              a: Dict[str, Any], *, model_name: str,
                              stream: bool) -> Tuple[int, Dict[str, Any]]:
    """The ``speculative: true`` half of :func:`run_generate`: the
    reference's checks in its order, then the paired draft proposes and
    the target verifies (``speculative_generate_jit``). Greedy output
    equals the plain path token for token at f32 (at bf16 up to argmax
    near-ties). The prompt pads to a power-of-two bucket and the new
    tokens to a power of two within ``min(target ctx, draft ctx) -
    prompt - draft_len`` (or the exact ask where only that fits); the
    batch is served at its exact size, since filler rows would enter
    the acceptance rate."""
    try:
        draft_len = int(body.get("draft_len", 4))
    except (TypeError, ValueError):
        return 400, {"error": "draft_len must be an int"}
    if not 1 <= draft_len <= 16:
        return 400, {"error": "draft_len must be in [1, 16]"}
    draft = model.draft  # one atomic snapshot (see DraftPair)
    if draft is None:
        return 400, {"error": f"model {model_name!r} has no paired "
                              "speculative draft (export one with "
                              "export_model(..., draft_of=...); see "
                              "kubeflow_tpu/train/distill.py)"}
    if a["temperature"] != 0.0:
        return 400, {"error": "speculative decoding is greedy-only "
                              "(temperature must be 0)"}
    if stream:
        return 400, {"error": "speculative decoding does not stream "
                              "(tokens emit in verified chunks)"}
    if a["eos_id"] is not None or a["prefix_len"]:
        return 400, {"error": "eos_id/prefix_len require the engine "
                              "path; drop 'speculative' to use them"}
    arr, max_new = a["arr"], a["max_new"]
    lens = np.asarray(a["row_lens"], np.int32)
    true_len = int(lens.max())
    ctx = model.max_seq_len
    bucket = pow2_bucket(true_len, ctx)
    budget = max(min(ctx, draft.config.max_seq_len) - true_len - draft_len,
                 0)
    new_bucket = pow2_bucket(max_new, 1 << 30)
    while new_bucket > budget:
        new_bucket //= 2
    if new_bucket < max_new <= budget:
        new_bucket = max_new
    if bucket < true_len or new_bucket < max_new:
        return 400, {"error": f"prompt ({true_len}) + max_new_tokens "
                              f"({max_new}) + draft_len ({draft_len}) "
                              f"exceed the model context ({ctx}); "
                              "speculation needs slack for in-flight "
                              "proposals"}
    padded = np.zeros((arr.shape[0], bucket), np.int32)
    padded[:, :arr.shape[1]] = arr
    t0 = time.perf_counter()
    try:
        toks, stats = model.speculate(draft, padded, lens, new_bucket,
                                      draft_len)
    except ValueError as e:
        return 400, {"error": f"generate failed: {e}"}
    except Exception as e:  # noqa: BLE001 — model or runtime fault
        return 500, {"error": f"generate failed: {type(e).__name__}: {e}"}
    out = toks[:, :max_new]
    dt = time.perf_counter() - t0
    rate = stats["accepted"] / max(stats["draft_tokens"], 1)
    _gen_requests.inc(model=model_name)
    _gen_latency.set(dt, model=model_name)
    _spec_requests.inc(model=model_name)
    _spec_draft_tokens.inc(stats["draft_tokens"], model=model_name)
    _spec_accepted_tokens.inc(stats["accepted"], model=model_name)
    _spec_rate.set(rate, model=model_name)
    return 200, {"tokens": out.tolist(),
                 "model_version": str(model.version),
                 "tokens_per_sec": round(out.size / dt, 1),
                 "speculative": {
                     "draft": draft.ref,
                     "draft_len": draft_len,
                     "rounds": stats["rounds"],
                     "draft_tokens": stats["draft_tokens"],
                     "accepted": stats["accepted"],
                     "acceptance_rate": round(rate, 3),
                 }}


class ModelRepository:
    """Models under ``<base>/<name>/<version>/``, newest served (or
    ``pin_version``); with ``decode_slots`` > 0 each transformer version
    gets one decode engine. ``warmup_batches`` (as in the reference) are
    the padded batch buckets each loaded version runs once before it is
    swapped in (kinds whose export records an ``input_shape``), and a
    non-empty tuple builds each engine with ``precompile``: no request
    pays a first call's set-up (on the card: cuDNN's and cuBLAS's per
    shape, the sampler kernel's build). ``warmed`` counts the buckets
    warmed per ``(name, version)``. Every poll pairs each served LM with
    its speculative draft, if the store holds one
    (:meth:`_attach_draft`)."""

    def __init__(self, base_path: str, *, decode_slots: int = 0,
                 decode_steps_per_sync: int = 1,
                 pin_version: Optional[int] = None,
                 poll_interval_s: float = 10.0,
                 warmup_batches: Tuple[int, ...] = (),
                 device=None, decode_mesh=None) -> None:
        self.device = resolve_device(device)
        self.base_path = base_path
        # LMs too big for one card serve split over this mesh
        # (KFTPU_SERVING_MESH): loaded split, their engines' caches
        # created split; over more than one rank, in lockstep with the
        # followers (serve_follower)
        self.decode_mesh = decode_mesh
        self.lockstep = (Lockstep(device=self.device)
                         if decode_mesh is not None and decode_mesh.size() > 1
                         else None)
        self.decode_slots = decode_slots
        self.warmup_batches = tuple(warmup_batches)
        self.warmed: Dict[Tuple[str, int], int] = {}
        self.decode_steps_per_sync = decode_steps_per_sync
        self.pin_version = pin_version
        self.poll_interval_s = poll_interval_s
        self._models: Dict[str, LoadedModel] = {}
        self._pinned: Dict[Tuple[str, int], LoadedModel] = {}
        self._engines: Dict[Tuple[str, int], DecodeEngine] = {}
        self._draft_scans: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._engine_create_lock = threading.Lock()
        self._stop = threading.Event()
        self.refresh()

    def model_names(self) -> list:
        if not os.path.isdir(self.base_path):
            return []
        return sorted(d for d in os.listdir(self.base_path)
                      if list_versions(os.path.join(self.base_path, d)))

    def refresh(self) -> None:
        for name in self.model_names():
            mdir = os.path.join(self.base_path, name)
            versions = list_versions(mdir)
            if self.pin_version is not None:
                if self.pin_version not in versions:
                    log.warning("pinned version %d absent for model %s",
                                self.pin_version, name)
                    continue
                latest = self.pin_version
            else:
                latest = versions[-1]
            with self._lock:
                current = self._models.get(name)
            if current is not None and current.version == latest:
                # drafts pair, change or detach without a version bump
                if current.lm_config is not None:
                    self._attach_draft(name, current)
                continue
            log.info("loading model %s version %d", name, latest)
            loaded = self._load(name, latest)
            if loaded.lm_config is not None:
                self._attach_draft(name, loaded)
            self._warmup(name, loaded)
            with self._lock:
                self._models[name] = loaded
                stale = [k for k in self._engines
                         if k[0] == name and k[1] != latest
                         and k not in self._pinned]
                retired = [self._engines.pop(k) for k in stale]
            for eng in retired:
                eng.close()
            if (current is not None and current.link is not None
                    and (name, current.version) not in self._pinned):
                with self.lockstep.program("drop", name, current.version):
                    pass

    def _load(self, name: str, version: int) -> LoadedModel:
        """One version, split over ``decode_mesh`` when it is an LM and
        a mesh is set (the followers load their blocks in lockstep);
        whole on this rank otherwise, as the reference loads them."""
        mdir = os.path.join(self.base_path, name)
        if (self.decode_mesh is None
                or read_kind(mdir, version) != "transformer"):
            return load_version(mdir, version, device=self.device)
        with (self.lockstep.program("load", name, version)
              if self.lockstep is not None else contextlib.nullcontext()):
            loaded = load_version(mdir, version, device=self.device,
                                  mesh=self.decode_mesh)
        if self.lockstep is not None:
            loaded.link = functools.partial(self.lockstep.program, "model",
                                            name, version)
        return loaded

    def _warmup(self, name: str, loaded: LoadedModel) -> None:
        """Best-effort: a failed warm-up is logged and the version is
        served all the same (its first request pays the set-up)."""
        if not self.warmup_batches:
            return
        t0 = time.perf_counter()
        try:
            n = loaded.warmup(self.warmup_batches)
        except Exception:  # noqa: BLE001 — warm-up is best-effort
            log.exception("warmup failed for %s v%d", name, loaded.version)
            return
        self.warmed[(name, loaded.version)] = n
        if n:
            log.info("warmed %d batch buckets for %s v%d in %.1fs", n,
                     name, loaded.version, time.perf_counter() - t0)

    def _store_signature(self) -> Any:
        """A cheap change marker for the store (one mtime a model dir),
        so a poll skips the draft scan when nothing was exported."""
        try:
            return tuple(
                (d, os.path.getmtime(os.path.join(self.base_path, d)))
                for d in sorted(os.listdir(self.base_path))
                if os.path.isdir(os.path.join(self.base_path, d)))
        except OSError:
            return None

    def _attach_draft(self, name: str, loaded: LoadedModel) -> None:
        """Pair the store sibling declaring ``draft_of`` this model, as
        one :class:`DraftPair` swap; replace it when a newer draft
        appears and detach it when its export is gone. Best-effort: a
        broken draft never stops its target from serving."""
        sig = (loaded.version, self._store_signature())
        if self._draft_scans.get(name) == sig:
            return
        self._draft_scans[name] = sig
        try:
            pair = find_draft_for(self.base_path, name, loaded.version)
        except Exception:  # noqa: BLE001 — never abort the poll
            log.warning("draft scan failed for %s", name, exc_info=True)
            return
        if pair is None:
            if loaded.draft is not None:
                log.info("draft %s for model %s removed — detaching",
                         loaded.draft.ref, name)
                loaded.draft = None
            return
        dname, dver = pair
        if loaded.draft is not None and \
                loaded.draft.ref == f"{dname}@{dver}":
            return
        try:
            d = load_version(os.path.join(self.base_path, dname), dver,
                             device=self.device)
        except Exception:  # noqa: BLE001
            log.exception("failed to load draft %s@%d for %s", dname, dver,
                          name)
            return
        if d.vocab_size != loaded.vocab_size:
            log.warning("draft %s@%d vocab %d != target %s vocab %d — "
                        "ignoring", dname, dver, d.vocab_size, name,
                        loaded.vocab_size)
            return
        loaded.draft = DraftPair(config=d.lm_config, params=d.lm_params,
                                 ref=f"{dname}@{dver}")
        log.info("paired speculative draft %s with model %s@%d",
                 loaded.draft.ref, name, loaded.version)

    def get(self, name: str,
            version: Optional[int] = None) -> Optional[LoadedModel]:
        with self._lock:
            model = self._models.get(name)
        if model is None or version is None or model.version == version:
            return model
        with self._lock:
            cached = self._pinned.get((name, version))
        if cached is not None:
            return cached
        mdir = os.path.join(self.base_path, name)
        if version not in list_versions(mdir):
            return None
        loaded = self._load(name, version)
        with self._lock:
            self._pinned[(name, version)] = loaded
        return loaded

    def engine_for(self, name: str,
                   model: LoadedModel) -> Optional[DecodeEngine]:
        """The version's engine, built on first use; a self-closed engine
        (failed step) is replaced by a fresh one. None when the
        repository serves unary (``decode_slots`` <= 0) or the model is
        no LM."""
        if self.decode_slots <= 0 or model.lm_config is None:
            return None
        key = (name, model.version)
        with self._engine_create_lock:
            with self._lock:
                eng = self._engines.get(key)
            if eng is not None and not eng.closed:
                return eng
            warm = bool(self.warmup_batches)
            if model.link is None:
                eng = DecodeEngine(model.lm_config, model.lm_params,
                                   slots=self.decode_slots,
                                   steps_per_sync=self.decode_steps_per_sync,
                                   precompile=warm, name=name,
                                   device=self.device,
                                   mesh=model.lm_params.mesh)
            else:
                # lockstep: the followers build the twin from the
                # leader's resolved settings, and warm it up with it
                eng = DecodeEngine(
                    model.lm_config, model.lm_params,
                    slots=self.decode_slots,
                    steps_per_sync=self.decode_steps_per_sync, name=name,
                    device=self.device, mesh=self.decode_mesh,
                    autostart=False, link=functools.partial(
                        self.lockstep.program, "engine", name,
                        model.version))
                with self.lockstep.program(
                        "new_engine", name, model.version,
                        tuple(eng.settings().items()), warm):
                    if warm:
                        eng._precompile_steps()
                eng.start()
            with self._lock:
                self._engines[key] = eng
            return eng

    def status(self, name: str) -> Optional[Dict[str, Any]]:
        versions = list_versions(os.path.join(self.base_path, name))
        if not versions:
            return None
        with self._lock:
            served = self._models.get(name)
        out: Dict[str, Any] = {"model_version_status": [
            {"version": str(v),
             "state": "AVAILABLE" if served and served.version == v
             else "END_OF_LIFE"} for v in versions]}
        draft = served.draft if served is not None else None
        if draft is not None:
            out["speculative_draft"] = draft.ref
        return out

    def start_polling(self) -> None:
        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.refresh()
                except Exception:  # noqa: BLE001
                    log.exception("model refresh failed")

        threading.Thread(target=loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for eng in engines:
            eng.close()
        if self.lockstep is not None:
            self.lockstep.stop()


class ModelServer:
    def __init__(self, base_path: str, *, port: int = 8500,
                 max_batch_size: int = 8, poll_interval_s: float = 10.0,
                 pin_version: Optional[int] = None, warmup: bool = False,
                 decode_slots: int = 0, decode_steps_per_sync: int = 1,
                 device=None, decode_mesh=None) -> None:
        buckets = tuple(b for b in _PAD_BUCKETS if b <= max_batch_size)
        self.repo = ModelRepository(
            base_path, decode_slots=decode_slots,
            decode_steps_per_sync=decode_steps_per_sync,
            pin_version=pin_version, poll_interval_s=poll_interval_s,
            warmup_batches=buckets if warmup else (), device=device,
            decode_mesh=decode_mesh)
        self.port = port
        self.max_batch_size = max_batch_size
        self._httpd: Optional[ThreadingHTTPServer] = None

    def handle_predict(self, name: str, version: Optional[int],
                       body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """The reference's ``handle_predict``: its checks, status codes
        and texts. Shapes and dtypes are checked before the launch
        (:meth:`LoadedModel.input_error`), so a client error answers 400
        and an execution fault 500."""
        model = self.repo.get(name, version)
        if model is None:
            return 404, {"error": f"model {name!r}"
                         f"{f' version {version}' if version else ''} "
                         "not found"}
        instances = body.get("instances")
        if instances is None:
            return 400, {"error": "request body must contain 'instances'"}
        try:
            arr = np.asarray(instances)
            if arr.ndim == 0 or arr.dtype == object:
                raise ValueError("instances must be a non-empty array")
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
        except Exception as e:  # noqa: BLE001 — any parse failure is a 400
            return 400, {"error": f"bad instances: {e}"}
        if arr.shape[0] > self.max_batch_size:
            return 400, {"error": f"batch {arr.shape[0]} exceeds max "
                                  f"{self.max_batch_size}"}
        bad = model.input_error(arr.shape, arr.dtype)
        if bad is not None:
            return 400, {"error": bad}
        t0 = time.perf_counter()
        padded, n = _pad_batch(arr, self.max_batch_size)
        try:
            out = model.predict(padded)[:n]
        except (TypeError, ValueError) as e:
            # host-side conversion of the batch (an unsupported dtype)
            return 400, {"error": f"predict failed: {type(e).__name__}: "
                                  f"{e}"}
        except Exception as e:  # noqa: BLE001 — an execution fault
            return 500, {"error": f"predict failed: {type(e).__name__}: "
                                  f"{e}"}
        dt = time.perf_counter() - t0
        _requests.inc(model=name)
        _latency.set(dt, model=name)
        return 200, {"predictions": out.tolist(),
                     "model_version": str(model.version)}

    def handle_generate(self, name: str, version: Optional[int],
                        body: Dict[str, Any], stream: bool = False
                        ) -> Tuple[int, Dict[str, Any]]:
        model = self.repo.get(name, version)
        if model is None:
            return 404, {"error": f"model {name!r} not found"}
        return run_generate(model, body, self.max_batch_size,
                            engine=self.repo.engine_for(name, model),
                            model_name=name, stream=stream)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.rstrip("/")
                if path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif path == "/metrics":
                    body, ctype = exposition(DEFAULT_REGISTRY,
                                             dict(self.headers))
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/v1/models":
                    self._send(200, {"models": server.repo.model_names()})
                elif path.startswith("/v1/models/"):
                    status = server.repo.status(path[len("/v1/models/"):])
                    if status is None:
                        self._send(404, {"error": "model not found"})
                    else:
                        self._send(200, status)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid JSON"})
                    return
                path = self.path
                verb = next((s for s in (":predict", ":generate")
                             if path.endswith(s)), None)
                if verb is None or not path.startswith("/v1/models/"):
                    self._send(404, {"error": "not found"})
                    return
                target = path[len("/v1/models/"):-len(verb)]
                version: Optional[int] = None
                name = target
                if "/versions/" in target:
                    name, _, v = target.partition("/versions/")
                    if not v.isdigit():
                        self._send(400, {"error": f"bad version {v!r}"})
                        return
                    version = int(v)
                stream = verb == ":generate" and bool(body.get("stream"))
                attrs: Dict[str, Any] = {"model": name}
                if stream:
                    attrs["stream"] = True
                # continue the caller's trace (or start one): engine
                # submits made inside parent their spans on this one
                with TRACER.span("serving" + verb.replace(":", "."),
                                 remote=extract(dict(self.headers)),
                                 attrs=attrs) as sp:
                    if verb == ":predict":
                        code, payload = server.handle_predict(name, version,
                                                              body)
                    else:
                        code, payload = server.handle_generate(
                            name, version, body, stream=stream)
                    sp.attrs["http.status"] = code
                if code != 200 or not stream:
                    self._send(code, payload)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonlines")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    line = json.dumps(obj).encode() + b"\n"
                    self.wfile.write(f"{len(line):x}\r\n".encode() + line
                                     + b"\r\n")
                    self.wfile.flush()

                try:
                    for toks in payload["token_stream"]:
                        chunk({"tokens": toks})
                    chunk({"done": True,
                           "model_version": payload["model_version"]})
                except Exception as e:  # noqa: BLE001
                    chunk({"error": f"{type(e).__name__}: {e}"})
                self.wfile.write(b"0\r\n\r\n")

            def log_message(self, *a):
                pass

        return Handler

    def start(self) -> int:
        """Serve on a daemon thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        self.repo.start_polling()
        return self.port

    def stop(self) -> None:
        self.repo.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


def parse_pin_version(raw: Optional[str]) -> Optional[int]:
    """``"3"`` or ``"v3"`` → 3; empty → None."""
    if not raw:
        return None
    digits = raw[1:] if raw[:1] in ("v", "V") else raw
    if not digits.isdigit():
        raise ValueError(f"KFTPU_MODEL_VERSION must be N or vN, got {raw!r}")
    return int(digits)


class MeshFollower:
    """A follower rank of a lockstep serving mesh: the split LMs, their
    drafts and their engines that rank 0's plans name, with no front end
    (``serving/lockstep.py``). :meth:`run` runs one plan. Its engines
    keep their spans and request records to themselves: the ledger and
    the ``engine.*`` spans are rank 0's. With ``record``, each engine
    logs its sampled tokens, kept by key in :attr:`token_logs` when it
    closes."""

    def __init__(self, base_path: str, mesh, *, device=None,
                 record: bool = False) -> None:
        self.base_path = base_path
        self.mesh = mesh
        self.device = resolve_device(device)
        self.record = record
        self.models: Dict[Tuple[str, int], LoadedModel] = {}
        self.drafts: Dict[str, DraftPair] = {}
        self.engines: Dict[Tuple[str, int], DecodeEngine] = {}
        self.token_logs: Dict[Tuple[str, int], list] = {}

    def _draft(self, ref: str) -> DraftPair:
        if ref not in self.drafts:
            name, _, version = ref.rpartition("@")
            d = load_version(os.path.join(self.base_path, name),
                             int(version), device=self.device)
            self.drafts[ref] = DraftPair(config=d.lm_config,
                                         params=d.lm_params, ref=ref)
        return self.drafts[ref]

    def run(self, op: str, args: Tuple[Any, ...]) -> None:
        if op == "noop":
            return
        name, version, *rest = args
        key = (name, version)
        if op == "load":
            self.models[key] = load_version(
                os.path.join(self.base_path, name), version,
                device=self.device, mesh=self.mesh)
        elif op == "drop":
            self.models.pop(key, None)
        elif op == "model":
            what, *a = rest
            model = self.models[key]
            if what == "generate":
                prompt, lens, max_new, temp, seed, greedy, tk, tp, filt = a
                model.generate(prompt, lens, max_new, temp, seed,
                               greedy=greedy, top_k=tk, top_p=tp,
                               filtered=filt)
            elif what == "predict":
                model.predict(a[0])
            elif what == "speculate":
                model.speculate(self._draft(a[0]), *a[1:])
            else:
                raise ValueError(f"unknown model program {what!r}")
        elif op == "new_engine":
            settings, warm = rest
            model = self.models[key]
            eng = DecodeEngine(
                model.lm_config, model.lm_params, **dict(settings),
                device=self.device, mesh=self.mesh, autostart=False,
                tracer=Tracer(collector=SpanCollector()),
                request_ledger=reqobs.RequestLedger())
            eng.token_log = [] if self.record else None
            if warm:
                eng._precompile_steps()
            self.engines[key] = eng
        elif op == "engine":
            what, *a = rest
            if what == "close":
                eng = self.engines.pop(key)
                self.token_logs.setdefault(key, []).extend(
                    eng.token_log or ())
                eng.close()
            else:
                self.engines[key].follow(what, a)
        else:
            raise ValueError(f"unknown lockstep plan {op!r}")


def serve_follower(base_path: str, mesh, *, device=None,
                   record: bool = False) -> MeshFollower:
    """A follower rank's serve loop: run rank 0's plans on this rank's
    shard until it sends ``stop``; returns the :class:`MeshFollower`. A
    plan that fails, or none within the channel's timeout, raises (the
    rank exits with an error and the leader's next plan fails)."""
    ls = Lockstep(device=device)
    follower = MeshFollower(base_path, mesh, device=device, record=record)
    while True:
        op, args = ls.recv()
        if op == "stop":
            return follower
        follower.run(op, args)


def serving_mesh_from_env(environ=None, *, device=None):
    """``(mesh, device)`` from ``KFTPU_SERVING_MESH`` (e.g. ``"tp=2"`` or
    ``"dp=2,tp=2"``) and the operator's env contract
    (``parallel/distributed.py:from_env``): the process group up (NCCL
    on the card, gloo on the CPU), one card a rank. ``(None, device)``,
    ``device`` as given, when the variable is unset."""
    from kubeflow_tpu_torch.parallel import distributed as dist

    env = os.environ if environ is None else environ
    raw = env.get("KFTPU_SERVING_MESH")
    if not raw:
        return None, device
    dev = resolve_device(device)
    penv = dist.from_env(env)
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           penv.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.initialize(penv, backend="nccl" if dev.type == "cuda" else "gloo")
    return parse_serving_mesh(raw, device_type=dev.type), dev


def main(device=None) -> None:
    """Serve from the environment (the reference's knobs) on CUDA unless
    ``device="cpu"``: REST on ``KFTPU_REST_PORT`` and gRPC on
    ``KFTPU_GRPC_PORT``. With ``KFTPU_SERVING_MESH`` every rank of the
    env contract joins the mesh: rank 0 serves, the others follow its
    plans (:func:`serve_follower`), and rank 0 exits with an error
    when a follower is gone."""
    logging.basicConfig(level=logging.INFO)
    base = os.environ.get("KFTPU_MODEL_BASE_PATH", "/models")
    mesh, device = serving_mesh_from_env(device=device)
    if mesh is not None and tdist.get_rank() != 0:
        serve_follower(base, mesh, device=device)
        return
    max_batch = int(os.environ.get("KFTPU_MAX_BATCH_SIZE", "8"))
    grpc_port = int(os.environ.get("KFTPU_GRPC_PORT", "9000"))
    server = ModelServer(
        base, port=int(os.environ.get("KFTPU_REST_PORT", "8500")),
        max_batch_size=max_batch,
        pin_version=parse_pin_version(os.environ.get("KFTPU_MODEL_VERSION")),
        decode_slots=int(os.environ.get("KFTPU_DECODE_SLOTS", "8")),
        decode_steps_per_sync=int(
            os.environ.get("KFTPU_DECODE_STEPS_PER_SYNC", "4")),
        device=device, decode_mesh=mesh)
    server.start()
    grpc_server = None  # keep the reference: a collected grpc.Server stops
    if grpc_port:
        try:
            from kubeflow_tpu_torch.serving.grpc_server import serve_grpc

            grpc_server, _ = serve_grpc(server.repo, grpc_port,
                                        max_batch_size=max_batch)
        except ImportError as e:
            log.warning("gRPC disabled (grpc not importable: %s); "
                        "serving REST only", e)
    ls = server.repo.lockstep
    try:
        while ls is None or not ls.broken.is_set():
            time.sleep(3600 if ls is None else 1.0)
    except KeyboardInterrupt:
        server.stop()
        if grpc_server is not None:
            grpc_server.stop(grace=1.0)
        return
    log.error("a follower rank of the serving mesh is gone; exiting")
    sys.exit(1)


if __name__ == "__main__":
    main()
