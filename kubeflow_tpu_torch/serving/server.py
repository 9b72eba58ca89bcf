"""LM model server for the port: ``:generate`` through the decode engine.

PyTorch port of the generate half of ``kubeflow_tpu/serving/server.py``,
with the same request and response JSON:

- ``GET /v1/models``, ``GET /v1/models/<name>``, ``GET /metrics``,
  ``GET /healthz``;
- ``POST /v1/models/<name>[/versions/<v>]:generate`` with
  ``{"prompt_tokens": [[...], ...], "max_new_tokens", "temperature",
  "top_k", "top_p", "seed", "eos_id", "prefix_len", "true_len",
  "stream"}`` — each prompt row becomes one engine request sharing the
  decode batch; ``stream: true`` answers with JSON lines over chunked
  transfer, one ``{"tokens": [...]}`` per decode position.

Not in this slice (ROADMAP.md): ``:predict`` for the non-LM kinds,
speculative decoding, gRPC, the unary (engine-less) generate path,
tracing spans and the request ledger.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from kubeflow_tpu_torch.serving.engine import DecodeEngine, EngineClosed
from kubeflow_tpu_torch.serving.model_store import (
    LoadedModel,
    list_versions,
    load_version,
)
from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY
from kubeflow_tpu_torch.utils.device import resolve_device
from kubeflow_tpu_torch.utils.metrics import EXPOSITION_CONTENT_TYPE

log = logging.getLogger(__name__)

_gen_requests = DEFAULT_REGISTRY.counter(
    "kftpu_serving_generate_requests_total", "generate requests")
_gen_latency = DEFAULT_REGISTRY.gauge(
    "kftpu_serving_generate_last_latency_seconds", "last generate latency")


def _parse(model: LoadedModel, body: Dict[str, Any], max_batch_size: int):
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
    if arr.shape[0] > max_batch_size:
        return (400, {"error": f"batch {arr.shape[0]} exceeds max "
                               f"{max_batch_size}"}), None
    real = np.concatenate([arr[i, :n] for i, n in enumerate(row_lens)])
    if real.min() < 0 or real.max() >= model.vocab_size:
        return (400, {"error": f"token ids must be in [0, "
                               f"{model.vocab_size})"}), None
    over = [n for n in row_lens if n + max_new > model.max_seq_len]
    if over:
        return (400, {"error": f"prompt ({max(over)}) + max_new_tokens "
                               f"({max_new}) exceed the model context "
                               f"({model.max_seq_len})"}), None
    return None, dict(arr=arr, row_lens=row_lens, max_new=max_new,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, eos_id=eos_id, prefix_len=prefix_len)


def run_generate(model: LoadedModel, body: Dict[str, Any],
                 max_batch_size: int, *, engine: DecodeEngine,
                 model_name: str = "", stream: bool = False
                 ) -> Tuple[int, Dict[str, Any]]:
    """The generate core: validation, one engine request per prompt row
    (row ``i`` samples from ``seed + i``), then a dense ``(B, max_new)``
    token matrix — EOS-finished rows right-padded with their final token
    — or, with ``stream=True``, a ``token_stream`` iterator of per-step
    rows. Returns (http status, payload)."""
    err, a = _parse(model, body, max_batch_size)
    if err is not None:
        return err
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
                    yield [int(t) for t in lasts]
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


class ModelRepository:
    """Transformer models under ``<base>/<name>/<version>/``, newest
    served (or ``pin_version``), each version with one decode engine."""

    def __init__(self, base_path: str, *, decode_slots: int = 8,
                 decode_steps_per_sync: int = 1,
                 pin_version: Optional[int] = None,
                 poll_interval_s: float = 10.0, device=None) -> None:
        self.device = resolve_device(device)
        if decode_slots < 1:
            raise NotImplementedError(
                "the unary (engine-less) generate path is not ported yet; "
                "decode_slots must be >= 1 (ROADMAP.md Queue A)")
        self.base_path = base_path
        self.decode_slots = decode_slots
        self.decode_steps_per_sync = decode_steps_per_sync
        self.pin_version = pin_version
        self.poll_interval_s = poll_interval_s
        self._models: Dict[str, LoadedModel] = {}
        self._pinned: Dict[Tuple[str, int], LoadedModel] = {}
        self._engines: Dict[Tuple[str, int], DecodeEngine] = {}
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
                continue
            log.info("loading model %s version %d", name, latest)
            loaded = load_version(mdir, latest, device=self.device)
            with self._lock:
                self._models[name] = loaded
                stale = [k for k in self._engines
                         if k[0] == name and k[1] != latest
                         and k not in self._pinned]
                retired = [self._engines.pop(k) for k in stale]
            for eng in retired:
                eng.close()

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
        loaded = load_version(mdir, version, device=self.device)
        with self._lock:
            self._pinned[(name, version)] = loaded
        return loaded

    def engine_for(self, name: str, model: LoadedModel) -> DecodeEngine:
        """The version's engine, built on first use; a self-closed engine
        (failed step) is replaced by a fresh one."""
        key = (name, model.version)
        with self._engine_create_lock:
            with self._lock:
                eng = self._engines.get(key)
            if eng is not None and not eng.closed:
                return eng
            eng = DecodeEngine(model.lm_config, model.lm_params,
                               slots=self.decode_slots,
                               steps_per_sync=self.decode_steps_per_sync,
                               name=name, device=self.device)
            with self._lock:
                self._engines[key] = eng
            return eng

    def status(self, name: str) -> Optional[Dict[str, Any]]:
        versions = list_versions(os.path.join(self.base_path, name))
        if not versions:
            return None
        with self._lock:
            served = self._models.get(name)
        return {"model_version_status": [
            {"version": str(v),
             "state": "AVAILABLE" if served and served.version == v
             else "END_OF_LIFE"} for v in versions]}

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


class ModelServer:
    def __init__(self, base_path: str, *, port: int = 8500,
                 max_batch_size: int = 8, poll_interval_s: float = 10.0,
                 pin_version: Optional[int] = None, decode_slots: int = 8,
                 decode_steps_per_sync: int = 1, device=None) -> None:
        self.repo = ModelRepository(
            base_path, decode_slots=decode_slots,
            decode_steps_per_sync=decode_steps_per_sync,
            pin_version=pin_version, poll_interval_s=poll_interval_s,
            device=device)
        self.port = port
        self.max_batch_size = max_batch_size
        self._httpd: Optional[ThreadingHTTPServer] = None

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
                    body = DEFAULT_REGISTRY.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     EXPOSITION_CONTENT_TYPE)
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
                if not (path.startswith("/v1/models/")
                        and path.endswith(":generate")):
                    self._send(404, {"error": "not found"})
                    return
                target = path[len("/v1/models/"):-len(":generate")]
                version: Optional[int] = None
                name = target
                if "/versions/" in target:
                    name, _, v = target.partition("/versions/")
                    if not v.isdigit():
                        self._send(400, {"error": f"bad version {v!r}"})
                        return
                    version = int(v)
                stream = bool(body.get("stream"))
                code, payload = server.handle_generate(name, version, body,
                                                       stream=stream)
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


def main() -> None:
    """Serve from the environment (the reference's knobs) on CUDA.
    ``KFTPU_GRPC_PORT`` is not served by the port yet."""
    logging.basicConfig(level=logging.INFO)
    server = ModelServer(
        os.environ.get("KFTPU_MODEL_BASE_PATH", "/models"),
        port=int(os.environ.get("KFTPU_REST_PORT", "8500")),
        max_batch_size=int(os.environ.get("KFTPU_MAX_BATCH_SIZE", "8")),
        pin_version=parse_pin_version(os.environ.get("KFTPU_MODEL_VERSION")),
        decode_slots=int(os.environ.get("KFTPU_DECODE_SLOTS", "8")),
        decode_steps_per_sync=int(
            os.environ.get("KFTPU_DECODE_STEPS_PER_SYNC", "4")))
    server.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
