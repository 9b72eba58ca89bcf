"""gRPC prediction service over the REST server's model repository.

PyTorch port of ``kubeflow_tpu/serving/grpc_server.py``: TF-Serving's
primary surface (gRPC :9000 beside REST :8500), with the reference's
service name, messages (``predict_pb2.py`` is a byte-for-byte copy of
the reference's, so one descriptor serves both packages and their
clients interoperate), status codes and counters.

- ``Predict``: a binary ``Tensor`` in (raw row-major bytes, a numpy
  dtype name, a shape), a batch in ``[1, max_batch_size]`` of the
  export's ``input_shape``, integer inputs cast to f32 (uint8 pixels),
  the batch padded to a bucket and sliced back, f32 logits out;
- ``Generate`` / ``GenerateStream``: the REST ``:generate`` core
  (``server.py:run_generate``) over an int32 prompt tensor; the stream
  yields one ``GenerateChunk`` per decode position, then a ``done``
  chunk; ``speculative`` routes through the paired draft;
- ``GetModelStatus`` and ``ListModels``.

Each of ``Predict``, ``Generate`` and ``GenerateStream`` opens a
``serving.grpc.*`` span parented on the ``traceparent`` carried in the
invocation metadata.

The transport-free core is importable without ``grpc`` or
``protobuf``: the tensor codec works on ``(data, dtype, shape)``
(:func:`decode_array`, :func:`encode_array`) and :func:`predict_tensor`
runs ``Predict``'s decode, checks, cast, padding, forward and encode,
raising :class:`RpcFault` with the status code's name. ``grpc`` and
``predict_pb2`` are imported only by the functions that need them.
bf16 tensors travel as ``"bfloat16"``, decoded to a torch bf16 tensor
(numpy has no bf16) with the bytes of the reference's ``ml_dtypes``
arrays.
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from kubeflow_tpu_torch.obs.trace import TRACER, extract, grpc_metadata
from kubeflow_tpu_torch.serving.engine import EngineClosed
from kubeflow_tpu_torch.serving.server import (
    ModelRepository,
    _pad_batch,
    run_generate,
)
from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY

log = logging.getLogger(__name__)

SERVICE_NAME = "kubeflow_tpu.serving.PredictionService"
BFLOAT16 = "bfloat16"

_grpc_requests = DEFAULT_REGISTRY.counter(
    "kftpu_serving_grpc_requests_total", "gRPC predict requests")
_grpc_generates = DEFAULT_REGISTRY.counter(
    "kftpu_serving_grpc_generate_requests_total", "gRPC generate requests")


class RpcFault(Exception):
    """An RPC's failure: ``code`` names a ``grpc.StatusCode``."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code
        self.message = message


# -- the tensor codec ---------------------------------------------------------


def decode_array(data: bytes, dtype: str, shape: Sequence[int]):
    """Raw row-major bytes → a numpy array of ``dtype`` (default
    float32) and ``shape``, or a torch bf16 tensor for ``"bfloat16"``.
    A byte count that is no multiple of the element size, or a shape
    whose size is not the element count, raises ValueError; an unknown
    dtype name raises TypeError (both the reference's)."""
    name = dtype or "float32"
    bf16 = name == BFLOAT16
    # bf16 as its 16-bit patterns: numpy has no bf16
    arr = np.frombuffer(data, dtype=np.int16 if bf16 else np.dtype(name))
    shape = tuple(shape)
    if int(np.prod(shape, dtype=np.int64)) != arr.size:
        raise ValueError(f"shape {shape} does not match {arr.size} elements")
    arr = arr.reshape(shape)
    if bf16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr


def encode_array(arr) -> Tuple[bytes, str, list]:
    """A numpy array or a torch tensor → ``(data, dtype name, shape)``;
    bf16 as ``"bfloat16"``, two bytes an element."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), BFLOAT16,
                    list(t.shape))
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr.tobytes(), arr.dtype.name, list(arr.shape)


def tensor_to_array(t):
    """A ``predict_pb2.Tensor`` → :func:`decode_array`'s result."""
    return decode_array(t.data, t.dtype, t.shape)


def array_to_tensor(arr):
    """A numpy array or torch tensor → a ``predict_pb2.Tensor``."""
    from kubeflow_tpu_torch.serving import predict_pb2 as pb

    data, dtype, shape = encode_array(arr)
    return pb.Tensor(shape=shape, dtype=dtype, data=data)


# -- Predict's core, without the transport ------------------------------------


def predict_inputs(model, arr, max_batch_size: int):
    """``Predict``'s checks in the reference's order, the integer → f32
    cast and the batch padding: ``(padded batch, n)``. Raises
    :class:`RpcFault` ``INVALID_ARGUMENT`` for a batch outside ``[1,
    max_batch_size]``, a shape other than the export's ``input_shape``,
    or a batch the model cannot take (``LoadedModel.input_error``: the
    reference's JAX forward raises TypeError or ValueError there, torch
    would raise RuntimeError, an execution fault's type)."""
    if arr.ndim == 0 or arr.shape[0] > max_batch_size:
        raise RpcFault("INVALID_ARGUMENT",
                       f"batch must be in [1, {max_batch_size}]")
    shape = tuple(arr.shape)
    if model.input_shape and shape[1:] != tuple(model.input_shape):
        raise RpcFault("INVALID_ARGUMENT",
                       f"instance shape {shape[1:]} != model input "
                       f"{tuple(model.input_shape)}")
    if isinstance(arr, torch.Tensor):
        # bf16 → f32 is exact, and every kind casts its input to its
        # own compute dtype (a float token id is refused below either
        # way)
        arr = arr.float().numpy()
    elif np.issubdtype(arr.dtype, np.integer):
        # image clients send uint8 pixels (4x less wire than f32)
        arr = arr.astype(np.float32)
    bad = model.input_error(shape, arr.dtype)
    if bad is not None:
        raise RpcFault("INVALID_ARGUMENT", f"predict failed: {bad}")
    return _pad_batch(arr, max_batch_size)


def run_predict(model, padded, n: int) -> np.ndarray:
    """``LoadedModel.predict`` on the padded batch, sliced to ``n`` rows:
    f32 numpy. TypeError or ValueError (host-side conversion of the
    batch) is ``INVALID_ARGUMENT``, any other fault ``INTERNAL``."""
    try:
        return model.predict(padded)[:n]
    except (TypeError, ValueError) as e:
        raise RpcFault("INVALID_ARGUMENT",
                       f"predict failed: {type(e).__name__}: {e}") from e
    except Exception as e:  # noqa: BLE001 — an execution fault
        raise RpcFault("INTERNAL",
                       f"predict failed: {type(e).__name__}: {e}") from e


def predict_tensor(model, data: bytes, dtype: str, shape: Sequence[int],
                   max_batch_size: int) -> Tuple[bytes, str, list]:
    """``Predict`` from the request tensor's fields to the response
    tensor's: decode, :func:`predict_inputs`, :func:`run_predict`,
    encode. Raises :class:`RpcFault`."""
    try:
        arr = decode_array(data, dtype, shape)
    except (ValueError, TypeError) as e:
        # TypeError: np.dtype on a garbage dtype string
        raise RpcFault("INVALID_ARGUMENT", str(e)) from e
    padded, n = predict_inputs(model, arr, max_batch_size)
    return encode_array(run_predict(model, padded, n))


# -- the service --------------------------------------------------------------


def _abort(context, code: str, message: str):
    import grpc

    context.abort(getattr(grpc.StatusCode, code), message)


class PredictionServicer:
    """The five RPCs over the shared :class:`ModelRepository`."""

    def __init__(self, repo: ModelRepository, *,
                 max_batch_size: int = 8) -> None:
        self.repo = repo
        self.max_batch_size = max_batch_size

    def Predict(self, request, context):  # noqa: N802
        from kubeflow_tpu_torch.serving import predict_pb2 as pb

        # traceparent rides invocation metadata (the gRPC twin of the
        # HTTP header); the same W3C extract handles both carriers
        with TRACER.span("serving.grpc.predict",
                         remote=extract(context.invocation_metadata()),
                         attrs={"model": request.model_name}):
            model = self.repo.get(request.model_name,
                                  request.version or None)
            if model is None:
                _abort(context, "NOT_FOUND",
                       f"model {request.model_name!r} not found")
            t = request.inputs
            try:
                data, dtype, shape = predict_tensor(
                    model, t.data, t.dtype, t.shape, self.max_batch_size)
            except RpcFault as e:
                _abort(context, e.code, e.message)
            _grpc_requests.inc(model=request.model_name)
            return pb.PredictResponse(
                outputs=pb.Tensor(shape=shape, dtype=dtype, data=data),
                model_version=model.version)

    def _generate_inputs(self, request, context):
        """Generate/GenerateStream's request decoding: the model and the
        :func:`run_generate` body. Aborts the RPC on bad input."""
        model = self.repo.get(request.model_name, request.version or None)
        if model is None:
            _abort(context, "NOT_FOUND",
                   f"model {request.model_name!r} not found")
        try:
            prompt = tensor_to_array(request.prompt)
        except (ValueError, TypeError) as e:
            _abort(context, "INVALID_ARGUMENT", str(e))
        body = {
            "prompt_tokens": prompt,
            "max_new_tokens": request.max_new_tokens or 16,
            "temperature": request.temperature,
            "seed": request.seed,
            "true_len": request.true_len,
            "top_k": request.top_k,
            # proto3's unset 0.0 means no filter
            "top_p": request.top_p or 1.0,
            "prefix_len": request.prefix_len,
        }
        if request.HasField("eos_id"):
            body["eos_id"] = request.eos_id
        if request.speculative:
            body["speculative"] = True
            if request.draft_len:
                body["draft_len"] = request.draft_len
        return model, body

    def Generate(self, request, context):  # noqa: N802
        """Generation over binary prompt tensors: the REST
        ``:generate``'s core (``server.py:run_generate``)."""
        from kubeflow_tpu_torch.serving import predict_pb2 as pb

        with TRACER.span("serving.grpc.generate",
                         remote=extract(context.invocation_metadata()),
                         attrs={"model": request.model_name}):
            model, body = self._generate_inputs(request, context)
            code, payload = run_generate(
                model, body, self.max_batch_size,
                model_name=request.model_name,
                engine=self.repo.engine_for(request.model_name, model))
        if code != 200:
            _abort(context, _status_for(code),
                   payload.get("error", "generate failed"))
        _grpc_generates.inc(model=request.model_name)
        resp = pb.GenerateResponse(
            tokens=array_to_tensor(np.asarray(payload["tokens"], np.int32)),
            model_version=int(payload["model_version"]))
        spec = payload.get("speculative")
        if spec:
            resp.speculative.MergeFrom(pb.SpeculativeStats(
                draft=spec["draft"], draft_len=spec["draft_len"],
                rounds=spec["rounds"], draft_tokens=spec["draft_tokens"],
                accepted=spec["accepted"],
                acceptance_rate=spec["acceptance_rate"]))
        return resp

    def GenerateStream(self, request, context):  # noqa: N802
        """One ``GenerateChunk`` per decode position (a row of tokens
        across the batch) as the core yields it, then a ``done`` chunk."""
        from kubeflow_tpu_torch.serving import predict_pb2 as pb

        # the span covers setup and the engine submit (where the
        # request's trace context is captured); the stream outlives it
        with TRACER.span("serving.grpc.generate_stream",
                         remote=extract(context.invocation_metadata()),
                         attrs={"model": request.model_name}):
            model, body = self._generate_inputs(request, context)
            code, payload = run_generate(
                model, body, self.max_batch_size,
                model_name=request.model_name, stream=True,
                engine=self.repo.engine_for(request.model_name, model))
        if code != 200:
            _abort(context, _status_for(code),
                   payload.get("error", "generate failed"))
        _grpc_generates.inc(model=request.model_name)
        version = int(payload["model_version"])
        try:
            for step_tokens in payload["token_stream"]:
                yield pb.GenerateChunk(tokens=step_tokens,
                                       model_version=version)
        except EngineClosed as e:
            # rollover mid-stream: retryable, as before the stream
            _abort(context, "UNAVAILABLE", f"generate failed: {e}")
        except Exception as e:  # noqa: BLE001 — a mid-stream engine fault
            _abort(context, "INTERNAL",
                   f"generate failed: {type(e).__name__}: {e}")
        yield pb.GenerateChunk(done=True, model_version=version)

    def GetModelStatus(self, request, context):  # noqa: N802
        from kubeflow_tpu_torch.serving import predict_pb2 as pb

        status = self.repo.status(request.model_name)
        if status is None:
            _abort(context, "NOT_FOUND",
                   f"model {request.model_name!r} not found")
        return pb.ModelStatusResponse(model_version_status=[
            pb.ModelVersionStatus(version=int(s["version"]), state=s["state"])
            for s in status["model_version_status"]])

    def ListModels(self, request, context):  # noqa: N802
        from kubeflow_tpu_torch.serving import predict_pb2 as pb

        return pb.ListModelsResponse(models=self.repo.model_names())


def _status_for(code: int) -> str:
    """The generate core's HTTP-style status → a ``grpc.StatusCode``
    name: 4xx the request was bad, 503 a retryable rollover, any other
    5xx a model or runtime fault."""
    if code < 500:
        return "INVALID_ARGUMENT"
    if code == 503:
        return "UNAVAILABLE"
    return "INTERNAL"


def _handlers(servicer: PredictionServicer):
    import grpc

    from kubeflow_tpu_torch.serving import predict_pb2 as pb

    def unary(fn, req, resp):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString)

    method_handlers = {
        "Predict": unary(servicer.Predict, pb.PredictRequest,
                         pb.PredictResponse),
        "GetModelStatus": unary(servicer.GetModelStatus,
                                pb.ModelStatusRequest,
                                pb.ModelStatusResponse),
        "ListModels": unary(servicer.ListModels, pb.ListModelsRequest,
                            pb.ListModelsResponse),
        "Generate": unary(servicer.Generate, pb.GenerateRequest,
                          pb.GenerateResponse),
        "GenerateStream": grpc.unary_stream_rpc_method_handler(
            servicer.GenerateStream,
            request_deserializer=pb.GenerateRequest.FromString,
            response_serializer=pb.GenerateChunk.SerializeToString),
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME,
                                                method_handlers)


# a batch-8 224x224x3 f32 tensor is ~4.8 MB, over gRPC's 4 MB default;
# both directions are raised alike for image workloads
MAX_MESSAGE_BYTES = 64 * 1024 * 1024

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]


def serve_grpc(repo: ModelRepository, port: int = 9000, *,
               max_batch_size: int = 8, max_workers: int = 8):
    """Start the gRPC server on a thread pool; returns ``(server, bound
    port)``. Keep the server referenced: a collected ``grpc.Server``
    stops."""
    import grpc

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=_CHANNEL_OPTIONS)
    server.add_generic_rpc_handlers(
        (_handlers(PredictionServicer(repo, max_batch_size=max_batch_size)),))
    bound = server.add_insecure_port(f"0.0.0.0:{port}")
    server.start()
    log.info("gRPC prediction service on :%d", bound)
    return server, bound


class PredictClient:
    """A typed client over a gRPC channel (no generated stubs)."""

    def __init__(self, target: str) -> None:
        import grpc

        from kubeflow_tpu_torch.serving import predict_pb2 as pb

        self._pb = pb
        self.channel = grpc.insecure_channel(target,
                                             options=_CHANNEL_OPTIONS)
        base = f"/{SERVICE_NAME}/"

        def unary(method, req, resp):
            return self.channel.unary_unary(
                base + method, request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString)

        self._predict = unary("Predict", pb.PredictRequest,
                              pb.PredictResponse)
        self._status = unary("GetModelStatus", pb.ModelStatusRequest,
                             pb.ModelStatusResponse)
        self._list = unary("ListModels", pb.ListModelsRequest,
                           pb.ListModelsResponse)
        self._generate = unary("Generate", pb.GenerateRequest,
                               pb.GenerateResponse)
        self._generate_stream = self.channel.unary_stream(
            base + "GenerateStream",
            request_serializer=pb.GenerateRequest.SerializeToString,
            response_deserializer=pb.GenerateChunk.FromString)

    def predict(self, model_name: str, inputs, version: Optional[int] = None,
                timeout: float = 120.0) -> Tuple[Any, int]:
        inputs = inputs if isinstance(inputs, torch.Tensor) else \
            np.asarray(inputs)
        resp = self._predict(self._pb.PredictRequest(
            model_name=model_name, version=version or 0,
            inputs=array_to_tensor(inputs)), timeout=timeout,
            metadata=grpc_metadata())
        return tensor_to_array(resp.outputs), resp.model_version

    def _generate_request(self, model_name, prompt, *, max_new_tokens,
                          true_len, temperature, seed, top_k, top_p,
                          eos_id, version, prefix_len: int = 0):
        req = self._pb.GenerateRequest(
            model_name=model_name, version=version or 0,
            prompt=array_to_tensor(np.asarray(prompt, np.int32)),
            true_len=true_len, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed,
            top_k=top_k, top_p=top_p, prefix_len=prefix_len)
        if eos_id is not None:
            req.eos_id = eos_id
        return req

    def generate(self, model_name: str, prompt, *, max_new_tokens: int = 16,
                 true_len: int = 0, temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_id: Optional[int] = None, prefix_len: int = 0,
                 version: Optional[int] = None,
                 timeout: float = 300.0) -> Tuple[np.ndarray, int]:
        resp = self._generate(self._generate_request(
            model_name, prompt, max_new_tokens=max_new_tokens,
            true_len=true_len, temperature=temperature, seed=seed,
            top_k=top_k, top_p=top_p, eos_id=eos_id, version=version,
            prefix_len=prefix_len),
            timeout=timeout, metadata=grpc_metadata())
        return tensor_to_array(resp.tokens), resp.model_version

    def generate_speculative(self, model_name: str, prompt, *,
                             max_new_tokens: int = 16, draft_len: int = 0,
                             true_len: int = 0,
                             version: Optional[int] = None,
                             timeout: float = 300.0
                             ) -> Tuple[np.ndarray, int, dict]:
        """Greedy generation through the model's paired draft: ``(tokens,
        version, stats)``, ``stats`` the acceptance accounting (empty
        when the server sent none)."""
        req = self._generate_request(
            model_name, prompt, max_new_tokens=max_new_tokens,
            true_len=true_len, temperature=0.0, seed=0, top_k=0,
            top_p=1.0, eos_id=None, version=version)
        req.speculative = True
        if draft_len:
            req.draft_len = draft_len
        resp = self._generate(req, timeout=timeout,
                              metadata=grpc_metadata())
        stats: dict = {}
        if resp.HasField("speculative"):
            s = resp.speculative
            stats = {"draft": s.draft, "draft_len": s.draft_len,
                     "rounds": s.rounds, "draft_tokens": s.draft_tokens,
                     "accepted": s.accepted,
                     "acceptance_rate": round(s.acceptance_rate, 3)}
        return tensor_to_array(resp.tokens), resp.model_version, stats

    def generate_stream(self, model_name: str, prompt, *,
                        max_new_tokens: int = 16, true_len: int = 0,
                        temperature: float = 0.0, seed: int = 0,
                        top_k: int = 0, top_p: float = 1.0,
                        eos_id: Optional[int] = None, prefix_len: int = 0,
                        version: Optional[int] = None,
                        timeout: float = 300.0):
        """Yield ``(B,)`` int32 token arrays as decode steps complete."""
        for chunk in self._generate_stream(self._generate_request(
                model_name, prompt, max_new_tokens=max_new_tokens,
                true_len=true_len, temperature=temperature, seed=seed,
                top_k=top_k, top_p=top_p, eos_id=eos_id,
                version=version, prefix_len=prefix_len),
                timeout=timeout, metadata=grpc_metadata()):
            if chunk.done:
                return
            yield np.asarray(chunk.tokens, np.int32)

    def model_status(self, model_name: str, timeout: float = 30.0):
        resp = self._status(self._pb.ModelStatusRequest(
            model_name=model_name), timeout=timeout)
        return [(s.version, s.state) for s in resp.model_version_status]

    def list_models(self, timeout: float = 30.0):
        return list(self._list(self._pb.ListModelsRequest(),
                               timeout=timeout).models)

    def close(self) -> None:
        self.channel.close()
