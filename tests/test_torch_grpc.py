"""The port's gRPC prediction service against the JAX package's, on the CPU.

- The tensor codec: round trips, bf16 bytes equal to the reference's
  ``ml_dtypes`` arrays (``ml_dtypes`` on the reference's side only), the
  reference's errors; ``predict_pb2.py`` is the reference's, descriptor
  and classes shared.
- The cases of ``tests/test_serving_grpc.py`` against the port's server.
- One store of exports written by the JAX package (``mnist``,
  ``resnet18_thin`` fused and unfused, a tiny ``bert``, a tiny
  ``transformer`` with a paired truncated draft, and the same LM without
  one) served by both packages' servers, each with gRPC beside REST on
  port 0: the reference's ``PredictClient`` against the port's server
  and the port's against the reference's. ``Predict`` within 1e-5,
  greedy ``Generate`` and ``GenerateStream`` token for token (the stream
  ends in ``done``), speculative stats equal, and every error case the
  reference's status code.
- The ``serving.grpc.*`` spans continue a forged ``traceparent`` from
  the invocation metadata, and both counters count.
- ``server.main`` serves REST and gRPC, and REST alone, with the
  reference's warning, where ``grpc`` cannot be imported.
"""

import builtins
import json
import logging
import os
import socket
import urllib.request

import grpc
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import MnistCnn as JaxMnist
from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import tiny_config as jax_tiny
from kubeflow_tpu.serving import grpc_server as ref
from kubeflow_tpu.serving import model_store as jax_store
from kubeflow_tpu.serving import predict_pb2 as ref_pb
from kubeflow_tpu.serving.server import ModelServer as JaxServer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.resnet import ResNetConfig
from kubeflow_tpu_torch.obs.trace import DEFAULT_COLLECTOR
from kubeflow_tpu_torch.serving import grpc_server as port
from kubeflow_tpu_torch.serving import predict_pb2 as port_pb
from kubeflow_tpu_torch.serving.server import ModelServer
from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY

from test_torch_resnet import randomized

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = (32, 32, 3)
# resnet18_thin's widths (stages (1, 1), width 16, f32, conv stem)
THIN = dict(stage_sizes=[1, 1], num_classes=10, width=16, dtype="float32",
            bn_dtype="float32", stem="conv")
BERT = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq_len=32, dtype="float32", remat=False, scan_layers=False)
PROMPTS = np.array([[5, 11, 17, 2, 9], [9, 4, 33, 1, 7]], np.int32)


# -- the codec ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "int64",
                                   "float16", "bool"])
def test_codec_round_trips_as_the_reference(dtype):
    arr = (np.random.default_rng(0).standard_normal((2, 3, 4)) * 50).astype(
        dtype)
    data, name, shape = port.encode_array(arr)
    t = ref.array_to_tensor(arr)
    assert (data, name, shape) == (t.data, t.dtype, list(t.shape))
    for back in (port.decode_array(data, name, shape),
                 port.tensor_to_array(port.array_to_tensor(arr))):
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)


def test_bf16_wire_bytes_are_the_reference():
    """The same values as an ``ml_dtypes`` bf16 array (the reference's
    side) and a torch bf16 tensor (the port's): the same bytes, and each
    side decodes the other's tensor to the same values."""
    vals = np.random.default_rng(1).standard_normal((3, 5)).astype(
        np.float32)
    vals[0, :4] = [0.0, -0.0, np.inf, 1e-40]
    theirs = vals.astype(ml_dtypes.bfloat16)
    ours = torch.from_numpy(vals).to(torch.bfloat16)
    want = ref.array_to_tensor(theirs)
    got = port.array_to_tensor(ours)
    assert got.SerializeToString() == want.SerializeToString()
    assert (got.dtype, list(got.shape)) == ("bfloat16", [3, 5])
    back = port.tensor_to_array(want)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), ours.view(torch.int16))
    np.testing.assert_array_equal(
        ref.tensor_to_array(got).view(np.uint16), theirs.view(np.uint16))


@pytest.mark.parametrize("data,dtype,shape", [
    (np.zeros(6, np.float32).tobytes(), "float32", (4, 2)),
    (np.zeros(6, np.int16).tobytes(), "bfloat16", (7,)),
    (b"\x00" * 7, "float32", (7,)),
    (b"\x00" * 7, "bfloat16", (7,)),
    (b"\x00" * 8, "not_a_dtype", (2,)),
], ids=["shape", "bf16_shape", "bytes", "bf16_bytes", "dtype"])
def test_codec_errors_are_the_reference(data, dtype, shape):
    t = ref_pb.Tensor(data=data, dtype=dtype, shape=list(shape))
    with pytest.raises((ValueError, TypeError)) as want:
        ref.tensor_to_array(t)
    with pytest.raises((ValueError, TypeError)) as got:
        port.decode_array(data, dtype, shape)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def _read(package, name):
    with open(os.path.join(REPO, package, "serving", name)) as f:
        return f.read()


def _schema(proto):
    """A .proto's text without its comments and blank lines."""
    lines = (line.split("//")[0].rstrip() for line in proto.splitlines())
    return [line for line in lines if line]


def test_proto_is_the_reference_descriptor():
    """``predict_pb2.py`` is the reference's byte for byte and
    ``predict.proto`` its schema line for line: one descriptor in
    protobuf's pool and one set of message classes for both packages,
    and the reference's method paths."""
    assert (_read("kubeflow_tpu_torch", "predict_pb2.py")
            == _read("kubeflow_tpu", "predict_pb2.py"))
    assert (_schema(_read("kubeflow_tpu_torch", "predict.proto"))
            == _schema(_read("kubeflow_tpu", "predict.proto")))
    assert (port_pb.DESCRIPTOR.serialized_pb
            == ref_pb.DESCRIPTOR.serialized_pb)
    assert port_pb.Tensor.DESCRIPTOR is ref_pb.Tensor.DESCRIPTOR
    assert port.SERVICE_NAME == ref.SERVICE_NAME
    assert port.MAX_MESSAGE_BYTES == ref.MAX_MESSAGE_BYTES == 64 * 2 ** 20


# -- one store, both servers --------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_store(root):
    """Exports written by the JAX package, from numpy-seeded weights."""
    from kubeflow_tpu.train.distill import truncate_draft

    mnist = JaxMnist().init(jax.random.key(0),
                            jnp.zeros((1, 28, 28, 1)))["params"]
    jax_store.export_model(os.path.join(root, "mnist"), "mnist", mnist)
    pc = ResNetConfig(**{**THIN, "stage_sizes": (1, 1)}, fused_bn_conv=True)
    variables = randomized(convert.random_resnet_params(pc, 0), 1)
    for name, fused, v in (("thin", True, variables),
                           ("thin-u", False,
                            convert.unfuse_bn_conv(variables))):
        jax_store.export_model(os.path.join(root, name), "resnet", v,
                               config=dict(THIN, fused_bn_conv=fused),
                               input_shape=IMAGE)
    jax_store.export_model(
        os.path.join(root, "bert"), "bert",
        convert.unflatten(convert.random_bert_params(BertConfig(**BERT), 3)),
        config=BERT)
    jc = jax_tiny(max_seq_len=48)
    params = JaxTransformer(jc).init(jax.random.key(0), PROMPTS)["params"]
    lm_config = jax_store.transformer_export_config(jc)
    for name in ("lm", "lm-solo"):
        jax_store.export_model(os.path.join(root, name), "transformer",
                               params, config=lm_config)
    dcfg, dparams = truncate_draft(jc, params, 1)
    jax_store.export_model(
        os.path.join(root, "lm-draft"), "transformer", dparams,
        config=jax_store.transformer_export_config(dcfg), draft_of="lm@1")


class Stack:
    """One package's REST server and gRPC service over ``root``, and
    both packages' clients on its gRPC port."""

    def __init__(self, which, root):
        self.which = which
        if which == "port":
            self.server = ModelServer(root, port=0, poll_interval_s=3600,
                                      device="cpu")
            serve = port.serve_grpc
        else:
            self.server = JaxServer(root, port=0, poll_interval_s=3600)
            serve = ref.serve_grpc
        self.rest_port = self.server.start()
        self.grpc, self.grpc_port = serve(self.server.repo, 0)
        target = f"127.0.0.1:{self.grpc_port}"
        self.clients = {"port": port.PredictClient(target),
                        "ref": ref.PredictClient(target)}

    def close(self):
        for c in self.clients.values():
            c.close()
        self.grpc.stop(grace=None)
        self.server.stop()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grpc-store"))
    _write_store(root)
    both = {w: Stack(w, root) for w in ("port", "ref")}
    yield both
    for s in both.values():
        s.close()


def _code(fn):
    """The status code of one call (OK when it returns)."""
    try:
        fn()
    except grpc.RpcError as e:
        return e.code()
    return grpc.StatusCode.OK


def _mnist_x(n, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28, 1)).astype(
        np.float32)


# -- tests/test_serving_grpc.py's cases, on the port's server -----------------


def test_grpc_and_rest_same_predict(stacks):
    s = stacks["port"]
    x = _mnist_x(3)
    req = urllib.request.Request(
        f"http://127.0.0.1:{s.rest_port}/v1/models/mnist:predict",
        data=json.dumps({"instances": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        rest = json.loads(resp.read())
    out, version = s.clients["port"].predict("mnist", x)
    assert version == 1 and out.dtype == np.float32
    np.testing.assert_allclose(out, np.array(rest["predictions"]), atol=1e-5)


@pytest.mark.parametrize("client", ["port", "ref"])
def test_grpc_model_status_and_list(stacks, client):
    got = stacks["port"].clients[client]
    want = stacks["ref"].clients[client]
    assert got.list_models() == want.list_models() == [
        "bert", "lm", "lm-draft", "lm-solo", "mnist", "thin", "thin-u"]
    assert got.model_status("mnist") == want.model_status("mnist") == [
        (1, "AVAILABLE")]


def test_grpc_unknown_model(stacks):
    client = stacks["port"].clients["port"]
    with pytest.raises(grpc.RpcError) as err:
        client.predict("nope", _mnist_x(1))
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as err:
        client.model_status("nope")
    assert err.value.code() == grpc.StatusCode.NOT_FOUND


@pytest.mark.parametrize("server", ["port", "ref"])
def test_grpc_accepts_image_sized_messages(stacks, server):
    """A batch-8 224x224x3 f32 request (~4.8 MB, past gRPC's 4 MB
    default) gets through in both directions of the channel options: a
    shape error, not RESOURCE_EXHAUSTED."""
    big = np.zeros((8, 224, 224, 3), np.float32)
    assert big.nbytes > 4 * 1024 * 1024
    with pytest.raises(grpc.RpcError) as err:
        stacks[server].clients["port"].predict("mnist", big)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "RESOURCE_EXHAUSTED" not in str(err.value)


def test_grpc_uint8_input_cast_to_float(stacks):
    client = stacks["port"].clients["ref"]
    u8 = (np.random.default_rng(0).random((2, 28, 28, 1)) * 255).astype(
        np.uint8)
    out_u8, _ = client.predict("mnist", u8)
    out_f32, _ = client.predict("mnist", u8.astype(np.float32))
    np.testing.assert_allclose(out_u8, out_f32, rtol=1e-5)
    # pixels to 255 make logits of ~70: 1e-5 of their scale
    want, _ = stacks["ref"].clients["port"].predict("mnist", u8)
    np.testing.assert_allclose(out_u8, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_grpc_oversized_batch(stacks):
    with pytest.raises(grpc.RpcError) as err:
        stacks["port"].clients["port"].predict(
            "mnist", np.zeros((99, 28, 28, 1), np.float32))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT


# -- cross-client parity ------------------------------------------------------


@pytest.mark.parametrize("name,x", [
    ("mnist", _mnist_x(3, 1)),
    ("thin", np.random.default_rng(2).standard_normal((2, *IMAGE)).astype(
        np.float32)),
    ("thin-u", np.random.default_rng(2).standard_normal((2, *IMAGE)).astype(
        np.float32)),
    ("thin", (np.random.default_rng(3).random((5, *IMAGE)) * 255).astype(
        np.uint8)),
    ("mnist", torch.from_numpy(_mnist_x(2, 4)).to(torch.bfloat16)),
], ids=["mnist", "resnet_fused", "resnet_unfused", "resnet_uint8_b5",
        "mnist_bf16"])
def test_predict_cross_clients(stacks, name, x):
    """The reference's client against the port's server and the port's
    client against the reference's: outputs within 1e-5 at f32 (of the
    logits' scale past 1) and the version; a bf16 request is sent by the
    port's client only (the reference's needs an ``ml_dtypes`` array)."""
    got, gv = stacks["port"].clients[
        "port" if isinstance(x, torch.Tensor) else "ref"].predict(name, x)
    want, wv = stacks["ref"].clients["port"].predict(name, x)
    assert gv == wv == 1
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (x.shape[0], 10)
    # 1e-5, of the logits' scale where uint8 pixels (to 255) make it ~100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(
        1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "top_k"])
def test_generate_and_stream_cross_clients(stacks, sampled):
    """Greedy ``Generate`` tokens identical across servers and clients;
    ``GenerateStream`` chunks the same rows, then a ``done`` chunk. A
    sampled request gives in-range tokens of the right shape (the two
    packages draw different bits)."""
    kw = dict(max_new_tokens=6, true_len=0)
    if sampled:
        kw.update(temperature=0.8, top_k=5, top_p=0.9, seed=3)
    got, gv = stacks["port"].clients["ref"].generate("lm", PROMPTS, **kw)
    want, wv = stacks["ref"].clients["port"].generate("lm", PROMPTS, **kw)
    assert gv == wv == 1 and got.dtype == np.int32
    assert got.shape == want.shape == (2, 6)
    if sampled:
        assert got.min() >= 0 and got.max() < 256
        return
    np.testing.assert_array_equal(got, want)
    chunks = {}
    for side, client in (("port", "ref"), ("ref", "port")):
        stub = stacks[side].clients[client]
        rows = list(stub.generate_stream("lm", PROMPTS, **kw))
        raw = list(stub._generate_stream(stub._generate_request(
            "lm", PROMPTS, max_new_tokens=6, true_len=0, temperature=0.0,
            seed=0, top_k=0, top_p=1.0, eos_id=None, version=None)))
        assert raw[-1].done and raw[-1].model_version == 1
        assert [list(c.tokens) for c in raw[:-1]] == [r.tolist()
                                                      for r in rows]
        chunks[side] = np.stack(rows, axis=1)
    np.testing.assert_array_equal(chunks["port"], chunks["ref"])
    np.testing.assert_array_equal(chunks["port"], want)


def test_speculative_stats_equal_the_reference(stacks):
    """The JAX-exported pair (``lm-draft`` declares ``draft_of: lm@1``):
    the port's tokens and acceptance stats are the reference's, and the
    tokens are the plain greedy ones."""
    got = stacks["port"].clients["ref"].generate_speculative(
        "lm", PROMPTS, max_new_tokens=7, draft_len=3)
    want = stacks["ref"].clients["port"].generate_speculative(
        "lm", PROMPTS, max_new_tokens=7, draft_len=3)
    plain, _ = stacks["port"].clients["port"].generate(
        "lm", PROMPTS, max_new_tokens=7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], plain)
    assert got[1] == want[1] == 1
    assert got[2] == want[2] and got[2]["draft"] == "lm-draft@1"
    assert got[2]["draft_tokens"] == got[2]["rounds"] * 3


def _raw_predict(client, name, data, dtype, shape):
    t = port_pb.Tensor(data=data, dtype=dtype, shape=list(shape))
    return lambda: client._predict(port_pb.PredictRequest(
        model_name=name, inputs=t), timeout=60)


ERROR_CASES = {
    "wrong_shape": lambda c: lambda: c.predict(
        "thin", np.zeros((2, 16, 16, 3), np.float32)),
    "wrong_rank": lambda c: lambda: c.predict(
        "mnist", np.zeros((28, 28), np.float32)),
    "garbage_dtype": lambda c: _raw_predict(c, "mnist", b"\x00" * 8,
                                            "not_a_dtype", (2,)),
    "size_mismatch": lambda c: _raw_predict(
        c, "mnist", np.zeros(10, np.float32).tobytes(), "float32",
        (1, 28, 28, 1)),
    "scalar": lambda c: _raw_predict(c, "mnist", b"\x00" * 4, "float32", ()),
    "bert_int32_tokens": lambda c: lambda: c.predict(
        "bert", np.ones((2, 8), np.int32)),
    "lm_int32_tokens": lambda c: lambda: c.predict(
        "lm", np.ones((1, 8), np.int32)),
    "bert_float_tokens": lambda c: lambda: c.predict(
        "bert", np.ones((2, 8), np.float32)),
    "batch_0": lambda c: lambda: c.predict(
        "mnist", np.zeros((0, 28, 28, 1), np.float32)),
    "batch_9": lambda c: lambda: c.predict("mnist", _mnist_x(9)),
    "unknown_model": lambda c: lambda: c.predict("nope", _mnist_x(1)),
    "unknown_version": lambda c: lambda: c.predict("mnist", _mnist_x(1),
                                                   version=7),
    "generate_unknown_model": lambda c: lambda: c.generate("nope", PROMPTS),
    "generate_on_mnist": lambda c: lambda: c.generate("mnist", PROMPTS),
    "generate_garbage_prompt": lambda c: lambda: c._generate(
        port_pb.GenerateRequest(model_name="lm", prompt=port_pb.Tensor(
            data=b"\x00" * 3, dtype="int32", shape=[1])), timeout=60),
    "generate_token_out_of_vocab": lambda c: lambda: c.generate(
        "lm", np.full((1, 4), 999, np.int32)),
    "generate_too_long": lambda c: lambda: c.generate(
        "lm", PROMPTS, max_new_tokens=200),
    "generate_eos_unary": lambda c: lambda: c.generate(
        "lm", PROMPTS, eos_id=3),
    "generate_batch_9": lambda c: lambda: c.generate(
        "lm", np.ones((9, 4), np.int32)),
    "stream_on_mnist": lambda c: lambda: list(c.generate_stream(
        "mnist", PROMPTS)),
    "speculative_without_draft": lambda c: lambda: c.generate_speculative(
        "lm-solo", PROMPTS, max_new_tokens=4),
    "speculative_draft_len_17": lambda c: lambda: c.generate_speculative(
        "lm", PROMPTS, max_new_tokens=4, draft_len=17),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_status_codes_equal_the_reference(stacks, case):
    """Each request gets the same status code from both servers,
    whichever client sends it."""
    make = ERROR_CASES[case]
    want = _code(make(stacks["ref"].clients["port"]))
    got = _code(make(stacks["port"].clients["ref"]))
    assert got == want, (case, got, want)
    assert want != grpc.StatusCode.OK or case == "batch_0"


def test_predict_core_without_the_transport(stacks):
    """:func:`predict_tensor` (what the card runs without ``grpc``) gives
    the RPC's response bytes, and its faults carry the RPC's codes."""
    model = stacks["port"].server.repo.get("thin")
    x = np.random.default_rng(5).standard_normal((3, *IMAGE)).astype(
        np.float32)
    data, dtype, shape = port.encode_array(x)
    got = port.predict_tensor(model, data, dtype, shape, 8)
    resp = stacks["port"].clients["port"]._predict(port_pb.PredictRequest(
        model_name="thin", inputs=port.array_to_tensor(x)), timeout=60)
    assert got == (resp.outputs.data, resp.outputs.dtype,
                   list(resp.outputs.shape))
    for bad, code in (((data[:-4], dtype, shape), "INVALID_ARGUMENT"),
                      ((data, dtype, (3, 16, 64, 3)), "INVALID_ARGUMENT"),
                      ((data, "junk", shape), "INVALID_ARGUMENT")):
        with pytest.raises(port.RpcFault) as err:
            port.predict_tensor(model, *bad, 8)
        assert err.value.code == code
    padded, n = port.predict_inputs(
        model, (x * 100).astype(np.uint8), 8)
    assert padded.dtype == np.float32 and padded.shape[0] == 4 and n == 3


# -- observability ------------------------------------------------------------


def test_traceparent_parents_the_spans_and_counters_count(stacks):
    client = stacks["port"].clients["ref"]
    predicts = DEFAULT_REGISTRY.counter("kftpu_serving_grpc_requests_total")
    generates = DEFAULT_REGISTRY.counter(
        "kftpu_serving_grpc_generate_requests_total")
    before = (predicts.get(model="mnist"), generates.get(model="lm"))
    trace_id, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    md = (("traceparent", f"00-{trace_id}-{parent}-01"),)
    client._predict(ref_pb.PredictRequest(
        model_name="mnist", inputs=ref.array_to_tensor(_mnist_x(1))),
        metadata=md, timeout=60)
    client._generate(client._generate_request(
        "lm", PROMPTS, max_new_tokens=2, true_len=0, temperature=0.0,
        seed=0, top_k=0, top_p=1.0, eos_id=None, version=None),
        metadata=md, timeout=60)
    list(client._generate_stream(client._generate_request(
        "lm", PROMPTS, max_new_tokens=2, true_len=0, temperature=0.0,
        seed=0, top_k=0, top_p=1.0, eos_id=None, version=None),
        metadata=md, timeout=60))
    spans = {s.name: s for s in DEFAULT_COLLECTOR.trace(trace_id)}
    for name in ("serving.grpc.predict", "serving.grpc.generate",
                 "serving.grpc.generate_stream"):
        assert spans[name].parent_id == parent, name
        assert spans[name].attrs["model"] in ("mnist", "lm")
    assert predicts.get(model="mnist") - before[0] == 1
    assert generates.get(model="lm") - before[1] == 2


# -- server.main --------------------------------------------------------------


def _run_main(monkeypatch, tmp_path, grpc_port, probe):
    """``server.main`` on the CPU over one mnist export, with ``probe``
    run once it serves (its ``time.sleep``), then stopped as Ctrl-C
    stops it."""
    from kubeflow_tpu_torch.serving import server as srv

    jax_store.export_model(str(tmp_path / "mnist"), "mnist",
                           convert.random_mnist_params(0))
    made = []

    class CpuServer(ModelServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def sleep(_):
        probe(made[0])
        raise KeyboardInterrupt

    monkeypatch.setattr(srv, "ModelServer", CpuServer)
    monkeypatch.setattr(srv.time, "sleep", sleep)
    for key, val in (("KFTPU_MODEL_BASE_PATH", str(tmp_path)),
                     ("KFTPU_REST_PORT", "0"),
                     ("KFTPU_GRPC_PORT", str(grpc_port)),
                     ("KFTPU_DECODE_SLOTS", "0")):
        monkeypatch.setenv(key, val)
    srv.main(device="cpu")


def _rest_models(server):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/v1/models", timeout=30) as r:
        return json.loads(r.read())["models"]


def test_main_serves_rest_and_grpc(monkeypatch, tmp_path):
    gport = _free_port()
    seen = {}

    def probe(server):
        seen["rest"] = _rest_models(server)
        client = port.PredictClient(f"127.0.0.1:{gport}")
        try:
            seen["grpc"] = client.list_models()
            seen["out"] = client.predict("mnist", _mnist_x(1))[0].shape
        finally:
            client.close()

    _run_main(monkeypatch, tmp_path, gport, probe)
    assert seen == {"rest": ["mnist"], "grpc": ["mnist"], "out": (1, 10)}
    # stopped with the REST server: the port no longer answers
    client = port.PredictClient(f"127.0.0.1:{gport}")
    try:
        with pytest.raises(grpc.RpcError):
            client.list_models(timeout=2.0)
    finally:
        client.close()


def test_main_without_grpc_serves_rest_and_warns(monkeypatch, tmp_path,
                                                 caplog):
    real_import = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_grpc)
    seen = []
    with caplog.at_level(logging.WARNING):
        _run_main(monkeypatch, tmp_path, _free_port(),
                  lambda s: seen.append(_rest_models(s)))
    assert seen == [["mnist"]]
    warned = [r.getMessage() for r in caplog.records
              if r.levelno == logging.WARNING]
    assert any(m.startswith("gRPC disabled (grpc not importable: ")
               and m.endswith("; serving REST only") for m in warned), warned


def test_stream_fault_codes(stacks, monkeypatch):
    """A generation that fails mid-stream ends the stream with the
    reference's codes: ``EngineClosed`` UNAVAILABLE, any other fault
    INTERNAL, each after the rows already sent."""
    from kubeflow_tpu_torch.serving import server as srv
    from kubeflow_tpu_torch.serving.engine import EngineClosed

    def failing(exc):
        def run_generate(*a, **kw):
            def rows():
                yield [1, 2]
                raise exc
            return 200, {"token_stream": rows(), "model_version": "1"}
        return run_generate

    client = stacks["port"].clients["ref"]
    for exc, code in ((EngineClosed("rolled over"),
                       grpc.StatusCode.UNAVAILABLE),
                      (RuntimeError("boom"), grpc.StatusCode.INTERNAL)):
        monkeypatch.setattr(port, "run_generate", failing(exc))
        got = []
        with pytest.raises(grpc.RpcError) as err:
            for row in client.generate_stream("lm", PROMPTS):
                got.append(row.tolist())
        assert err.value.code() == code and got == [[1, 2]]
    assert srv.run_generate is not port.run_generate
