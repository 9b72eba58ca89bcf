"""``:predict`` of the port's model store and server against the JAX package.

- The four servable kinds (``mnist``, ``resnet`` fused and unfused with
  both stems, ``bert``, ``transformer``) exported at tiny widths from
  numpy-seeded params, by the JAX ``export_model`` and by the port's,
  load in both stores; the port's ``LoadedModel.predict`` must equal the
  JAX one within 1e-5 at f32. The JAX kernel paths run as its own tests
  run them on the CPU: fused ResNet at sites that tile (the Pallas
  kernel in interpret mode), BERT with ``attention_impl="flash"``.
- Token ids outside the vocabulary behave as ``jnp.take`` in both
  embeddings: ids in ``[-V, 0)`` wrap, any other gives NaN rows.
- ``input_shape``/``input_dtype``: written by the port's export (the
  reference's defaults for ``mnist`` and ``resnet``) and read by both
  stores.
- One parametrised HTTP test runs the cases of ``tests/test_serving.py``
  (and the further error paths) against the JAX server and the port's:
  the same request gets the same status code, and a 200 the same
  predictions.
"""

import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import model_store as jax_store
from kubeflow_tpu.serving.server import ModelServer as JaxServer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.resnet import ResNetConfig
from kubeflow_tpu_torch.models.transformer import take_rows, tiny_config
from kubeflow_tpu_torch.serving import model_store as store
from kubeflow_tpu_torch.serving.server import ModelServer

from test_torch_resnet import randomized

torch.set_num_threads(2)

TOL = 1e-5
IMAGE = (32, 32, 3)
# stages (1, 1) at width 128 on 32x32 images: both fused sites tile,
# so JAX runs its Pallas kernel (interpret mode)
RESNET = dict(stage_sizes=[1, 1], num_classes=10, width=128,
              dtype="float32", bn_dtype="float32")
BERT = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq_len=32, dtype="float32", remat=False,
            scan_layers=False)
# ids past the vocabulary, at and below -V, and negatives that wrap
BERT_IDS = np.array([[1, 5, 63, 2, 9, 3, 4, 7], [0, -1, -64, 3, 4, 5, 6, 2],
                     [0, 1, 2, 64, 4, 5, 6, 7], [0, 1, -65, 3, 4, 5, 6, 7]])
LM_IDS = np.array([[1, 5, 200, -3, 9, 3, 4, 7], [2, 255, 256, 0, 1, 1, 1, 1],
                   [-256, 4, 4, 4, 4, 4, 4, 4]])


def _resnet_case(stem, fused):
    cfg = dict(RESNET, stem=stem, fused_bn_conv=fused)
    pc = ResNetConfig(**{**cfg, "stage_sizes": (1, 1)})
    variables = randomized(convert.random_resnet_params(pc, 0), 1)
    images = np.random.default_rng(2).standard_normal(
        (2, *IMAGE)).astype(np.float32)
    return "resnet", variables, cfg, images, IMAGE


def _case(name):
    if name == "mnist":
        x = np.random.default_rng(1).standard_normal(
            (3, 28, 28, 1)).astype(np.float32)
        return "mnist", convert.random_mnist_params(0), {}, x, None
    if name.startswith("resnet"):
        _, stem, fused = name.split("-")
        return _resnet_case(stem, fused == "fused")
    if name.startswith("bert"):
        cfg = dict(BERT, attention_impl=name.split("-")[1])
        params = convert.unflatten(convert.random_bert_params(
            BertConfig(**cfg), 3))
        return "bert", params, cfg, BERT_IDS, None
    tc = tiny_config(max_seq_len=32)
    return ("transformer", convert.unflatten(convert.random_params(tc, 4)),
            store.transformer_export_config(tc), LM_IDS, None)


CASES = ["mnist", "resnet-conv-fused", "resnet-conv-unfused",
         "resnet-space_to_depth-fused", "resnet-space_to_depth-unfused",
         "bert-flash", "bert-dense", "transformer"]


@pytest.mark.parametrize("exporter", ["jax", "port"])
@pytest.mark.parametrize("name", CASES)
def test_predict_matches_the_jax_store(tmp_path, name, exporter):
    kind, params, cfg, x, shape = _case(name)
    export = (jax_store if exporter == "jax" else store).export_model
    export(str(tmp_path / kind), kind, params, config=cfg,
           input_shape=shape)
    ref = jax_store.load_version(str(tmp_path / kind), 1)
    got = store.load_version(str(tmp_path / kind), 1, device="cpu")
    assert got.kind == kind and got.version == 1
    assert got.input_shape == ref.input_shape
    want = np.asarray(ref.predict(jnp.asarray(x)))
    out = got.predict(x)
    assert out.shape == want.shape and out.dtype == np.float32
    # NaN rows (ids past the vocabulary) must sit where JAX puts them
    np.testing.assert_allclose(out, want, atol=TOL, rtol=0)
    if kind in ("bert", "transformer"):
        assert got.lm_config is None if kind == "bert" else \
            got.lm_params is got.module
    else:
        assert got.lm_config is None and got.lm_params is None
        assert got.max_seq_len is None and got.vocab_size is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_rows_are_jnp_take(dtype):
    """Ids in [-V, 0) wrap; ids >= V or < -V read a NaN row."""
    table = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 3, -1, -4, -5, 4, 7, 2]])
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids),
                               axis=0))
    got = take_rows(torch.from_numpy(table).to(dtype), torch.from_numpy(ids))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.isnan(want[0, 4:7]).all() and not np.isnan(want[0, :4]).any()


@pytest.mark.parametrize("kind", ["mnist", "resnet", "bert"])
def test_input_shape_is_written_and_read_by_both_stores(tmp_path, kind):
    """The port's export records the reference's defaults (``mnist``,
    ``resnet``) or an explicit shape; both stores read it back. A
    kind without one records none."""
    name = {"mnist": "mnist", "resnet": "resnet-conv-fused",
            "bert": "bert-dense"}[kind]
    _, params, cfg, _, _ = _case(name)
    store.export_model(str(tmp_path / "default"), kind, params, config=cfg)
    store.export_model(str(tmp_path / "explicit"), kind, params,
                       config=cfg, input_shape=(8,), input_dtype="int32")
    default = {"mnist": (28, 28, 1), "resnet": (224, 224, 3)}.get(kind)
    for sub, shape, dtype in (("default", default, "float32"),
                              ("explicit", (8,), "int32")):
        ref = jax_store.load_version(str(tmp_path / sub), 1)
        got = store.load_version(str(tmp_path / sub), 1, device="cpu")
        assert got.input_shape == ref.input_shape == shape
        if shape is not None:
            assert got.input_dtype == ref.input_dtype == dtype


def test_warmup_runs_every_bucket_and_generate_refuses_other_kinds(
        tmp_path):
    kind, params, cfg, x, _ = _case("mnist")
    store.export_model(str(tmp_path / "mnist"), kind, params)
    _, bparams, bcfg, ids, _ = _case("bert-dense")
    store.export_model(str(tmp_path / "bert"), "bert", bparams, config=bcfg)
    server = ModelServer(str(tmp_path), port=0, poll_interval_s=3600,
                         max_batch_size=8, warmup=True, device="cpu")
    jserver = JaxServer(str(tmp_path), port=0, poll_interval_s=3600)
    try:
        assert server.repo.warmed == {("mnist", 1): 4, ("bert", 1): 0}
        code, body = server.handle_predict("mnist", None,
                                           {"instances": x.tolist()})
        assert code == 200 and len(body["predictions"]) == 3
        gen = {"prompt_tokens": [[1, 2]], "max_new_tokens": 2}
        assert (server.handle_generate("mnist", None, gen)
                == jserver.handle_generate("mnist", None, gen))
    finally:
        server.repo.stop()
        jserver.repo.stop()


# -- the HTTP front end against the JAX server ----------------------------


def _post(url, payload):
    """(status, body) of one POST, HTTP errors included."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _zero_like(params):
    return jax.tree_util.tree_map(np.zeros_like, params)


def _mnist_x(n, seed=0):
    return np.random.RandomState(seed).randn(n, 28, 28, 1).astype(
        np.float32).tolist()


def _end_to_end(url, store_dir, params):
    out = [_post(f"{url}/v1/models/mnist:predict",
                 {"instances": _mnist_x(2)})]
    out.append(_get(f"{url}/v1/models"))
    out.append(_get(f"{url}/v1/models/mnist"))
    return out


def _hot_reload(url, store_dir, params):
    jax_store.export_model(os.path.join(store_dir, "mnist"), "mnist",
                           _zero_like(params), version=2)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        code, body = _post(f"{url}/v1/models/mnist:predict",
                           {"instances": _mnist_x(1)})
        if body.get("model_version") == "2":
            break
        time.sleep(0.1)
    return [(code, body)]


def _error_paths(url, store_dir, params):
    return [
        _post(f"{url}/v1/models/nope:predict", {"instances": [[0.0]]}),
        _post(f"{url}/v1/models/mnist:predict", {"wrong": 1}),
        _post(f"{url}/v1/models/mnist:predict",
              {"instances": np.zeros((64, 28, 28, 1)).tolist()}),
        _post(f"{url}/v1/models/mnist/versions/9:predict",
              {"instances": np.zeros((1, 28, 28, 1)).tolist()}),
        _post(f"{url}/v1/models/mnist/versions/x:predict",
              {"instances": [[0.0]]}),
        _post(f"{url}/v1/models/mnist:explain", {"instances": [[0.0]]}),
        # ragged, wrong-shaped, non-numeric and empty instances
        _post(f"{url}/v1/models/mnist:predict",
              {"instances": [[0.0, 1.0], [2.0]]}),
        _post(f"{url}/v1/models/mnist:predict",
              {"instances": np.zeros((2, 28, 28, 3)).tolist()}),
        _post(f"{url}/v1/models/mnist:predict",
              {"instances": np.full((1, 28, 28, 1), "a").tolist()}),
        _post(f"{url}/v1/models/mnist:predict", {"instances": []}),
    ]


def _padding(url, store_dir, params):
    return [_post(f"{url}/v1/models/mnist:predict",
                  {"instances": _mnist_x(n, seed=n)}) for n in (1, 3, 5, 8)]


def _scalar(url, store_dir, params):
    return [_post(f"{url}/v1/models/mnist:predict", {"instances": 5})]


def _pinned(url, store_dir, params):
    jax_store.export_model(os.path.join(store_dir, "mnist"), "mnist",
                           _zero_like(params), version=2)
    return [_post(f"{url}/v1/models/mnist/versions/{v}:predict",
                  {"instances": _mnist_x(1)}) for v in (1, 2, 1)]


HTTP_CASES = {"predict_end_to_end": _end_to_end,
              "version_hot_reload": _hot_reload,
              "error_paths": _error_paths,
              "padding_bucket": _padding,
              "scalar_instances": _scalar,
              "pinned_version": _pinned}


def _run(server, case, store_dir, params):
    port = server.start()
    try:
        return HTTP_CASES[case](f"http://127.0.0.1:{port}", store_dir,
                                params)
    finally:
        server.stop()


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_http_answers_as_the_jax_server(tmp_path, case):
    """Each case of ``tests/test_serving.py`` (and more error paths) on
    the JAX server and then on the port's, each over its own copy of one
    JAX export: the same status codes, and a 200's predictions within
    1e-5 with the same ``model_version``."""
    params = convert.random_mnist_params(0)
    answers = {}
    for side in ("jax", "port"):
        base = str(tmp_path / side)
        jax_store.export_model(os.path.join(base, "mnist"), "mnist", params)
        server = (JaxServer(base, port=0, poll_interval_s=0.1)
                  if side == "jax" else
                  ModelServer(base, port=0, poll_interval_s=0.1,
                              device="cpu"))
        answers[side] = _run(server, case, base, params)
    assert ([c for c, _ in answers["port"]]
            == [c for c, _ in answers["jax"]]), answers
    for (code, got), (_, want) in zip(answers["port"], answers["jax"]):
        if code != 200 or "predictions" not in want:
            assert got.keys() == want.keys(), (got, want)
            if code == 200:
                assert got == want
            continue
        assert got["model_version"] == want["model_version"]
        np.testing.assert_allclose(np.asarray(got["predictions"]),
                                   np.asarray(want["predictions"]),
                                   atol=TOL, rtol=0)
    if case == "pinned_version":
        assert [b["model_version"] for _, b in answers["port"]] == \
            ["1", "2", "1"]


TOKEN_BODIES = [[[1.5, 2.0]], [1, 2, 3], [[1] * 40], [[[1, 2]]],
                [["a", "b"]], [[True, False]], [[1, 2], [3]], [],
                [[3, 70, -1, -65]]]


@pytest.mark.parametrize("kind", ["bert", "transformer"])
def test_token_predict_status_codes_match_the_jax_server(tmp_path, kind):
    """Token kinds have no ``input_shape``: the port checks rank and
    dtype before the launch, where JAX raises TypeError/ValueError (a
    400); a long or out-of-vocabulary batch runs on both."""
    name = "bert-dense" if kind == "bert" else "transformer"
    _, params, cfg, _, _ = _case(name)
    jax_store.export_model(str(tmp_path / "m"), kind, params, config=cfg)
    port = ModelServer(str(tmp_path), port=0, poll_interval_s=3600,
                       device="cpu")
    ref = JaxServer(str(tmp_path), port=0, poll_interval_s=3600)
    try:
        for inst in TOKEN_BODIES:
            code, got = port.handle_predict("m", None, {"instances": inst})
            want_code, want = ref.handle_predict("m", None,
                                                 {"instances": inst})
            assert code == want_code, (inst, got, want)
            if code == 200:
                np.testing.assert_allclose(
                    np.asarray(got["predictions"], np.float32),
                    np.asarray(want["predictions"], np.float32),
                    atol=TOL, rtol=0)
    finally:
        port.repo.stop()
        ref.repo.stop()
