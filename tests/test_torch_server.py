"""Port model store and HTTP server against the JAX package.

- Exports written by ``kubeflow_tpu.serving.model_store.export_model``
  (plain, ``quantize=True``, and bf16 leaves carried as ``cast_leaves``)
  load in the port with the same weights, and the port's own exports
  load in the JAX package.
- ``POST :generate`` on the port's ``ModelServer`` with a paged engine
  returns the JAX paged engine's greedy tokens, dense and streamed.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import tiny_config as jax_tiny
from kubeflow_tpu.serving import model_store as jax_store
from kubeflow_tpu.serving.engine import DecodeEngine as JaxEngine
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import tiny_config
from kubeflow_tpu_torch.serving import model_store as store
from kubeflow_tpu_torch.serving.server import ModelServer

torch.set_num_threads(2)
TOKS = (np.arange(14, dtype=np.int32)[None] * 11 + 3) % 256


@pytest.fixture(scope="module")
def jax_lm():
    jc = jax_tiny(max_seq_len=48)
    params = JaxTransformer(jc).init(jax.random.key(0), TOKS)["params"]
    return jc, params


def _export(base, jc, params, **kw):
    return jax_store.export_model(
        os.path.join(base, "lm"), "transformer", params,
        config=jax_store.transformer_export_config(jc), **kw)


@pytest.mark.parametrize("variant", ["plain", "quantize", "bf16_leaves"])
def test_jax_exports_load_in_the_port(tmp_path, jax_lm, variant):
    jc, params = jax_lm
    if variant == "bf16_leaves":
        params = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), params)
    _export(str(tmp_path), jc, params, quantize=variant == "quantize")
    meta = (tmp_path / "lm" / "1" / "model.yaml").read_text()
    assert {"plain": "kind", "quantize": "quantized_leaves",
            "bf16_leaves": "cast_leaves"}[variant] in meta
    ref = jax_store.load_version(str(tmp_path / "lm"), 1)
    got = store.load_version(str(tmp_path / "lm"), 1, device="cpu")
    assert (got.version, got.max_seq_len, got.vocab_size) == (1, 48, 256)
    want_params = convert.flatten(
        jax.tree_util.tree_map(np.asarray, ref.lm_params))
    port = dict(got.lm_params.named_parameters())
    emb = np.asarray(want_params["token_embed"], np.float32)
    np.testing.assert_array_equal(port["token_embed"].numpy(), emb)
    want = np.asarray(ref.predict(jnp.asarray(TOKS)))
    np.testing.assert_allclose(got.lm_params(torch.from_numpy(TOKS)).numpy(),
                               want, atol=1e-5, rtol=0)


def test_port_export_loads_in_jax(tmp_path):
    pc = tiny_config(max_seq_len=48)
    flat = convert.random_params(pc, seed=3)
    store.export_model(str(tmp_path / "lm"), "transformer", flat,
                       config=store.transformer_export_config(pc))
    ref = jax_store.load_version(str(tmp_path / "lm"), 1)
    got = store.load_version(str(tmp_path / "lm"), 1, device="cpu")
    want = np.asarray(ref.predict(jnp.asarray(TOKS)))
    np.testing.assert_allclose(got.lm_params(torch.from_numpy(TOKS)).numpy(),
                               want, atol=1e-5, rtol=0)
    assert store.list_versions(str(tmp_path / "lm")) == [1]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read()
        if resp.headers.get("Content-Type") == "application/jsonlines":
            return [json.loads(x) for x in raw.splitlines() if x.strip()]
        return json.loads(raw)


def test_http_generate_returns_jax_engine_tokens(tmp_path, jax_lm,
                                                 monkeypatch):
    jc, params = jax_lm
    _export(str(tmp_path), jc, params)
    prompts = [[5, 11, 17], [3, 2, 9, 23, 41, 8, 1, 30, 12]]
    jeng = JaxEngine(jc, params, slots=4, paged=True, kv_page_size=8,
                     prefill_chunk_tokens=4, autostart=False)
    jreqs = [jeng.submit(p, max_new=6) for p in prompts]
    for _ in range(40):
        jeng.run_once(timeout=0.01)
    want = [r.result() for r in jreqs]

    # the JAX engine's paged mode, page and chunk sizes, through the
    # server's knobs
    monkeypatch.setenv("KFTPU_PAGED", "1")
    monkeypatch.setenv("KFTPU_KV_PAGE_SIZE", "8")
    monkeypatch.setenv("KFTPU_PREFILL_CHUNK", "4")
    server = ModelServer(str(tmp_path), port=0, decode_slots=4,
                         device="cpu")
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    try:
        out = _post(f"{base}/v1/models/lm:generate",
                    {"prompt_tokens": prompts, "max_new_tokens": 6})
        assert out["tokens"] == want and out["model_version"] == "1"
        lines = _post(f"{base}/v1/models/lm/versions/1:generate",
                      {"prompt_tokens": prompts, "max_new_tokens": 6,
                       "stream": True})
        assert lines[-1] == {"done": True, "model_version": "1"}
        steps = [ln["tokens"] for ln in lines[:-1]]
        assert [list(r) for r in zip(*steps)] == want
        sampled = _post(f"{base}/v1/models/lm:generate",
                        {"prompt_tokens": prompts, "max_new_tokens": 4,
                         "temperature": 0.8, "top_k": 10, "seed": 3})
        again = _post(f"{base}/v1/models/lm:generate",
                      {"prompt_tokens": prompts, "max_new_tokens": 4,
                       "temperature": 0.8, "top_k": 10, "seed": 3})
        assert sampled["tokens"] == again["tokens"]
        for body, code in (({"prompt_tokens": prompts, "top_p": 0}, 400),
                           ({"prompt_tokens": [[300]]}, 400),
                           ({"prompt_tokens": [[1] * 40],
                             "max_new_tokens": 9}, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/models/lm:generate", body)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/nope:generate",
                  {"prompt_tokens": [[1]]})
        assert e.value.code == 404
        with urllib.request.urlopen(f"{base}/v1/models") as r:
            assert json.loads(r.read()) == {"models": ["lm"]}
        with urllib.request.urlopen(f"{base}/metrics") as r:
            text = r.read().decode()
        assert 'kftpu_engine_tokens_total{model="lm"}' in text
        assert "kftpu_serving_generate_requests_total" in text
        assert "engine_queue_wait_seconds_bucket" in text
    finally:
        server.stop()
