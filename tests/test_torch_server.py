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


# -- speculative decoding through :generate ---------------------------------


def _spec_store(tmp_path, jc, params, draft_of="lm@1"):
    """A JAX export of ``jc``/``params`` as ``lm`` and its 1-layer
    truncation as ``lm-draft``, paired through ``draft_of``."""
    from kubeflow_tpu.train.distill import truncate_draft

    dcfg, dparams = truncate_draft(jc, params, 1)
    _export(str(tmp_path), jc, params)
    jax_store.export_model(
        str(tmp_path / "lm-draft"), "transformer", dparams,
        config=jax_store.transformer_export_config(dcfg),
        draft_of=draft_of)
    return dcfg, dparams


SPEC_PROMPTS = [[5, 11, 17, 2], [9, 4]]


def _refusal_bodies():
    base = {"prompt_tokens": SPEC_PROMPTS, "max_new_tokens": 8,
            "speculative": True}
    return [
        ("plain", base),
        ("draft_len_0", dict(base, draft_len=0)),
        ("draft_len_17", dict(base, draft_len=17)),
        ("draft_len_str", dict(base, draft_len="x")),
        ("temperature", dict(base, temperature=0.7)),
        ("stream", dict(base, stream=True)),
        ("eos_id", dict(base, eos_id=3)),
        ("prefix_len", dict(base, prefix_len=1)),
        ("no_slack", dict(base, max_new_tokens=44)),
    ]


def test_speculative_without_draft_is_refused_like_the_reference(
        tmp_path, jax_lm):
    """Both packages' ``run_generate`` on the same bodies, with and
    without a paired draft, unary and with an engine: the same status
    and error for every refusal (no draft; draft_len 0, 17 and not an
    int; temperature > 0; stream; eos_id; prefix_len; no slack for the
    proposals)."""
    from kubeflow_tpu.serving import server as jax_server
    from kubeflow_tpu.serving.model_store import DraftPair as JaxPair
    from kubeflow_tpu_torch.serving import server as port_server

    jc, params = jax_lm
    dcfg, dparams = _spec_store(tmp_path, jc, params)
    ref = jax_store.load_version(str(tmp_path / "lm"), 1)
    port = store.load_version(str(tmp_path / "lm"), 1, device="cpu")
    pdraft = store.load_version(str(tmp_path / "lm-draft"), 1,
                                device="cpu")
    engine = object()   # refused before the engine is ever used
    seen = 0
    for paired in (False, True):
        ref.draft = JaxPair(dcfg, dparams, "lm-draft@1") if paired else None
        port.draft = (store.DraftPair(pdraft.lm_config, pdraft.lm_params,
                                      "lm-draft@1") if paired else None)
        for eng in (None, engine):
            for label, body in _refusal_bodies():
                if paired and label == "plain":
                    continue   # served: the round trip test holds it
                stream = bool(body.get("stream"))
                want = jax_server.run_generate(
                    ref, body, 8, model_name="lm", stream=stream,
                    engine=eng)
                got = port_server.run_generate(
                    port, body, 8, model_name="lm", stream=stream,
                    engine=eng)
                assert want[0] == 400, (label, want)
                assert got == want, (label, paired, eng)
                seen += 1
    assert seen == 34


def test_speculative_rest_round_trip_on_a_jax_exported_pair(tmp_path,
                                                            jax_lm):
    """A JAX-exported target and draft (``draft_of: lm@1``) served by
    the port: the pair is attached at load, ``speculative: true`` gives
    the plain greedy tokens and JAX's speculative tokens and stats, the
    status names the draft and the four counters move."""
    from kubeflow_tpu.serving import server as jax_server
    from kubeflow_tpu.serving.server import ModelRepository as JaxRepo
    from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY

    jc, params = jax_lm
    _spec_store(tmp_path, jc, params)
    jrepo = JaxRepo(str(tmp_path), poll_interval_s=3600)
    body = {"prompt_tokens": SPEC_PROMPTS, "max_new_tokens": 7,
            "speculative": True, "draft_len": 3}
    code, want = jax_server.run_generate(jrepo.get("lm"), body, 8,
                                         model_name="lm")
    assert code == 200, want
    accepted = DEFAULT_REGISTRY.counter(
        "kftpu_serving_speculative_accepted_tokens_total")
    proposed = DEFAULT_REGISTRY.counter(
        "kftpu_serving_speculative_draft_tokens_total")
    before = (accepted.get(model="lm"), proposed.get(model="lm"))
    server = ModelServer(str(tmp_path), port=0, device="cpu")
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    try:
        plain = _post(f"{base}/v1/models/lm:generate",
                      {"prompt_tokens": SPEC_PROMPTS, "max_new_tokens": 7})
        spec = _post(f"{base}/v1/models/lm:generate", body)
        assert spec["tokens"] == plain["tokens"] == want["tokens"]
        assert spec["speculative"] == want["speculative"]
        s = spec["speculative"]
        assert s["draft"] == "lm-draft@1" and s["draft_len"] == 3
        assert s["draft_tokens"] == s["rounds"] * 3
        with urllib.request.urlopen(f"{base}/v1/models/lm") as r:
            assert json.loads(r.read())["speculative_draft"] == "lm-draft@1"
        with urllib.request.urlopen(f"{base}/metrics") as r:
            text = r.read().decode()
        for series in ("requests_total", "draft_tokens_total",
                       "accepted_tokens_total", "last_acceptance_rate"):
            assert f"kftpu_serving_speculative_{series}" in text
        assert accepted.get(model="lm") - before[0] == s["accepted"]
        assert proposed.get(model="lm") - before[1] == s["draft_tokens"]
        # the draft is served as a model of its own, with no draft
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/lm-draft:generate", body)
        assert e.value.code == 400
        assert "no paired" in json.loads(e.value.read())["error"]
    finally:
        server.stop()


def test_draft_pairs_repairs_and_detaches_on_poll(tmp_path, jax_lm):
    """A draft exported after the target loads pairs on the next poll; a
    newer draft version re-pairs; a deleted draft detaches; each as one
    ``DraftPair`` swap without a target version bump. The port's draft
    exports pair in the JAX repository too."""
    import shutil

    from kubeflow_tpu.serving.server import ModelRepository as JaxRepo
    from kubeflow_tpu_torch.serving.server import ModelRepository
    from kubeflow_tpu_torch.train.distill import truncate_draft

    jc, params = jax_lm
    _export(str(tmp_path), jc, params)
    repo = ModelRepository(str(tmp_path), poll_interval_s=3600,
                           device="cpu")
    model = repo.get("lm")
    assert model.draft is None
    pc = model.lm_config
    dcfg, draft = truncate_draft(pc, model.lm_params, 1)
    tree = convert.bert_params(draft, scan_layers=dcfg.scan_layers)
    for version in (1, 2):
        store.export_model(str(tmp_path / "lm-draft"), "transformer", tree,
                           config=store.transformer_export_config(dcfg),
                           version=version, draft_of="lm")
        repo.refresh()
        pair = model.draft
        assert isinstance(pair, store.DraftPair)
        assert pair.ref == f"lm-draft@{version}"
        assert pair.config.n_layers == 1
        assert repo.status("lm")["speculative_draft"] == pair.ref
    assert repo.get("lm") is model
    jrepo = JaxRepo(str(tmp_path), poll_interval_s=3600)
    assert jrepo.get("lm").draft.ref == "lm-draft@2"
    shutil.rmtree(str(tmp_path / "lm-draft"))
    repo.refresh()
    assert model.draft is None and "speculative_draft" not in \
        repo.status("lm")
    assert store.find_draft_for(str(tmp_path), "lm", 1) is None
