"""Port dense decode (``models/decode.py``, ``DenseKVCache``) against JAX.

The tiny LM of ``tests/test_engine.py`` (vocab 97, d_model 32, 2 layers,
4 heads, 2 KV heads, d_ff 64, max_seq_len 48, f32) with weights from
``jax.random.key(0)`` runs through ``kubeflow_tpu.models.decode`` and the
port on the CPU: logits within 1e-5 for ``prefill`` (ragged lengths),
``prefill_continue``, ``decode_step`` and the ``ragged_decode`` write,
the caches equal, and ``generate``'s greedy tokens identical. Writes past
``max_seq_len`` land nowhere and leave the live rows' logits unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.models import decode as jdec
from kubeflow_tpu.serving.model_store import transformer_export_config
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import decode as pdec
from kubeflow_tpu_torch.models.transformer import (
    DenseKVCache,
    TransformerConfig,
)

torch.set_num_threads(2)
ATOL = 1e-5
TOKS = np.random.default_rng(3).integers(0, 97, (3, 8)).astype(np.int32)
LENS = [8, 5, 3]


@pytest.fixture(scope="module")
def lm():
    jc = JaxConfig(vocab_size=97, d_model=32, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=64, max_seq_len=48,
                   dtype=jnp.float32, remat=False)
    params = JaxTransformer(jc).init(
        jax.random.key(0), np.zeros((1, 8), np.int32))["params"]
    pc = TransformerConfig(**transformer_export_config(jc))
    model = convert.to_module(pc, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    return jc, params, model


@pytest.fixture(scope="module")
def jax_prefill(lm):
    """The JAX oracle of the ragged prefill and three decode steps."""
    jc, params, _ = lm
    last, cache = jdec.prefill(jc, params, jnp.asarray(TOKS),
                               jnp.asarray(LENS))
    steps, caches = [np.asarray(last)], [cache]
    tok = jnp.asarray([4, 9, 60], jnp.int32)
    for _ in range(3):
        logits, cache = jdec.decode_step(jc, params, cache, tok)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return steps, caches + [cache]


def _port_cache(model, B):
    return pdec.init_cache(model.config, B, device="cpu")


def _assert_cache(pcache: DenseKVCache, jcache):
    attn = jcache["blocks"]["attn"]
    np.testing.assert_allclose(pcache.k.numpy(), np.asarray(attn["k"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(pcache.v.numpy(), np.asarray(attn["v"]),
                               atol=ATOL, rtol=0)
    assert pcache.positions.tolist() == np.asarray(
        attn["positions"])[0].tolist()


@torch.no_grad()
def test_prefill_ragged_matches_jax(lm, jax_prefill):
    _, _, model = lm
    cache = _port_cache(model, 3)
    assert isinstance(cache, DenseKVCache)
    assert tuple(cache.k.shape) == (2, 3, 48, 2, 8)
    last, cache = pdec.prefill(model, cache, torch.from_numpy(TOKS),
                               torch.tensor(LENS))
    np.testing.assert_allclose(last.numpy(), jax_prefill[0][0], atol=ATOL,
                               rtol=0)
    _assert_cache(cache, jax_prefill[1][0])


@torch.no_grad()
def test_decode_step_matches_jax(lm, jax_prefill):
    _, _, model = lm
    cache = _port_cache(model, 3)
    _, cache = pdec.prefill(model, cache, torch.from_numpy(TOKS),
                            torch.tensor(LENS))
    tok = torch.tensor([4, 9, 60], dtype=torch.int32)
    for i in range(3):
        logits, cache = pdec.decode_step(model, cache, tok)
        np.testing.assert_allclose(logits.numpy(), jax_prefill[0][i + 1],
                                   atol=ATOL, rtol=0)
        tok = torch.argmax(logits, -1).to(torch.int32)
    _assert_cache(cache, jax_prefill[1][-1])


@torch.no_grad()
@pytest.mark.parametrize("start", [4, 44])
def test_prefill_continue_matches_jax(lm, start):
    """A 1-row prefix continued by an 8-token padded suffix (shared
    start). At start 44 the slice would pass the context end: both
    packages clamp its start to 40, as ``dynamic_update_slice`` does."""
    jc, params, model = lm
    prefix = (np.arange(start, dtype=np.int32)[None] * 7 + 2) % 97
    suffix = np.asarray([[5, 11, 17, 0, 0, 0, 0, 0]], np.int32)
    _, jcache = jdec.prefill(jc, params, jnp.asarray(prefix))
    want, jcache = jdec.prefill_continue(jc, params, jcache,
                                         jnp.asarray(suffix), 3, start + 3)
    cache = _port_cache(model, 1)
    _, cache = pdec.prefill(model, cache, torch.from_numpy(prefix))
    got, cache = pdec.prefill_continue(model, cache,
                                       torch.from_numpy(suffix), 3,
                                       start + 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    _assert_cache(cache, jcache)
    if start == 4:
        # the continuation is the full prompt's prefill
        full = np.concatenate([prefix, suffix[:, :3]], axis=1)
        ref, _ = pdec.prefill(model, _port_cache(model, 1),
                              torch.from_numpy(full))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                                   rtol=0)


@torch.no_grad()
def test_ragged_decode_matches_jax(lm):
    """``ragged_decode``: a 4-token forward from each row's own start
    (the per-row rope gather and batched write)."""
    jc, params, _ = lm
    jr = dataclasses.replace(jc, ragged_decode=True)
    pr = TransformerConfig(**transformer_export_config(jc),
                           ragged_decode=True)
    model = convert.to_module(pr, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    more = np.asarray([[3, 1, 4, 1], [5, 9, 2, 6], [5, 3, 5, 8]], np.int32)
    _, jcache = jdec.prefill(jr, params, jnp.asarray(TOKS),
                             jnp.asarray(LENS))
    want, jcache = jdec.prefill_continue(
        jr, params, jcache, jnp.asarray(more), jnp.asarray([4, 2, 3]),
        jnp.asarray(LENS) + jnp.asarray([4, 2, 3]))
    cache = _port_cache(model, 3)
    _, cache = pdec.prefill(model, cache, torch.from_numpy(TOKS),
                            torch.tensor(LENS))
    got, cache = pdec.prefill_continue(
        model, cache, torch.from_numpy(more), torch.tensor([4, 2, 3]),
        torch.tensor(LENS) + torch.tensor([4, 2, 3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    _assert_cache(cache, jcache)


@pytest.mark.parametrize("case", ["single", "ragged_batch"])
def test_generate_greedy_matches_jax(lm, case):
    jc, params, model = lm
    if case == "single":
        prompt, lens, n = np.asarray([[5, 11, 17]], np.int32), None, 12
    else:
        prompt, lens, n = TOKS, np.asarray(LENS, np.int32), 9
    want = np.asarray(jdec.generate(
        jc, params, jnp.asarray(prompt), max_new_tokens=n,
        true_len=None if lens is None else jnp.asarray(lens)))
    with torch.no_grad():
        got = pdec.generate(model, torch.from_numpy(prompt),
                            max_new_tokens=n,
                            true_len=None if lens is None
                            else torch.from_numpy(lens))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    fn = pdec.make_generate(model.config, max_new_tokens=n)
    with torch.no_grad():
        again = fn(model, torch.from_numpy(prompt),
                   None if lens is None else torch.from_numpy(lens), None)
    assert again.numpy().tolist() == want.tolist()


@torch.no_grad()
def test_generate_sampled_reproducible_per_seed(lm):
    _, _, model = lm
    prompt = torch.from_numpy(TOKS)
    kw = dict(max_new_tokens=6, true_len=torch.tensor(LENS),
              temperature=0.9, top_k=20, top_p=0.9)
    a = pdec.generate(model, prompt, seed=7, **kw)
    b = pdec.generate(model, prompt, seed=7, **kw)
    c = pdec.generate(model, prompt, seed=8, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 6) and 0 <= int(a.min()) and int(a.max()) < 97
    # rows of one batch draw apart: the same prompt twice differs
    twin = pdec.generate(model, prompt[:1].repeat(2, 1), seed=7,
                         max_new_tokens=12, temperature=5.0)
    assert not torch.equal(twin[0], twin[1])


def test_generate_validation(lm):
    _, _, model = lm
    p = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    for kw, msg in ((dict(max_new_tokens=46), "exceeds max_seq_len"),
                    (dict(max_new_tokens=2, temperature=0.5), "seed"),
                    (dict(max_new_tokens=2, temperature=-1.0, seed=0),
                     "temperature"),
                    (dict(max_new_tokens=2, top_k=-1), "top_k"),
                    (dict(max_new_tokens=2, top_p=0.0), "top_p"),
                    (dict(max_new_tokens=2, top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=msg):
            pdec.generate(model, p, **kw)
    with pytest.raises(ValueError, match="exceeds"):
        pdec.generate(model, torch.zeros((1, 40), dtype=torch.int32),
                      true_len=torch.tensor([40]), max_new_tokens=9)
    other = dataclasses.replace(model.config, max_seq_len=64)
    with pytest.raises(ValueError, match="config"):
        pdec.make_generate(other, max_new_tokens=2)(model, p, None, None)


@torch.no_grad()
def test_writes_past_the_context_land_nowhere(lm):
    """Rows at and past ``max_seq_len`` step (and take a ragged write)
    without raising; they change no cache entry, and a live row's
    logits are those it gets beside rows inside the context."""
    jc, params, _ = lm
    pr = TransformerConfig(**transformer_export_config(jc),
                           ragged_decode=True)
    model = convert.to_module(pr, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    prompt = torch.from_numpy(TOKS[:1].repeat(3, 0))
    cache = _port_cache(model, 3)
    _, cache = pdec.prefill(model, cache, prompt)
    cache.positions.copy_(torch.tensor([8, 47, 53], dtype=torch.int32))
    before = cache.k.clone(), cache.v.clone()
    tok = torch.tensor([4, 9, 60], dtype=torch.int32)
    logits, cache = pdec.decode_step(model, cache, tok)
    assert torch.isfinite(logits).all()
    assert cache.positions.tolist() == [9, 48, 54]
    changed = (cache.k != before[0]).any(dim=(0, 3, 4))   # (B, Smax)
    assert changed.nonzero().tolist() == [[0, 8], [1, 47]]
    inside = _port_cache(model, 3)
    _, inside = pdec.prefill(model, inside, prompt)
    want, _ = pdec.decode_step(model, inside, tok)
    np.testing.assert_array_equal(logits[:1].numpy(), want[:1].numpy())
    # a 4-token ragged write from 46: two positions in range, two not
    cache.positions.copy_(torch.tensor([9, 46, 60], dtype=torch.int32))
    k0 = cache.k.clone()
    _, cache = pdec.prefill_continue(model, cache, prompt[:, :4], 4,
                                     torch.tensor([13, 50, 64]))
    changed = (cache.k != k0).any(dim=(0, 3, 4))
    assert changed.nonzero().tolist() == [[0, 9], [0, 10], [0, 11],
                                          [0, 12], [1, 46], [1, 47]]
