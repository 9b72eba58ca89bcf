"""Port ``Transformer`` against the JAX reference, and the weight converter.

The same seeded inputs and the same weights go through
``kubeflow_tpu.models.Transformer.apply`` and the port's module on the
CPU; f32 logits must agree within 1e-5 (summation order is the only
difference). Weights cross as numpy, in both layer layouts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.transformer import Transformer as JaxTransformer
from kubeflow_tpu.models.transformer import tiny_config as jax_tiny
from kubeflow_tpu.serving.model_store import _flatten, transformer_export_config
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.decode import arm_slot, init_cache, prefill
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    tiny_config,
)

torch.set_num_threads(2)
ATOL = 1e-5


def _port_config(jc, **overrides):
    return TransformerConfig(**{**transformer_export_config(jc),
                                **overrides})


def _jax_setup(seed=0, **overrides):
    jc = jax_tiny(**overrides)
    toks = np.random.default_rng(seed).integers(
        0, jc.vocab_size, (2, 12)).astype(np.int32)
    params = JaxTransformer(jc).init(jax.random.key(seed), toks)["params"]
    return jc, params, toks


@pytest.mark.parametrize("scan_layers", [True, False])
def test_logits_match_jax(scan_layers):
    jc, params, toks = _jax_setup(scan_layers=scan_layers)
    want = np.asarray(JaxTransformer(jc).apply({"params": params}, toks))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.to_module(_port_config(jc), tree, device="cpu")
    got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_logits_match_jax(causal):
    """``attention_impl="flash"``: the port's flash path (the kernels'
    plain versions on CPU tensors) against the JAX model's Pallas
    kernels in interpret mode, full forward."""
    jc, params, toks = _jax_setup(seed=7, attention_impl="flash",
                                  causal=causal, max_seq_len=16)
    toks = np.concatenate([toks, toks[:, :4]], axis=1)   # S = 16
    want = np.asarray(JaxTransformer(jc).apply({"params": params}, toks))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.to_module(
        _port_config(jc, attention_impl="flash", causal=causal), tree,
        device="cpu")
    assert model.config.attention_impl == "flash"
    got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    dense = convert.to_module(_port_config(jc, attention_impl="auto",
                                           causal=causal),
                              tree, device="cpu")  # "auto": dense on CPU
    np.testing.assert_allclose(dense(torch.from_numpy(toks)).numpy(), want,
                               atol=ATOL, rtol=0)


def test_softcap_and_return_hidden_match_jax():
    jc, params, toks = _jax_setup(seed=1, logits_softcap=5.0)
    tree = jax.tree_util.tree_map(np.asarray, params)
    pc = _port_config(jc)
    model = convert.to_module(pc, tree, device="cpu")
    want = np.asarray(JaxTransformer(jc).apply({"params": params}, toks))
    np.testing.assert_allclose(model(torch.from_numpy(toks)).numpy(), want,
                               atol=ATOL, rtol=0)
    assert np.abs(want).max() <= 5.0
    hidden = Transformer(pc, return_hidden=True)
    convert.load_params(hidden, tree)
    want_h = np.asarray(JaxTransformer(jc, return_hidden=True).apply(
        {"params": params}, toks))
    with torch.no_grad():
        got_h = hidden(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got_h, want_h, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["nested", "flat_npz_keys"])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_converter_maps_every_leaf(layout, scan_layers):
    """Every JAX leaf lands in exactly one port parameter, unchanged —
    nested trees and the flat ``params.npz`` keys, scanned and
    unrolled."""
    jc, params, _ = _jax_setup(seed=2, scan_layers=scan_layers)
    flat = _flatten(params)
    tree = (jax.tree_util.tree_map(np.asarray, params)
            if layout == "nested" else flat)
    model = Transformer(_port_config(jc))
    convert.load_params(model, tree)
    got = dict(model.named_parameters())
    assert len(got) == len(flat) + (jc.n_layers - 1) * scan_layers * 9
    for key, arr in flat.items():
        if scan_layers and key.startswith("blocks/"):
            rest = key[len("blocks/"):].replace("/", ".")
            for i in range(jc.n_layers):
                np.testing.assert_array_equal(
                    got[f"blocks.{i}.{rest}"].detach().numpy(), arr[i])
        else:
            name = key.replace("block_", "blocks.", 1).replace("/", ".")
            np.testing.assert_array_equal(got[name].detach().numpy(), arr)


def test_converter_rejects_shape_mismatch_and_missing_leaves():
    jc, params, _ = _jax_setup(seed=3)
    flat = dict(_flatten(params))
    model = Transformer(_port_config(jc))
    bad = dict(flat, token_embed=flat["token_embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        convert.load_params(model, bad)
    missing = {k: v for k, v in flat.items() if k != "final_norm/scale"}
    with pytest.raises(KeyError, match="final_norm"):
        convert.load_params(model, missing)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_random_params_run_in_jax(scan_layers):
    """The port's seeded initializer writes the JAX layout exactly: the
    JAX model applies the same numbers and agrees with the port."""
    pc = tiny_config(scan_layers=scan_layers)
    flat = convert.random_params(pc, seed=4, scan_layers=scan_layers)
    nested = {}
    for key, arr in flat.items():
        node = nested
        *head, leaf = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    jc = jax_tiny(scan_layers=scan_layers)
    toks = np.arange(10, dtype=np.int32)[None] * 7 % 256
    want = np.asarray(JaxTransformer(jc).apply({"params": nested}, toks))
    got = convert.to_module(pc, flat, device="cpu")(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_paged_prefill_matches_full_forward():
    """Decode-mode prefill through the paged cache (scatter + gather
    path) gives the non-decode forward's logits for the last token."""
    jc, params, toks = _jax_setup(seed=5)
    pc = _port_config(jc, kv_page_size=8, kv_pages=4,
                      paged_attention_impl="gather")
    model = convert.to_module(pc, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    cache = init_cache(pc, 2, device="cpu")
    for row in range(2):
        arm_slot(cache, row, 0, [2 * row, 2 * row + 1] + [4] * 6)
    with torch.no_grad():
        last, cache = prefill(model, cache, torch.from_numpy(toks))
        full = model(torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(),
                               atol=ATOL, rtol=0)
    assert cache.positions.tolist() == [12, 12]


def test_bf16_rounding_points_track_jax():
    """bf16 activations: the port rounds where the reference rounds, so
    logits stay within bf16 noise of the JAX model's."""
    jc, params, toks = _jax_setup(seed=6, dtype=jnp.bfloat16)
    want = np.asarray(JaxTransformer(jc).apply({"params": params}, toks))
    model = convert.to_module(_port_config(jc),
                              jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    got = model(torch.from_numpy(toks)).numpy()
    # bf16 keeps 8 bits: logits O(1) agree to a few bf16 ulps
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) > 0.9


def test_config_fields_match_jax():
    """Same fields, same order, same defaults (dtypes by name), so any
    reference config or export round-trips into the port."""
    from kubeflow_tpu.models.transformer import TransformerConfig as JaxCfg

    def fields(cls):
        return [(f.name, str(getattr(f.default, "__name__", f.default))
                 .replace("torch.", "")) for f in dataclasses.fields(cls)]

    assert fields(TransformerConfig) == fields(JaxCfg)
    jc = JaxCfg(n_heads=4, n_kv_heads=2, kv_page_size=16, kv_pages=8,
                paged_head_block=2)
    pc = TransformerConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(JaxCfg)})
    pc.validate()
    assert (pc.dtype, pc.param_dtype) == (torch.bfloat16, torch.float32)


def test_unported_configs_raise():
    # MoE is ported: n_experts > 0 builds MoE blocks
    # (tests/test_torch_moe.py holds them against JAX)
    assert hasattr(Transformer(tiny_config(n_experts=4)).blocks[0], "moe")
    # the dense decode cache is ported: kv_page_size 0 builds it
    assert type(init_cache(tiny_config(), 1, device="cpu")).__name__ == \
        "DenseKVCache"
    # the blockwise core is ported, and ring/ulysses without a mesh fall
    # back to it, as the reference's do: the dense logits within 1e-5
    # (tests/test_torch_seq_parallel.py holds them against JAX)
    params = convert.random_params(tiny_config(), 0)
    tokens = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    want = convert.to_module(tiny_config(), params, device="cpu")(tokens)
    for impl in ("blockwise", "ring", "ulysses"):
        model = convert.to_module(dataclasses.replace(
            tiny_config(), attention_impl=impl), params, device="cpu")
        np.testing.assert_allclose(model(tokens).numpy(), want.numpy(),
                                   atol=1e-5, rtol=0, err_msg=impl)
