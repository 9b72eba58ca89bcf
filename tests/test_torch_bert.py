"""The port's BERT encoder, MLM loss and MLM train step against the JAX
package, on the CPU.

The same numpy-seeded inputs and the same weights go through
``kubeflow_tpu`` (JAX on the CPU, as ``tests/test_bert.py`` runs it:
``attention_impl="auto"`` is its dense path, and ``"flash"`` runs its
Pallas kernels in interpret mode) and ``kubeflow_tpu_torch``
(``"auto"`` is dense on CPU tensors; ``"flash"`` takes the flash
kernels' plain versions). All at f32 within 1e-5, comparing only the
valid positions where ``seq_lengths`` pads a row (the reference calls
padded outputs unspecified).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.bert import Bert as JaxBert
from kubeflow_tpu.models.bert import BertConfig as JaxBertConfig
from kubeflow_tpu.models.bert import bert_base as jax_bert_base
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_mlm_train_step as jax_mlm_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu.train import masked_lm_loss as jax_mlm_loss
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import (
    MASK_TOKEN_ID,
    Bert,
    BertConfig,
    bert_base,
    bert_tiny,
    mask_tokens,
)
from kubeflow_tpu_torch.train import (
    create_bert_train_state,
    make_mlm_train_step,
    make_optimizer,
    masked_lm_loss,
)

torch.set_num_threads(2)

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq_len=64)
B, S = 2, 32
LENGTHS = np.array([20, 32], np.int32)


def _jax_bert(scan_layers, remat=False):
    cfg = JaxBertConfig(dtype=jnp.float32, scan_layers=scan_layers,
                        remat=remat, **TINY)
    model = JaxBert(cfg)
    params = model.init(jax.random.key(0),
                        jnp.zeros((B, S), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_config(scan_layers=True, **kw):
    base = dict(dtype="float32", scan_layers=scan_layers, remat=False)
    base.update(kw)
    return BertConfig(**TINY, **base)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    types = (np.arange(S)[None, :] >= rng.integers(4, S, (B, 1))
             ).astype(np.int32)
    return tokens, types


def _valid(x, lengths):
    """The rows' valid positions, concatenated."""
    return np.concatenate([x[b, :n] for b, n in enumerate(lengths)])


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("case", ["tokens", "types", "lengths",
                                  "types+lengths"])
@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_logits_match_jax(scan_layers, case, impl):
    """Forward logits against JAX ``Bert`` in both param layouts, with
    and without token types and ``seq_lengths``, through the port's
    dense and flash paths."""
    model, params = _jax_bert(scan_layers)
    tokens, types = _inputs()
    kw = {}
    if "types" in case:
        kw["token_types"] = types
    if "lengths" in case:
        kw["seq_lengths"] = LENGTHS
    want = np.asarray(model.apply({"params": params}, tokens, **kw))
    pm = convert.bert_to_module(_port_config(scan_layers,
                                             attention_impl=impl),
                                params, device="cpu")
    got = pm(torch.from_numpy(tokens),
             **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == (B, S, TINY["vocab_size"]) and got.dtype == np.float32
    lengths = LENGTHS if "lengths" in case else [S] * B
    np.testing.assert_allclose(_valid(got, lengths), _valid(want, lengths),
                               atol=1e-5, rtol=0)


def _mlm_batch(seed=2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    live = (np.arange(S)[None, :] < LENGTHS[:, None])
    weights = ((rng.random((B, S)) < 0.3) & live).astype(np.float32)
    tokens = np.where(weights > 0, MASK_TOKEN_ID, labels).astype(np.int32)
    return tokens, labels, weights


@pytest.mark.parametrize("remat", [False, True])
def test_flash_matches_dense_with_padding(remat):
    """The port's flash path (plain versions on the CPU) against its
    dense path with ``seq_lengths``: logits at valid positions, the MLM
    loss with padding weighted out, and every gradient, within 1e-5."""
    _, params = _jax_bert(True)
    tokens, labels, weights = (torch.from_numpy(a) for a in _mlm_batch())
    lens = torch.from_numpy(LENGTHS)
    out = {}
    for impl in ("dense", "flash"):
        m = convert.bert_to_trainable(
            _port_config(attention_impl=impl, remat=remat), params,
            device="cpu")
        logits = m(tokens, seq_lengths=lens)
        loss = masked_lm_loss(logits, labels, weights)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out[impl] = (logits.detach().numpy(), loss.item(), grads)
    (ld, lossd, gd), (lf, lossf, gf) = out["dense"], out["flash"]
    np.testing.assert_allclose(_valid(lf, LENGTHS), _valid(ld, LENGTHS),
                               atol=1e-5, rtol=0)
    assert abs(lossf - lossd) <= 1e-5
    for a, b in zip(gf, gd):
        assert b.abs().max() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_flash_path_matches_jax_flash_kernels():
    """The port's flash path against JAX ``Bert(attention_impl="flash")``,
    whose Pallas kernels run in interpret mode on the CPU, with
    ``seq_lengths``: logits at valid positions, the MLM loss and every
    gradient within 1e-5."""
    _, params = _jax_bert(True)
    jflash = JaxBert(JaxBertConfig(dtype=jnp.float32, remat=False,
                                   attention_impl="flash", **TINY))
    tokens, labels, weights = _mlm_batch()

    def jax_loss(p):
        logits = jflash.apply({"params": p}, tokens, seq_lengths=LENGTHS)
        return jax_mlm_loss(logits, labels, weights), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    m = convert.bert_to_trainable(_port_config(attention_impl="flash"),
                                  params, device="cpu")
    logits = m(torch.from_numpy(tokens),
               seq_lengths=torch.from_numpy(LENGTHS))
    loss = masked_lm_loss(logits, torch.from_numpy(labels),
                          torch.from_numpy(weights))
    grads = torch.autograd.grad(loss, list(m.parameters()))
    np.testing.assert_allclose(_valid(logits.detach().numpy(), LENGTHS),
                               _valid(np.asarray(want_logits), LENGTHS),
                               atol=1e-5, rtol=0)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    with torch.no_grad():
        for p, g in zip(m.parameters(), grads):
            p.copy_(g)
    got = convert.flatten(convert.bert_params(m))
    for key, val in convert.flatten(
            jax.tree_util.tree_map(np.asarray, want_grads)).items():
        np.testing.assert_allclose(got[key], val, atol=1e-5, rtol=0,
                                   err_msg=key)


def test_attention_is_bidirectional():
    """A change at a LATER position moves an EARLIER position's logits
    (the contrast with the causal LM), on both attention paths."""
    _, params = _jax_bert(False)
    tokens, _ = _inputs(3)
    changed = tokens.copy()
    changed[0, 30] = (tokens[0, 30] + 1) % TINY["vocab_size"]
    for impl in ("dense", "flash"):
        m = convert.bert_to_module(_port_config(False, attention_impl=impl),
                                   params, device="cpu")
        a = m(torch.from_numpy(tokens)).numpy()
        b = m(torch.from_numpy(changed)).numpy()
        assert np.abs(a[0, 3] - b[0, 3]).max() > 1e-4, impl
        np.testing.assert_array_equal(a[1], b[1])


def test_padding_blocks_pad_tokens():
    """A token past a row's length reaches no valid position, on both
    paths (the mask is real)."""
    _, params = _jax_bert(True)
    tokens, _ = _inputs(4)
    poisoned = tokens.copy()
    poisoned[0, 25] = (tokens[0, 25] + 7) % TINY["vocab_size"]
    lens = torch.from_numpy(LENGTHS)
    for impl in ("dense", "flash"):
        m = convert.bert_to_module(_port_config(attention_impl=impl),
                                   params, device="cpu")
        a = m(torch.from_numpy(tokens), seq_lengths=lens).numpy()
        b = m(torch.from_numpy(poisoned), seq_lengths=lens).numpy()
        np.testing.assert_allclose(a[0, :20], b[0, :20], atol=1e-6,
                                   rtol=0)
        # without the mask the poisoned token does reach them
        c = m(torch.from_numpy(poisoned)).numpy()
        assert np.abs(c[0, :20] - a[0, :20]).max() > 1e-4


def test_kv_len_refused_by_other_attention_cores():
    m = Bert(_port_config(attention_impl="blockwise"))
    with pytest.raises(ValueError, match="kv_len padding mask"):
        m(torch.zeros((1, 8), dtype=torch.int32),
          seq_lengths=torch.tensor([5]))


@pytest.mark.parametrize("weights", ["masked", "zeros"])
def test_masked_lm_loss_matches_jax(weights):
    """Loss and its gradient against JAX's ``masked_lm_loss``, with all
    weights zero too (the denominator floors at 1: loss 0)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    w = ((rng.random((3, 7)) < 0.4).astype(np.float32)
         if weights == "masked" else np.zeros((3, 7), np.float32))
    want, gwant = jax.value_and_grad(jax_mlm_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = masked_lm_loss(t, torch.from_numpy(labels), torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gwant),
                               atol=1e-6, rtol=0)
    if weights == "zeros":
        assert got.item() == 0.0


def test_mask_tokens_semantics():
    """MASK where the weight is 1, the label elsewhere, a rate near
    0.15, and the same draw from the same generator seed."""
    labels = torch.from_numpy(np.random.default_rng(6).integers(
        5, 1000, (16, 128)).astype(np.int32))
    masked, w = mask_tokens(torch.Generator().manual_seed(3), labels)
    assert masked.dtype == labels.dtype and w.dtype == torch.float32
    m = w.bool()
    assert bool((masked[m] == MASK_TOKEN_ID).all())
    assert bool((masked[~m] == labels[~m]).all())
    assert 0.13 < w.mean().item() < 0.17
    again, w2 = mask_tokens(torch.Generator().manual_seed(3), labels)
    assert torch.equal(again, masked) and torch.equal(w2, w)
    _, w3 = mask_tokens(torch.Generator().manual_seed(3), labels,
                        mask_prob=0.5)
    assert 0.45 < w3.mean().item() < 0.55


@pytest.mark.parametrize("remat,scan_layers", [(False, True), (True, True),
                                               (True, False)],
                         ids=["scanned", "scanned-remat", "unrolled-remat"])
def test_mlm_train_step_matches_jax(remat, scan_layers):
    """Three steps of ``make_mlm_train_step`` against JAX's on a
    one-device mesh, f32: loss and grad_norm each step, then every
    parameter, within 1e-5. lr 1e-5: the gradients agree within ~1e-7,
    but AdamW's m/sqrt(v) magnifies that on near-zero gradient entries
    into a step of up to ~lr, so the parameter error grows with lr (at
    the example's 1e-4, 8 of 4096 ``mlm_transform`` entries differ by
    up to 5.3e-5 after three steps)."""
    model, _ = _jax_bert(scan_layers, remat)
    tokens, labels, weights = _mlm_batch(7)
    mesh = create_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    tx = jax_optimizer(1e-5, warmup_steps=1, decay_steps=50)

    def init_fn(rng):
        params = model.init(rng, jnp.asarray(tokens))["params"]
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    jstate, _ = create_sharded_state(init_fn, jax.random.key(1), mesh)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstep = jax_mlm_step(mesh)
    state = create_bert_train_state(
        _port_config(scan_layers, remat=remat), params0,
        make_optimizer(1e-5, warmup_steps=1, decay_steps=50), device="cpu")
    step = make_mlm_train_step()
    for i in range(3):
        jstate, jm = jstep(jstate, tokens, labels, weights)
        state, m = step(state, tokens, labels, weights)
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = convert.flatten(convert.bert_params(state.module,
                                              scan_layers=scan_layers))
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=1e-5, rtol=0,
                                   err_msg=key)


def test_bf16_compute_trains_every_parameter():
    """bf16 activations over f32 params: every parameter gets a nonzero
    f32 gradient (type_embed's unused segment row aside), and the loss
    sits near JAX's bf16 loss."""
    _, params = _jax_bert(True)
    jbf = JaxBert(JaxBertConfig(scan_layers=True, remat=False, **TINY))
    tokens, labels, weights = _mlm_batch(8)
    want = float(jax_mlm_loss(jbf.apply({"params": params}, tokens),
                              labels, weights))
    m = convert.bert_to_trainable(
        BertConfig(**TINY, remat=True, attention_impl="flash"), params,
        device="cpu")
    loss = masked_lm_loss(m(torch.from_numpy(tokens)),
                          torch.from_numpy(labels), torch.from_numpy(weights))
    assert abs(loss.item() - want) < 5e-2
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.parameters()))
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32, name
        live = g[0] if name == "type_embed" else g
        assert live.abs().max() > 0, name


def test_random_params_fit_jax_trees_and_round_trip():
    """``random_bert_params`` gives the JAX tree's keys and shapes in
    both layouts (BERT-base's full tree too, by shape only: 110 M
    params), and ``bert_params`` takes a loaded module back bit for
    bit."""
    for scan in (True, False):
        _, params = _jax_bert(scan)
        want = convert.flatten(params)
        rp = convert.random_bert_params(_port_config(scan), 0)
        assert {k: v.shape for k, v in rp.items()} == {
            k: v.shape for k, v in want.items()}
        m = convert.bert_to_module(_port_config(scan), rp, device="cpu")
        back = convert.flatten(convert.bert_params(m, scan_layers=scan))
        for k, v in rp.items():
            np.testing.assert_array_equal(back[k], v)
    shapes = convert.flatten(jax.eval_shape(
        lambda: JaxBert(jax_bert_base()).init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"])
    with torch.device("meta"):
        port = Bert(bert_base())
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == sum(int(np.prod(s.shape)) for s in shapes.values())
    assert shapes["blocks/attn/q_proj"].shape == (12, 768, 12, 64)
    assert bert_tiny().n_layers == 2 and n_port > 100_000_000
