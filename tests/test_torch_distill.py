"""The port's draft acquisition (``train/distill.py``) against the JAX
package's, on the CPU at f32.

- ``truncate_draft``: the same strided layer indices and exactly the
  target's parameters for them (embedding and final norm too), as
  copies: training the draft leaves the target bit for bit;
- ``distill_draft`` on one injected corpus: the three steps' losses
  within 1e-5 of JAX's (the same ``default_rng`` rows, ``optax.adamw``
  at its defaults against the port's ``AdamW``) and the trained draft's
  parameters within 1e-5;
- ``make_draft``'s stats keys, the self-sampled corpus clamped to the
  context, and the validation errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.serving.model_store import transformer_export_config
from kubeflow_tpu.train import distill as jax_distill
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.train import distill

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def target():
    jc = JaxConfig(vocab_size=61, d_model=32, n_layers=4, n_heads=4,
                   n_kv_heads=2, d_ff=64, max_seq_len=64,
                   dtype=jnp.float32, remat=False)
    params = JaxTransformer(jc).init(
        jax.random.key(0), np.zeros((1, 8), np.int32))["params"]
    pc = TransformerConfig(**transformer_export_config(jc))
    return jc, params, pc


def _port(pc, params):
    return convert.to_trainable(
        pc, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _tree(model, pc):
    return convert.bert_params(model, scan_layers=pc.scan_layers)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_truncation_matches_jax_and_copies(target, n):
    jc, params, pc = target
    jdc, jdp = jax_distill.truncate_draft(jc, params, n)
    model = _port(pc, params)
    before = {k: v.detach().clone() for k, v in
              model.state_dict().items()}
    dc, draft = distill.truncate_draft(pc, model, n)
    assert dc.n_layers == jdc.n_layers and dc.remat is False
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, jdp))
    got = convert.flatten(_tree(draft, dc))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the draft owns its tensors: a step on it leaves the target alone
    for p in draft.parameters():
        assert all(p.data_ptr() != q.data_ptr() for q in model.parameters())
    with torch.no_grad():
        for p in draft.parameters():
            p.add_(1.0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_distill_losses_and_draft_match_jax(target):
    """Three steps on an injected corpus: both packages draw the same
    rows from ``default_rng(seed)``; first and last loss within 1e-5,
    the trained draft within 1e-5 (lr 1e-4: AdamW turns f32 summation
    noise on near-zero gradients into steps of ~lr)."""
    jc, params, pc = target
    corpus = np.random.default_rng(4).integers(
        0, jc.vocab_size, (12, 16)).astype(np.int32)
    jdc, jdp = jax_distill.truncate_draft(jc, params, 2)
    model = _port(pc, params)
    dc, draft = distill.truncate_draft(pc, model, 2)
    losses = {}
    for steps in (1, 3):
        _, jstats = jax_distill.distill_draft(
            jc, params, jdc, jdp, corpus, steps=steps, batch=4, lr=1e-4,
            seed=5)
        losses[steps] = jstats
    jtrained, _ = jax_distill.distill_draft(jc, params, jdc, jdp, corpus,
                                            steps=3, batch=4, lr=1e-4,
                                            seed=5)
    draft, stats = distill.distill_draft(pc, model, dc, draft, corpus,
                                         steps=3, batch=4, lr=1e-4, seed=5)
    assert set(stats) == {"first_loss", "last_loss"}
    np.testing.assert_allclose(stats["first_loss"],
                               losses[1]["last_loss"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(stats["last_loss"], losses[3]["last_loss"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(stats["first_loss"],
                               losses[3]["first_loss"], atol=1e-4, rtol=0)
    want = convert.flatten(jax.tree_util.tree_map(np.asarray, jtrained))
    got = convert.flatten(_tree(draft, dc))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0,
                                   err_msg=key)


def test_distill_unrounded_losses_match_jax(target, monkeypatch):
    """The per-step losses before rounding: within 1e-5 for 3 steps."""
    jc, params, pc = target
    corpus = np.random.default_rng(9).integers(
        0, jc.vocab_size, (6, 12)).astype(np.int32)
    seen = {"jax": [], "port": []}
    real_round = round

    def spy(key):
        def fake_round(x, nd=None):
            seen[key].append(float(x))
            return real_round(x, nd)
        return fake_round

    jdc, jdp = jax_distill.truncate_draft(jc, params, 3)
    for steps in (1, 2, 3):
        monkeypatch.setattr(jax_distill, "round", spy("jax"),
                            raising=False)
        jax_distill.distill_draft(jc, params, jdc, jdp, corpus,
                                  steps=steps, batch=3, lr=1e-3, seed=1)
    monkeypatch.setattr(distill, "round", spy("port"), raising=False)
    model = _port(pc, params)
    dc, draft = distill.truncate_draft(pc, model, 3)
    distill.distill_draft(pc, model, dc, draft, corpus, steps=3, batch=3,
                          lr=1e-3, seed=1)
    jax_last = seen["jax"][1::2]          # last_loss after 1, 2, 3 steps
    port = seen["port"]                   # first_loss, last_loss
    np.testing.assert_allclose(port[0], jax_last[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(port[1], jax_last[2], atol=1e-5, rtol=0)


def test_make_draft_one_call(target):
    """The corpus self-sampled from the target (clamped to its context),
    then distilled; the stats keys are the reference's."""
    jc, params, pc = target
    model = _port(pc, params)
    dc, draft, stats = distill.make_draft(
        pc, model, n_layers=2, distill_steps=4, corpus_seqs=4,
        corpus_len=4 * pc.max_seq_len, batch=2)
    _, _, jstats = jax_distill.make_draft(
        jc, params, n_layers=2, distill_steps=0)
    assert set(stats) == set(jstats) | {"first_loss", "last_loss"}
    assert stats["n_layers"] == dc.n_layers == 2
    assert stats["first_loss"] > 0 and stats["last_loss"] >= 0
    _, _, none = distill.make_draft(pc, model, n_layers=2, distill_steps=0)
    assert none == jstats == {"first_loss": 0.0, "last_loss": 0.0,
                              "n_layers": 2}
    corpus = distill.sample_corpus(pc, model, n_seqs=3, seq_len=10, seed=2)
    assert corpus.shape == (3, 10) and corpus.dtype == np.int32
    assert corpus.min() >= 0 and corpus.max() < pc.vocab_size
    again = distill.sample_corpus(pc, model, n_seqs=3, seq_len=10, seed=2)
    np.testing.assert_array_equal(corpus, again)


def test_validation_matches_jax(target):
    jc, params, pc = target
    model = _port(pc, params)
    for n in (0, 9):
        with pytest.raises(ValueError) as want:
            jax_distill.truncate_draft(jc, params, n)
        with pytest.raises(ValueError) as got:
            distill.truncate_draft(pc, model, n)
        assert str(got.value) == str(want.value)
    jc2 = JaxConfig(**{**jc.__dict__, "scan_layers": False})
    pc2 = TransformerConfig(**{**transformer_export_config(jc),
                               "scan_layers": False})
    with pytest.raises(ValueError) as want:
        jax_distill.truncate_draft(jc2, params, 2)
    with pytest.raises(ValueError) as got:
        distill.truncate_draft(pc2, model, 2)
    assert str(got.value) == str(want.value)
    dc, draft = distill.truncate_draft(pc, model, 2)
    bad = np.zeros((4,), np.int32)
    with pytest.raises(ValueError) as want:
        jax_distill.distill_draft(jc, params, jc, params, bad)
    with pytest.raises(ValueError) as got:
        distill.distill_draft(pc, model, dc, draft, bad)
    assert str(got.value) == str(want.value)
