"""The port's greedy speculative decoding against the JAX package's.

Counterparts of ``tests/test_speculative.py`` (the sharded-mesh case
waits for the port's mesh): the same numpy-derived f32 weights go
through ``kubeflow_tpu.models.decode.speculative_generate`` and the
port's ``speculative_generate`` (and its ``_fused``/``_jit`` names) on
the CPU; tokens must equal both packages' greedy ``generate`` and
JAX's speculative stream token for token, with the same ``stats``, on
single and ragged batches, at the context's slack edge, and with the
same validation messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.models.decode import generate as jax_generate
from kubeflow_tpu.models.decode import speculative_generate as jax_spec
from kubeflow_tpu.serving.model_store import transformer_export_config
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.decode import (
    generate,
    speculative_generate,
    speculative_generate_fused,
    speculative_generate_jit,
)
from kubeflow_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)

torch.set_num_threads(2)
SPECS = (speculative_generate, speculative_generate_fused,
         speculative_generate_jit)


def _mk(seed, **kw):
    base = dict(vocab_size=61, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, max_seq_len=64, dtype=jnp.float32,
                remat=False)
    base.update(kw)
    jc = JaxConfig(**base)
    params = JaxTransformer(jc).init(
        jax.random.key(seed), np.zeros((1, 8), np.int32))["params"]
    pc = TransformerConfig(**transformer_export_config(jc))
    model = convert.to_module(pc, jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    return jc, params, model


@pytest.fixture(scope="module")
def models():
    target = _mk(0)
    draft = _mk(1, d_model=16, n_layers=1, n_heads=2, d_ff=32)
    # a draft that shares the target's lower layer: it accepts often
    half = _mk(0, n_layers=1)
    return target, draft, half


def _ragged():
    prompts = [[5, 11, 17], [9, 2], [40, 41, 42, 43]]
    arr = np.zeros((3, 4), np.int32)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        arr[i, :len(p)] = p
    return prompts, arr, lens


@pytest.mark.parametrize("k", [1, 2, 4, 7])
@pytest.mark.parametrize("which", ["random_draft", "sharing_draft"])
def test_matches_greedy_and_jax(models, k, which):
    (tc, tp, tm), (dc, dp, dm), (hc, hp, hm) = models
    dc, dp, dm = (dc, dp, dm) if which == "random_draft" else (hc, hp, hm)
    prompt = np.asarray([[5, 11, 17, 3]], np.int32)
    want = np.asarray(jax_generate(tc, tp, jnp.asarray(prompt),
                                   max_new_tokens=12))
    jtoks, jstats = jax_spec(tc, tp, dc, dp, jnp.asarray(prompt),
                             max_new_tokens=12, draft_len=k)
    greedy = generate(tm, torch.from_numpy(prompt), max_new_tokens=12)
    np.testing.assert_array_equal(greedy.numpy(), want)
    for spec in SPECS:
        toks, stats = spec(tm, dm, torch.from_numpy(prompt),
                           max_new_tokens=12, draft_len=k)
        assert toks.dtype == torch.int32 and toks.shape == (1, 12)
        np.testing.assert_array_equal(toks.numpy(), want)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        assert stats == jstats, spec.__name__
        assert all(type(v) is int for v in stats.values())
        assert stats["draft_tokens"] == stats["rounds"] * k
        assert 0 <= stats["accepted"] <= stats["draft_tokens"]


def test_ragged_batch_matches_per_row_and_jax(models):
    """Per-row acceptance: each row equals its solo greedy decode, and
    the batch equals JAX's speculative stream with the same stats."""
    (tc, tp, tm), _, (hc, hp, hm) = models
    prompts, arr, lens = _ragged()
    jtoks, jstats = jax_spec(tc, tp, hc, hp, jnp.asarray(arr),
                             max_new_tokens=10, draft_len=3,
                             true_len=jnp.asarray(lens))
    toks, stats = speculative_generate(tm, hm, torch.from_numpy(arr),
                                       max_new_tokens=10, draft_len=3,
                                       true_len=torch.from_numpy(lens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert stats == jstats
    for i, p in enumerate(prompts):
        want = generate(tm, torch.tensor([p], dtype=torch.int32),
                        max_new_tokens=10)[0]
        assert torch.equal(toks[i], want), i


def test_perfect_draft_accepts_everything(models):
    """Draft == target: every proposal is accepted, and 12 tokens take
    1 from the prefill + ceil(11 / 4) = 3 rounds."""
    (tc, tp, tm), _, _ = models
    prompt = np.asarray([[5, 11, 17, 3]], np.int32)
    toks, stats = speculative_generate(tm, tm, torch.from_numpy(prompt),
                                       max_new_tokens=12, draft_len=4)
    want = generate(tm, torch.from_numpy(prompt), max_new_tokens=12)
    assert torch.equal(toks, want)
    assert stats == {"rounds": 3, "draft_tokens": 12, "accepted": 12}
    _, jstats = jax_spec(tc, tp, tc, tp, jnp.asarray(prompt),
                         max_new_tokens=12, draft_len=4)
    assert stats == jstats


class RowBlindDraft(Transformer):
    """The target's weights, but row 1's proposals are pushed to token
    0: row 0 accepts every proposal, row 1 (almost) none."""

    def forward(self, tokens, cache=None, **kw):
        logits = super().forward(tokens, cache, **kw)
        logits[1:] = 0.0
        logits[1:, ..., 0] = 1.0
        return logits


def test_overshoot_past_the_context_writes_nothing(models):
    """At the slack edge (longest prompt + max_new + draft_len ==
    max_seq_len) a fast row keeps stepping while a slow row catches
    up, so its verify and draft writes run far past ``max_seq_len``.
    They must land nowhere: every row still equals its solo greedy
    decode, and the target's cache holds no write past any row's
    context."""
    (tc, tp, tm), _, _ = models
    k, max_new = 4, 20
    c = tm.config
    fast = list(range(1, c.max_seq_len - max_new - k + 1))   # 40 tokens
    slow = [7, 3]
    arr = np.zeros((2, len(fast)), np.int32)
    arr[0], arr[1, :2] = fast, slow
    lens = np.asarray([len(fast), 2], np.int32)
    draft = RowBlindDraft(c)
    draft.load_state_dict(tm.state_dict())
    draft.eval()
    toks, stats = speculative_generate(tm, draft, torch.from_numpy(arr),
                                       max_new_tokens=max_new,
                                       draft_len=k,
                                       true_len=torch.from_numpy(lens))
    # the fast row ran rounds past its need: positions beyond the end
    assert stats["rounds"] * k > c.max_seq_len - len(fast)
    for i, p in enumerate((fast, slow)):
        want = np.asarray(jax_generate(tc, tp, jnp.asarray([p], jnp.int32),
                                       max_new_tokens=max_new))[0]
        np.testing.assert_array_equal(toks[i].numpy(), want, err_msg=i)
    with pytest.raises(ValueError, match="slack"):
        speculative_generate(tm, draft, torch.from_numpy(arr),
                             max_new_tokens=max_new + 1, draft_len=k,
                             true_len=torch.from_numpy(lens))


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validation_messages_match_jax(models):
    (tc, tp, tm), (dc, dp, dm), _ = models
    long_prompt = np.asarray([[1] * 50], np.int32)
    other = _mk(2, vocab_size=37)
    cases = [
        (long_prompt, dict(max_new_tokens=12, draft_len=4), (dc, dp, dm)),
        (np.asarray([[1, 2]], np.int32), dict(max_new_tokens=4), other),
        (np.asarray([[1, 2]], np.int32),
         dict(max_new_tokens=4, draft_len=0), (dc, dp, dm)),
    ]
    for prompt, kw, (xc, xp, xm) in cases:
        want = _message(lambda: jax_spec(tc, tp, xc, xp,
                                         jnp.asarray(prompt), **kw))
        for spec in SPECS:
            got = _message(lambda: spec(tm, xm, torch.from_numpy(prompt),
                                        **kw))
            assert got == want
    assert "slack" in _message(lambda: speculative_generate(
        tm, dm, torch.from_numpy(long_prompt), max_new_tokens=12))
