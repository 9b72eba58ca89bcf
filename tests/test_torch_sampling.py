"""Port samplers against the JAX reference.

- ``fused_sample``: the port's plain version must pick the same token as
  JAX ``ops.sampling.fused_sample`` (Pallas interpreter) row for row,
  given the Gumbel noise JAX's wrapper draws from each row's key
  (rebuilt here exactly as ``sampling.py:163-165`` draws it and handed
  over as numpy — ``jax.random`` and torch never draw the same bits).
- ``sample_logits``: bounded and exact-sort support sets against the
  host oracles of ``tests/test_sampling.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.sampling import fused_sample as jax_fused
from kubeflow_tpu_torch.models.decode import sample_logits
from kubeflow_tpu_torch.ops import sampling as sm

torch.set_num_threads(2)


def _jax_noise(keys, V):
    """The reference wrapper's noise, drawn from the same per-row keys."""
    u = jax.vmap(lambda kk: jax.random.uniform(
        kk, (V,), jnp.float32, minval=1e-20, maxval=1.0))(keys)
    return np.array(-jnp.log(-jnp.log(u)))


# rows: greedy, greedy+filters, top-k, top-p, both, top_p=1 with top-k,
# unfiltered, top-k=1
TEMPS = [0.0, 0.0, 0.8, 1.0, 0.7, 1.3, 1.0, 2.0]
TOPK = [0, 5, 7, 0, 20, 9, 0, 1]
TOPP = [1.0, 0.5, 1.0, 0.9, 0.8, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("V,scale,seed", [(300, 3.0, 0), (1000, 1.0, 1),
                                          (257, 0.3, 2)])
def test_fused_plain_matches_jax_token_for_token(V, scale, seed):
    B = len(TEMPS)
    rng = np.random.default_rng(seed)
    logits = (scale * rng.normal(size=(B, V))).astype(np.float32)
    for step in range(3):
        keys = jax.vmap(lambda s, i: jax.random.fold_in(
            jax.random.key(s), i))(jnp.arange(B) + 10 * seed,
                                   jnp.full((B,), step))
        want = np.asarray(jax_fused(
            jnp.asarray(logits), keys, temperature=jnp.asarray(TEMPS),
            top_k=jnp.asarray(TOPK, jnp.int32), top_p=jnp.asarray(TOPP),
            interpret=True))
        got = sm.fused_sample(
            torch.from_numpy(logits),
            torch.from_numpy(_jax_noise(keys, V)),
            torch.tensor(TEMPS), torch.tensor(TOPK, dtype=torch.int32),
            torch.tensor(TOPP))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_greedy_and_ties_take_first_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    noise = torch.zeros_like(logits)
    out = sm.fused_sample(logits, noise, torch.tensor([0.0, 0.0]), 0, 1.0)
    assert out.tolist() == [1, 0]
    # sampled rows with equal scores break ties on the first index too
    out = sm.fused_sample(logits, noise, torch.tensor([1.0, 1.0]), 0, 1.0)
    assert out.tolist() == [1, 0]


def test_fused_support_sets():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy((3.0 * rng.normal(size=(4, 60)))
                              .astype(np.float32))
    draws = torch.stack([
        sm.fused_sample(logits, sm.gumbel_noise([7] * 4, [s] * 4, 60,
                                                device="cpu"),
                        1.0, 3, 1.0) for s in range(64)])
    top3 = torch.topk(logits, 3).indices
    for b in range(4):
        assert set(draws[:, b].tolist()) <= set(top3[b].tolist())


def test_gumbel_noise_keyed_on_seed_and_step_only():
    a = sm.gumbel_noise([5, 9], [3, 4], 50, device="cpu")
    b = sm.gumbel_noise([1, 5], [0, 3], 50, device="cpu")
    assert torch.equal(a[0], b[1])          # same (seed, step), any row
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(
        a[0], sm.gumbel_noise([5], [4], 50, device="cpu")[0])


def _draws(logits_np, n, **kw):
    logits = torch.from_numpy(logits_np)
    B, V = logits.shape
    return np.stack([
        sample_logits(logits, sm.gumbel_noise(range(B), [i] * B, V,
                                              device="cpu"), **kw).numpy()
        for i in range(n)])


def _nucleus(row, p):
    srt = np.sort(row)[::-1]
    probs = np.exp(srt - srt.max())
    probs /= probs.sum()
    before = np.cumsum(probs) - probs
    return set(np.argsort(-row)[:int((before < p).sum())])


@pytest.mark.parametrize("bound", [None, 16])
def test_sample_logits_support_sets(bound):
    rng = np.random.default_rng(7)
    logits = (3.0 * rng.normal(size=(4, 100))).astype(np.float32)
    out = _draws(logits, 64, temperature=1.0, top_k=5, bound=bound)
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    for b in range(4):
        assert set(out[:, b]) <= set(top5[b])
    out = _draws(logits, 128, temperature=1.0, top_p=0.7, bound=bound)
    for b in range(4):
        support = _nucleus(logits[b], 0.7)
        assert set(out[:, b]) <= support
        if len(support) > 1:
            assert len(set(out[:, b])) > 1
    out = _draws(logits, 32, temperature=np.array([0.0, 1.0, 1.0, 1.0]),
                 top_k=np.array([0, 1, 3, 0]), bound=bound)
    am = np.argmax(logits, -1)
    assert (out[:, 0] == am[0]).all() and (out[:, 1] == am[1]).all()
    assert set(out[:, 2]) <= set(np.argsort(-logits[2])[:3])


@pytest.mark.parametrize("bound", [None, 4])
def test_sample_logits_compose_renormalizes_within_k(bound):
    logits = np.array([[0.0, -0.1, -0.2, -10.0, -10.0]], np.float32)
    out = _draws(logits, 128, temperature=1.0, top_k=3, top_p=0.5,
                 bound=bound)
    assert set(out[:, 0]) == {0, 1}


def test_sample_logits_bounded_edges():
    rng = np.random.default_rng(8)
    flat = rng.normal(scale=0.05, size=(1, 100)).astype(np.float32)
    # unfiltered rows are exact full-vocab categorical: not truncated
    assert len(set(_draws(flat, 256, temperature=1.0, bound=8)[:, 0])) > 8
    # top_k above the bound clamps to the bound
    logits = rng.normal(size=(1, 60)).astype(np.float32)
    out = _draws(logits, 256, temperature=2.0, top_k=50, bound=8)
    assert set(out[:, 0]) <= set(np.argsort(-logits[0])[:8])


def test_sample_logits_top_p_one_is_a_strict_noop():
    """p = 1 keeps every token even where cumsum rounding reaches 1.0:
    same noise, same draw as the unfiltered categorical."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(scale=1e-3, size=(2, 8192))
                              .astype(np.float32))
    for step in range(4):
        g = sm.gumbel_noise([1, 2], [step] * 2, 8192, device="cpu")
        plain = torch.argmax(logits + g, dim=-1).to(torch.int32)
        got = sample_logits(logits, g, temperature=1.0,
                            top_p=torch.tensor([1.0, 1.0]))
        assert torch.equal(got, plain)


def test_exact_sort_and_fused_agree_on_the_same_noise():
    """Both exact samplers keep the same support and draw with the same
    Gumbel-max rule, so the same noise gives the same tokens."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy((2.0 * rng.normal(size=(8, 200)))
                              .astype(np.float32))
    for step in range(4):
        g = sm.gumbel_noise(range(8), [step] * 8, 200, device="cpu")
        kw = dict(temperature=torch.tensor(TEMPS),
                  top_k=torch.tensor(TOPK), top_p=torch.tensor(TOPP))
        a = sample_logits(logits, g, **kw)
        b = sm.fused_sample(logits, g, kw["temperature"],
                            kw["top_k"].int(), kw["top_p"])
        assert torch.equal(a, b)
