"""The port's blockwise, ring and Ulysses attention against the JAX
package's (``kubeflow_tpu/ops/attention.py``).

``blockwise_attention`` runs here against the reference's: causal and
not, a block that does not divide the sequence, and its gradients.
Ring and Ulysses run in a 4-rank gloo gang (``tests/torch_gang.py``,
suite ``seq_parallel``) on a ``dp=2 × tp=2`` mesh: each rank's output
block and its share of the gradients against the reference's
``ring_attention_sharded``/``ulysses_attention_sharded`` on
``MeshConfig(dp=2, tp=2)`` over the virtual CPU devices, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jatt
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu_torch.ops import attention as att
from torch_gang import SEQ_CASES, Gang, block, seq_inputs


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("seq_parallel", 4, tmp_path_factory.mktemp("sp-gang"))


@pytest.mark.parametrize("causal,S,T,block_k", [
    (True, 16, 16, 4), (False, 16, 16, 4), (True, 13, 13, 5),
    (False, 12, 12, 32), (True, 6, 12, 5)])
def test_blockwise_matches_jax(causal, S, T, block_k):
    """Forward and the gradients of ``sum(out * ct)``, within 1e-5; a
    block that does not divide the keys, one larger than them, and
    fewer queries than keys (ends aligned)."""
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((2, S, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, T, 3, 8)).astype(np.float32)
    v = rng.standard_normal((2, T, 3, 8)).astype(np.float32)
    ct = rng.standard_normal((2, S, 3, 8)).astype(np.float32)

    def jf(q, k, v):
        return jnp.sum(jatt.blockwise_attention(
            q, k, v, causal=causal, block_k=block_k) * ct)

    want = jatt.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_k=block_k)
    wgrads = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = att.blockwise_attention(tq, tk, tv, causal=causal, block_k=block_k)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for t, w in zip((tq, tk, tv), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0)


def _jax_sharded(core, kv_heads, causal):
    mesh = create_mesh(MeshConfig(dp=2, tp=2), devices=jax.devices()[:4])
    q, k, v, ct = (jnp.asarray(a) for a in seq_inputs(kv_heads))
    fn = (jatt.ring_attention_sharded if core == "ring"
          else jatt.ulysses_attention_sharded)

    def run(q, k, v):
        if core == "ring":
            k, v = jatt.gqa_repeat(q, k, v)
        return fn(q, k, v, mesh, causal=causal)

    def loss(q, k, v):
        out = run(q, k, v)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return mesh, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_parallel_matches_jax(gang, case):
    """Each rank's output block (its batch rows over ``dp``, its
    sequence block over ``tp``) and the sum of the ranks' gradients
    against the reference on the same mesh, within 1e-5. ``ulysses_gqa``
    carries 2 kv heads for 4 q heads through the all-to-all and repeats
    them after it."""
    core, kv_heads, causal = SEQ_CASES[case]
    mesh, want, wgrads = _jax_sharded(core, kv_heads, causal)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    got = gang.case(case)
    for rank, g in enumerate(got):
        _, dp, _, tp = np.argwhere(ids == rank)[0]
        rows = block(want, "rows", 2, dp)
        np.testing.assert_allclose(
            g["out"].numpy(), block(rows, "cols", 2, tp), atol=1e-5,
            rtol=0, err_msg=f"rank {rank}")
    for i, name in enumerate(("dq", "dk", "dv")):
        total = sum(g[name].numpy() for g in got)
        np.testing.assert_allclose(total, wgrads[i], atol=1e-5, rtol=0,
                                   err_msg=name)


class _Mesh:
    mesh_dim_names = ("dcn", "dp", "pp", "tp")

    def size(self, i):
        return (1, 1, 1, 2)[i]


def test_ulysses_refuses_indivisible_heads():
    """Heads the axis does not divide: the reference's error, before any
    exchange."""
    mesh = create_mesh(MeshConfig(dp=2, tp=2), devices=jax.devices()[:4])
    q = jnp.zeros((2, 8, 3, 4))
    with pytest.raises(ValueError) as want:
        jatt.ulysses_attention_sharded(q, q, q, mesh)
    tq = torch.zeros((1, 4, 3, 4))
    with pytest.raises(ValueError) as got:
        att.ulysses_attention(tq, tq, tq, mesh=_Mesh(), axis_name="tp")
    assert str(got.value) == str(want.value)
    tk = torch.zeros((1, 4, 1, 4))
    with pytest.raises(ValueError, match="kv heads 1"):
        att.ulysses_attention(torch.zeros((1, 4, 4, 4)), tk, tk,
                              mesh=_Mesh(), axis_name="tp")
