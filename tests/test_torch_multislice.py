"""The port's multislice workload against the JAX package's train step.

``kubeflow_tpu_torch.testing.multislice_check`` runs in a 4-rank gloo
gang with the operator's env contract, 2 slices (``MEGASCALE_SLICE_ID``
slice-major), at tp 2 (dp 1: the reference's 2 processes × 4 virtual
devices become one rank a device) and at tp 1 (dp 2). Every rank prints
the reference's JSON line; their losses are equal and within 1e-5 of the
JAX package's ``make_lm_train_step`` on the 8-device CPU mesh (dcn 2, dp
2, tp 2), on the same weights (numpy seed, carried across by
``models/convert.py``) and tokens.
"""

import concurrent.futures
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.testing import multislice_check as msc
from kubeflow_tpu_torch.testing import run_multiprocess

RANKS, SLICES = 4, 2


def _gang(tp: int):
    return run_multiprocess(
        ["-m", "kubeflow_tpu_torch.testing.multislice_check", "--device",
         "cpu", "--tp", str(tp)], RANKS,
        env_per_process=[{"MEGASCALE_SLICE_ID": str(r * SLICES // RANKS),
                          "MEGASCALE_NUM_SLICES": str(SLICES)}
                         for r in range(RANKS)],
        timeout_s=110.0, job_name=f"multislice-tp{tp}")


@pytest.fixture(scope="module")
def gangs():
    """Both gangs, started at once, while the JAX oracle runs."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {tp: pool.submit(_gang, tp) for tp in (2, 1)}
    yield futures
    pool.shutdown()


@functools.lru_cache(maxsize=None)
def jax_losses():
    """The JAX package's two steps on the 8-device mesh (dcn 2, dp 2,
    tp 2), the reference's multislice layout."""
    cfg = {**msc.CONFIG, "dtype": jnp.float32}
    model = JaxTransformer(JaxConfig(**cfg))
    params = jax.tree_util.tree_map(jnp.asarray, convert.unflatten(
        convert.random_params(TransformerConfig(**msc.CONFIG),
                              msc.WEIGHT_SEED)))
    tx = jax_optimizer(**msc.OPT)
    mesh = create_mesh(MeshConfig(dcn=2, dp=2, tp=2))

    def init_fn(rng):
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    state, _ = create_sharded_state(init_fn, jax.random.key(0), mesh)
    step = jax_step(mesh)
    tokens = jnp.asarray(msc.tokens())
    losses = []
    for _ in range(msc.STEPS):
        state, m = step(state, tokens)
        losses.append(float(m["loss"]))
    return tuple(losses)


@pytest.mark.parametrize("tp", [2, 1])
def test_multislice_check_across_ranks_matches_jax(gangs, tp):
    want = jax_losses()
    outs = []
    for r in gangs[tp].result():
        assert r.returncode == 0, (
            f"rank {r.process_id} failed:\n{r.stderr[-2000:]}")
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for rank, o in enumerate(outs):
        assert o["ok"] and o["processes"] == RANKS and o["devices"] == RANKS
        assert o["process_id"] == rank
        assert o["slice_id"] == rank * SLICES // RANKS
        assert o["mesh"] == {"dcn": SLICES, "dp": RANKS // SLICES // tp,
                             "pp": 1, "tp": tp}
    # every rank holds the same, replicated losses
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    np.testing.assert_allclose(outs[0]["losses"], want, atol=1e-5, rtol=0)
    assert len(want) == msc.STEPS and np.isfinite(want).all()


def test_tokens_and_batch_are_the_references():
    """8 rows of 16 tokens (the reference's ``2·dcn·dp`` at its 2 × 4
    layout), the same every call."""
    toks = msc.tokens()
    assert toks.shape == (msc.BATCH, msc.SEQ) == (8, 16)
    assert toks.dtype == np.int32
    assert 0 <= toks.min() and toks.max() < msc.CONFIG["vocab_size"]
    np.testing.assert_array_equal(toks, msc.tokens())
