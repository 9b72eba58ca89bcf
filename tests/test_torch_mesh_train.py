"""The port's LM and MLM train steps over a mesh against the JAX
package's.

A 4-rank gloo gang (``tests/torch_gang.py``, suite ``mesh_train``)
trains ``tiny_config`` models built over a ``dp=2 × tp=2`` mesh
(``create_sharded_state``) for three steps of ``make_lm_train_step(mesh)``
on the global batch; the JAX package's ``make_lm_train_step(create_mesh(
MeshConfig(dp=2, tp=2)))`` trains the same weights (numpy seeds, carried
across by the converter) on the same tokens here. Loss, ``grad_norm``
and the gathered parameters agree within 1e-5, and each parameter's
movement within 2e-3 of its own size, in each case: the default
config, a binding ``grad_clip``, kv heads that tp does not divide
(replicated), the chunked vocab-parallel loss, a wrapped negative id, an
out-of-range id (NaN where the reference is NaN), and ring attention
(context parallel). Ring and Ulysses logits are held against the
reference's on the same mesh, as ``tests/test_transformer.py`` holds
them against dense. A 2-rank gang (suite ``mlm``) runs
``make_mlm_train_step`` at dp = 2. lr 1e-5, as
``tests/test_torch_bert.py`` explains: AdamW's m/sqrt(v) magnifies f32
summation-order differences on near-zero gradient entries into steps
of up to ~lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Transformer as JaxTransformer
from kubeflow_tpu.models import tiny_config as jax_tiny
from kubeflow_tpu.models.bert import Bert as JaxBert
from kubeflow_tpu.models.bert import BertConfig as JaxBertConfig
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.parallel.mesh import mesh_context
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import make_mlm_train_step as jax_mlm_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import Bert, bert_tiny
from kubeflow_tpu_torch.models.transformer import Transformer, tiny_config
from torch_gang import (
    LOGIT_IMPLS,
    LR,
    OPT,
    STEPS,
    TRAIN_CASES,
    Gang,
    block,
    logit_tokens,
    mlm_inputs,
    train_tokens,
)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("mesh_train", 4, tmp_path_factory.mktemp("train-gang"))


@pytest.fixture(scope="module")
def mlm_gang(tmp_path_factory):
    return Gang("mlm", 2, tmp_path_factory.mktemp("mlm-gang"))


def _mesh(**cfg):
    n = int(np.prod(list(cfg.values())))
    return create_mesh(MeshConfig(**cfg), devices=jax.devices()[:n])


_JAX_STEPS = {}


def _jax_lm(cfg_kw, opt_kw, chunk):
    """One JAX model, optimizer and jitted step a configuration: cases
    that differ only in their tokens share one compile."""
    key = (tuple(sorted(cfg_kw.items())), tuple(sorted(opt_kw.items())),
           chunk)
    if key not in _JAX_STEPS:
        mesh = _mesh(dp=2, tp=2)
        _JAX_STEPS[key] = (
            JaxTransformer(jax_tiny(**cfg_kw), return_hidden=bool(chunk)),
            jax_optimizer(LR, **OPT, **opt_kw), mesh,
            jax_step(mesh, loss_chunk=chunk))
    return _JAX_STEPS[key]


def _jax_run(model, params, tx, mesh, step, batch):
    def init_fn(rng):
        return JaxState.create(apply_fn=model.apply, params=params, tx=tx)

    state, _ = create_sharded_state(init_fn, jax.random.key(0), mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, *batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


# ||Δ - Δ_jax|| / ||Δ_jax|| with Δ = p - p0, a parameter's movement over
# three steps held relative to its own size. A skipped update reads
# ~0.5-1; a sound one is read only as finely as p's own f32 rounding
# against a movement of ~lr a step allows, up to 3.8e-4 on a norm scale
# of ones (PERF.md, Findings, gives the readings)
MOVED_LIMIT = 2e-3


def _check(got, want_metrics, want_params, module, init_params):
    """Every rank's metrics against JAX's, and rank 0's gathered
    parameters against JAX's final ones, NaN where they are NaN; where
    JAX's are finite, each parameter's movement from ``init_params``
    within ``MOVED_LIMIT`` of its own size."""
    for rank, g in enumerate(got):
        for (loss, gnorm, n), (wl, wg, wn) in zip(g["metrics"],
                                                  want_metrics):
            assert n == wn
            np.testing.assert_allclose(loss, wl, atol=1e-5, rtol=0,
                                       err_msg=f"loss, rank {rank}")
            np.testing.assert_allclose(gnorm, wg, rtol=1e-5,
                                       err_msg=f"grad_norm, rank {rank}")
    convert.load_params(module, init_params)
    p0 = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    convert.load_params(module, want_params)
    params = got[0]["params"]
    for name, p in module.named_parameters():
        have, want = params[name].numpy(), p.detach().numpy()
        np.testing.assert_allclose(have, want, atol=1e-5, rtol=0,
                                   err_msg=name)
        if np.isfinite(want).all():
            moved = want - p0[name]
            err = (np.linalg.norm(have - p0[name] - moved) /
                   np.linalg.norm(moved))
            assert err <= MOVED_LIMIT, f"{name}: movement err {err}"


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_lm_train_step_matches_jax(gang, case):
    spec = TRAIN_CASES[case]
    pc = tiny_config(**spec.get("cfg", {}))
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))
    toks = jnp.asarray(train_tokens(case, pc.vocab_size))
    model, tx, mesh, step = _jax_lm(spec.get("cfg", {}), spec.get("opt", {}),
                                    spec.get("loss_chunk"))
    want, want_params = _jax_run(model, params, tx, mesh, step, (toks,))
    if case == "bad_id":
        assert all(np.isnan(w[0]) for w in want)
    else:
        assert all(np.isfinite(w[0]) for w in want)
    if case == "grad_clip":   # the clip binds on every update
        assert all(w[1] > 0.05 for w in want)
    _check(gang.case(f"train/{case}"), want, want_params, Transformer(pc),
           convert.unflatten(convert.random_params(pc, 0)))


@pytest.mark.parametrize("impl", LOGIT_IMPLS)
def test_sequence_parallel_logits_match_jax(gang, impl):
    """Each rank's block of the logits (its rows over dp, its sequence
    block over tp) against the reference model's on the same mesh."""
    pc = tiny_config(attention_impl=impl)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))
    mesh = _mesh(dp=2, tp=2)
    model = JaxTransformer(jax_tiny(attention_impl=impl))
    toks = jnp.asarray(logit_tokens(pc.vocab_size))
    with mesh_context(mesh):
        want = np.asarray(jax.jit(lambda p, t: model.apply(
            {"params": p}, t))(params, toks))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for rank, got in enumerate(gang.case(f"logits/{impl}")):
        _, dp, _, tp = np.argwhere(ids == rank)[0]
        np.testing.assert_allclose(
            got.numpy(), block(block(want, "rows", 2, dp), "cols", 2, tp),
            atol=1e-5, rtol=0, err_msg=f"rank {rank}")


def test_mlm_train_step_matches_jax_at_dp2(mlm_gang):
    cfg = dataclasses.replace(bert_tiny(), dtype="float32")
    jc = JaxBertConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                       n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                       d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len,
                       dtype=jnp.float32, remat=False, scan_layers=False)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_bert_params(cfg, 0)))
    mesh = _mesh(dp=2)
    batch = tuple(jnp.asarray(a) for a in mlm_inputs(cfg.vocab_size))
    want, want_params = _jax_run(JaxBert(jc), params,
                                 jax_optimizer(LR, **OPT), mesh,
                                 jax_mlm_step(mesh), batch)
    got = mlm_gang.case("mlm")
    _check(got, want, want_params, Bert(cfg),
           convert.unflatten(convert.random_bert_params(cfg, 0)))


def test_steps_take_device_feed_rows(gang, mlm_gang):
    """``device_feed(loader, mesh)`` hands each rank its rows wrapped as
    ``RankRows``: the LM step at dp = 2 x tp = 2 and the MLM step at
    dp = 2 take them as they are, so their metrics are those of the same
    global batch passed whole (a batch cut twice would train on a
    quarter or half of it, or be refused)."""
    for want, got in ((gang.case("train/default"), gang.case("feed")),
                      (mlm_gang.case("mlm"), mlm_gang.case("feed"))):
        for rank, (w, g) in enumerate(zip(want, got)):
            assert g == w["metrics"], f"rank {rank}"


def test_one_rank_mesh_splits_nothing():
    """On one rank the mesh splits nothing: the specs name ``tp`` where
    the rules do, every parameter is whole, and the logits are the
    plain model's."""
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig as PMesh
    from kubeflow_tpu_torch.parallel.mesh import create_mesh as pcreate

    mesh = pcreate(PMesh(), device_type="cpu")
    cfg = tiny_config()
    model = convert.to_trainable(cfg, convert.random_params(cfg, 0),
                                 device="cpu", mesh=mesh)
    assert tuple(model.param_specs["blocks.0.attn.q_proj"]) == (None, "tp")
    plain = convert.to_trainable(cfg, convert.random_params(cfg, 0),
                                 device="cpu")
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        assert p.shape == q.shape, name
    toks = torch.from_numpy(logit_tokens(cfg.vocab_size))
    with torch.no_grad():
        np.testing.assert_array_equal(model(toks).numpy(),
                                      plain(toks).numpy())


def test_state_specs_match_jax():
    """``state_partition_specs`` and ``state_shardings`` give each
    parameter (and its AdamW moments) the reference's spec: the rules
    table, then the mesh's axes and divisibility (``dp=2 × tp=4``: the
    two kv heads of ``tiny_config`` replicate)."""
    from kubeflow_tpu.train import state_partition_specs as jax_specs
    from kubeflow_tpu.train import state_shardings as jax_shardings
    from kubeflow_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        state_partition_specs,
        state_shardings,
    )

    class Mesh:   # the port reads a mesh's axis names and sizes
        mesh_dim_names = ("dcn", "dp", "pp", "tp")

        def size(self, i):
            return (1, 2, 1, 4)[i]

    pc = tiny_config()
    params = convert.unflatten(convert.random_params(pc, 0))
    jstate = JaxState.create(apply_fn=None, params=params,
                             tx=jax_optimizer(LR))
    want = jax_specs(jstate)
    want_fit = jax_shardings(jstate, _mesh(dp=2, tp=4))
    state = create_train_state(pc, params, make_optimizer(LR), device="cpu")
    got = state_partition_specs(state)
    got_fit = state_shardings(state, Mesh())
    for name, _ in state.module.named_parameters():
        key, layer = convert._source_key(name, convert.flatten(params))
        parts = key.split("/")
        w, wf = want.params, want_fit.params
        for part in parts:
            w, wf = w[part], wf[part]
        wf = tuple(wf.spec)
        w = tuple(w)
        if layer is not None:      # the stacked layer axis is the reference's
            w, wf = w[1:], wf[1:]
        assert tuple(got["module"][name]) == w, name
        assert tuple(got_fit["module"][name]) == wf, name
    mu = got_fit["opt_state"]["mu"]
    assert [tuple(s) for s in mu] == [
        tuple(got_fit["module"][n]) for n, _ in
        state.module.named_parameters()]
