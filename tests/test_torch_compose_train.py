"""Every training mesh composition the reference accepts, against the
JAX package.

Three gloo gangs (``tests/torch_gang.py``, suite ``compose_train``)
train on the CPU at f32 from numpy-seeded weights, 2, 4 and 8 ranks,
while the pytest process runs the JAX package's steps on its host mesh:

- context parallelism with MoE (``attention_impl`` ring or Ulysses over
  ``tp``, 4 experts, dense or capacity dispatch, and capacity 0.25 so
  most choices drop): three ``make_lm_train_step`` steps at ``tp=2`` and
  ``dp=2 × tp=2`` (the experts split over ``dp``) against JAX's on its
  ``dp=2,tp=2`` mesh: loss and ``grad_norm`` within 1e-5, the gathered
  parameters within 1e-5 (and each one's movement within 2e-3 of its
  own size, ``tests/test_torch_mesh_train.py``);
- the capacity dispatch alone, the rows over ``dp`` and each row's
  positions over ``tp``: every token's slots (so every dropped token)
  and the load-balance loss equal to JAX's ``capacity_dispatch`` of the
  whole batch;
- the sequence over a data axis (``seq_axis="dp"``, at ``dp=2`` and with
  ``tp`` splitting the heads at ``dp=2 × tp=2``) and over ``pp`` on a
  model every rank holds whole, against JAX's steps with the same
  ``seq_axis``;
- ring and Ulysses inside the pipeline (``pp=2 × tp=2``, the sequence
  over ``tp``): the pipelined forward's logits against JAX's on its
  ``pp=2,tp=2`` mesh, which runs ring inside its pipeline's
  ``shard_map``; the reference's pipelined train step fails to lower
  them, and the port's refuses them;
- the MLM step (``bert_tiny``) and the image step (ViT, fused ResNet,
  the MNIST CNN) over ``pp=2``, ``dp=2 × pp=2`` and ``dp=2 × pp=2 ×
  tp=2``: every layer on every rank, the stage ranks computing their
  data rank's rows, against JAX's steps on its ``dp=2,pp=2,tp=2`` mesh;
- the entry points ``examples/{bert,vit,resnet,mnist}.py`` train under
  ``launcher_init(pp=2)``'s mesh.
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
from kubeflow_tpu.ops.moe import capacity_dispatch as jax_dispatch
from kubeflow_tpu.parallel.mesh import mesh_context
from kubeflow_tpu.parallel.pipeline import make_pipelined_lm_forward
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import make_mlm_train_step as jax_mlm_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import Bert
from kubeflow_tpu_torch.models.transformer import Transformer, tiny_config
from test_torch_encoder_tp import PARAM_LIMIT, _bert
from test_torch_image_mesh import _jax_run as _jax_image_run
from test_torch_image_mesh import _port_flat
from test_torch_mesh_train import _check, _jax_run, _mesh
from torch_gang import (
    COMPOSE_IMAGE_CASES,
    COMPOSE_MOE,
    COMPOSE_MOE_OPT,
    COMPOSE_TRAIN_MESHES,
    CP_IMPLS,
    DISPATCH_C,
    DISPATCH_K,
    ENTRY_PP,
    LR,
    MOE_EXPERTS,
    OPT,
    PIPE_LAYERS,
    Gang,
    block,
    dispatch_logits,
    mlm_inputs,
    pipe_tokens,
    train_tokens,
)

WORLDS = list(COMPOSE_TRAIN_MESHES)
LIMIT = 1e-5


def _cases(kind):
    return [(n, m) for n in WORLDS for m in COMPOSE_TRAIN_MESHES[n][kind]]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return {n: Gang("compose_train", n, tmp_path_factory.mktemp(f"ct{n}"))
            for n in WORLDS}


_LM_RUNS = {}


def _jax_lm(cfg_kw, opt_kw, mesh_kw):
    """The JAX package's three LM steps from the port's weights, once a
    configuration: metrics and final parameters."""
    key = (tuple(sorted(cfg_kw.items())), tuple(sorted(opt_kw.items())),
           tuple(sorted(mesh_kw.items())))
    if key not in _LM_RUNS:
        pc = tiny_config(**cfg_kw)
        params = jax.tree_util.tree_map(
            jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))
        model = JaxTransformer(jax_tiny(**cfg_kw))
        tx = jax_optimizer(LR, **OPT, **opt_kw)
        mesh = _mesh(**mesh_kw)
        toks = (jnp.asarray(train_tokens("default", pc.vocab_size)),)
        want = _jax_run(model, params, tx, mesh, jax_step(mesh), toks)
        _LM_RUNS[key] = (pc, want)
    return _LM_RUNS[key]


def _held(got, cfg_kw, opt_kw, mesh_kw):
    pc, (want, want_params) = _jax_lm(cfg_kw, opt_kw, mesh_kw)
    _check(got, want, want_params, Transformer(pc),
           convert.unflatten(convert.random_params(pc, 0)))
    assert all(g["blocks"] == pc.n_layers for g in got)   # every layer


@pytest.mark.parametrize("dispatch", list(COMPOSE_MOE))
@pytest.mark.parametrize("impl", CP_IMPLS)
@pytest.mark.parametrize("n,mesh", _cases("moe"))
def test_context_parallel_moe_step_matches_jax(gangs, n, mesh, impl,
                                               dispatch):
    got = gangs[n].case(f"cp_moe/{mesh}/{impl}/{dispatch}")
    cfg = dict(attention_impl=impl, n_experts=MOE_EXPERTS,
               **COMPOSE_MOE[dispatch])
    _held(got, cfg, COMPOSE_MOE_OPT.get(dispatch, {}), dict(dp=2, tp=2))


@pytest.mark.parametrize("n,mesh", _cases("moe"))
def test_capacity_dispatch_over_sequence_blocks_matches_jax(gangs, n,
                                                            mesh):
    """The rows split over ``dp`` and each row's positions over ``tp``:
    the global order interleaves the sequence ranks row by row, and each
    token takes the slots (and drops) JAX gives it over the whole
    flattened batch."""
    logits = dispatch_logits()
    R, S, E = logits.shape
    want_d, want_c, want_aux = (np.asarray(a) for a in jax_dispatch(
        jnp.asarray(logits.reshape(R * S, E)), DISPATCH_K, DISPATCH_C))
    want_d = want_d.reshape(R, S, E, DISPATCH_C)
    want_c = want_c.reshape(R, S, E, DISPATCH_C)
    dropped = R * S * DISPATCH_K - int(want_d.sum())
    assert dropped > 0
    layout = COMPOSE_TRAIN_MESHES[n]["moe"][mesh]
    dp, tp = layout.get("dp", 1), layout.get("tp", 1)
    have_d = np.zeros_like(want_d)
    have_c = np.zeros_like(want_c)
    for rank, got in enumerate(gangs[n].case(f"dispatch/{mesh}")):
        i, j = divmod(rank, tp)
        rows = slice(i * R // dp, (i + 1) * R // dp)
        cols = slice(j * S // tp, (j + 1) * S // tp)
        have_d[rows, cols] = got["dispatch"].numpy()
        have_c[rows, cols] = got["combine"].numpy()
        np.testing.assert_allclose(got["aux"], want_aux, rtol=LIMIT)
    np.testing.assert_array_equal(have_d, want_d)
    assert R * S * DISPATCH_K - int(have_d.sum()) == dropped
    np.testing.assert_allclose(have_c, want_c, atol=LIMIT, rtol=0)


@pytest.mark.parametrize("impl", CP_IMPLS)
@pytest.mark.parametrize("n,mesh", _cases("seq_dp"))
def test_sequence_over_a_data_axis_matches_jax(gangs, n, mesh, impl):
    _held(gangs[n].case(f"seq/{mesh}/{impl}"),
          dict(attention_impl=impl, seq_axis="dp"), {}, dict(dp=2, tp=2))


@pytest.mark.parametrize("impl", CP_IMPLS)
def test_sequence_over_pp_on_a_whole_model_matches_jax(gangs, impl):
    _held(gangs[4].case(f"seq/pp2tp2/{impl}"),
          dict(attention_impl=impl, seq_axis="pp"), {}, dict(pp=2, tp=2))


@pytest.mark.parametrize("impl", CP_IMPLS)
def test_context_parallel_inside_the_pipeline_matches_jax(gangs, impl):
    """The pipelined forward with ring/Ulysses over ``tp`` inside each
    stage: each rank's block of the positions' logits against JAX's
    pipelined forward on its ``pp=2,tp=2`` mesh (which runs ring inside
    its pipeline's ``shard_map``); the train step refuses, as the
    reference's fails (the next test)."""
    cfg = dict(attention_impl=impl, n_layers=PIPE_LAYERS)
    pc = tiny_config(**cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))
    mesh = _mesh(pp=2, tp=2)
    model = JaxTransformer(jax_tiny(**cfg))
    fwd = make_pipelined_lm_forward(model, mesh, n_microbatches=2)
    toks = jnp.asarray(pipe_tokens(pc.vocab_size))
    with mesh_context(mesh):
        want = np.asarray(jax.jit(fwd)(params, toks))
    for rank, got in enumerate(gangs[4].case(f"pipe/{impl}")):
        assert got["blocks"] == PIPE_LAYERS // 2
        np.testing.assert_allclose(
            got["logits"].numpy(), block(want, "cols", 2, rank % 2),
            atol=LIMIT, rtol=0, err_msg=f"rank {rank}")
        assert "reference's step fails" in got["refused"]


_REFERENCE_PIPE_STEP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
from kubeflow_tpu.models import Transformer, tiny_config
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.train import (TrainState, create_sharded_state,
                                make_optimizer, make_pipelined_lm_train_step)
cfg = tiny_config(attention_impl=sys.argv[1], n_layers=4)
model = Transformer(cfg)
toks = np.zeros((8, 16), np.int32)
params = model.init(jax.random.key(0), toks[:1])["params"]
mesh = create_mesh(MeshConfig(pp=2, tp=2), devices=jax.devices()[:4])
tx = make_optimizer(1e-3)
state, _ = create_sharded_state(
    lambda r: TrainState.create(apply_fn=model.apply, params=params, tx=tx),
    jax.random.key(0), mesh, pipelined=True)
step = make_pipelined_lm_train_step(model, mesh, n_microbatches=2)
try:
    state, m = step(state, jnp.asarray(toks))
    print("LOSS", float(m["loss"]))
except Exception as e:
    print("RAISES", type(e).__name__)
"""


@pytest.mark.parametrize("impl", CP_IMPLS)
def test_pipelined_train_step_with_ring_refused_by_both(impl):
    """The reference's pipelined train step does not run ring or Ulysses
    inside its pipeline: lowering its backward fails (it runs in a
    fresh interpreter: the failing compile has also crashed one). The
    port's step refuses the same model by name."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    run = subprocess.run([sys.executable, "-c", _REFERENCE_PIPE_STEP, impl],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=repo)
    assert "LOSS" not in run.stdout, run.stdout
    assert run.returncode != 0 or "RAISES" in run.stdout, run.stderr[-2000:]


def test_ulysses_over_an_axis_the_kv_heads_do_not_divide_refused_by_both(
        gangs):
    """Ulysses with the sequence over ``dp = 4`` and 2 kv heads: the
    reference raises, and the port raises the same text."""
    cfg = dict(attention_impl="ulysses", seq_axis="dp")
    pc = tiny_config(**cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_params(pc, 0)))
    mesh = _mesh(dp=4)
    model = JaxTransformer(jax_tiny(**cfg))
    with mesh_context(mesh), pytest.raises(ValueError) as want:
        jax.jit(lambda p, t: model.apply({"params": p}, t))(
            params, jnp.asarray(train_tokens("default", pc.vocab_size)))
    assert "ulysses needs q heads 4 and kv heads 2" in str(want.value)
    for got in gangs[4].case("ulysses_dp4"):
        assert got == str(want.value)


@pytest.fixture(scope="module")
def jax_pp_mesh():
    return _mesh(dp=2, pp=2, tp=2)


@pytest.fixture(scope="module")
def jax_mlm(jax_pp_mesh):
    cfg, jc = _bert()
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_bert_params(cfg, 0)))
    batch = tuple(jnp.asarray(a) for a in mlm_inputs(cfg.vocab_size))
    return _jax_run(JaxBert(jc), params, jax_optimizer(LR, **OPT),
                    jax_pp_mesh, jax_mlm_step(jax_pp_mesh), batch)


@pytest.mark.parametrize("n,mesh", _cases("pp"))
def test_mlm_step_over_pp_matches_jax(gangs, jax_mlm, n, mesh):
    cfg, _ = _bert()
    got = gangs[n].case(f"mlm/{mesh}")
    want, want_params = jax_mlm
    _check(got, want, want_params, Bert(cfg),
           convert.unflatten(convert.random_bert_params(cfg, 0)))
    assert all(g["blocks"] == cfg.n_layers for g in got)


@pytest.fixture(scope="module")
def jax_image(jax_pp_mesh):
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = _jax_image_run(case, jax_pp_mesh)
        return runs[case]

    return get


@pytest.mark.parametrize("case", COMPOSE_IMAGE_CASES)
@pytest.mark.parametrize("n,mesh", _cases("pp"))
def test_image_step_over_pp_matches_jax(gangs, jax_image, n, mesh, case):
    got = gangs[n].case(f"image/{case}/{mesh}")
    r0 = got[0]
    for rank, g in enumerate(got[1:], 1):
        assert g["metrics"] == r0["metrics"], f"rank {rank}"
    grads, metrics, final = jax_image(case)
    have = _port_flat(case, r0["state"])
    assert [m[2] for m in r0["metrics"]] == [m[2] for m in metrics]
    loss = max(abs(a[0] - b[0]) for a, b in zip(r0["metrics"], metrics))
    err = max(float(np.abs(have[k] - final[k]).max()) for k in final)
    want_norm = float(np.sqrt(sum(float(np.sum(np.square(
        g.astype(np.float64)))) for g in grads.values())))
    norm = abs(r0["metrics"][0][3] - want_norm) / want_norm
    assert loss <= LIMIT, loss
    assert norm <= LIMIT, (r0["metrics"][0][3], want_norm)
    assert err <= PARAM_LIMIT[case], err


@pytest.mark.parametrize("name", ENTRY_PP)
def test_entry_points_train_under_a_pp_mesh(gangs, name):
    """Both ranks of ``launcher_init(pp=2)``'s mesh (dp 1, pp 2, tp 1)
    run the same steps: the same final loss (BERT), images/s, or
    accuracy (MNIST), finite."""
    got = gangs[2].case(f"entry/{name}")
    for g in got:
        assert g["mesh"] == [[1, 1, 2, 1]]
        assert np.isfinite(g["result"])
    if name in ("bert", "mnist"):
        assert got[0]["result"] == got[1]["result"]


def test_bert_entry_at_pp2_equals_one_rank(gangs):
    """BERT at ``pp=2`` trains the batch one rank would (dp 1): its loss
    equals the entry point's run in one process."""
    from torch_gang import BERT_TINY

    from kubeflow_tpu_torch.examples import bert as bert_example

    loss = bert_example.main(BERT_TINY + ["--steps", "2"])
    got = gangs[2].case("entry/bert")
    np.testing.assert_allclose(got[0]["result"], loss, rtol=LIMIT)


def test_layouts_of_the_sequence_axis():
    """The port's split for each ``seq_axis``: the parameters whole
    along it, ``tp`` splitting heads unless it holds the sequence, the
    rows over the batch rule's other axes."""
    from kubeflow_tpu_torch.parallel import mesh as pmesh

    class Mesh:   # the port reads a mesh's axis names, sizes and coords
        mesh_dim_names = pmesh.MESH_AXES

        def size(self, i):
            return (1, 2, 2, 2)[i]

        def get_coordinate(self):
            return [0, 0, 0, 0]

    want = {"tp": (1, ("dcn", "dp")), "dp": (2, ("dcn",)),
            "pp": (2, ("dcn", "dp")), "dcn": (2, ("dp",))}
    for axis, (tp, rows) in want.items():
        cfg = tiny_config(attention_impl="ring", seq_axis=axis)
        with torch.device("meta"):
            model = Transformer(cfg, mesh=Mesh())
        sp = model.split
        assert (sp.tp, sp.data_axes, sp.seq_axis) == (tp, rows, axis)
        assert sp.seq == (2 if axis != "dcn" else 1)
        q = model.param_specs["blocks.0.attn.q_proj"]
        assert axis not in pmesh.spec_axes(q)
        assert ("tp" in pmesh.spec_axes(q)) == (axis != "tp")
