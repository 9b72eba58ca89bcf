"""Tensor parallelism for the BERT and ViT encoders against the JAX package.

Two gloo gangs (``tests/torch_gang.py``, suite ``encoder_tp``) train on
the CPU over ``tp=2`` (2 ranks) and ``dp=2 × tp=2`` (4 ranks), at f32:

- BERT's MLM step (``make_mlm_train_step(mesh)``) on ``bert_tiny`` built
  over the mesh: the blocks' heads and MLP and ``token_embed``'s
  vocabulary split, the loss vocab-parallel; three AdamW steps at lr
  1e-5 against the JAX package's step on its ``dp=2,tp=4`` mesh: loss
  and ``grad_norm`` on every rank and the gathered parameters within
  1e-5 (and each parameter's movement within 2e-3 of its own size, as
  ``tests/test_torch_mesh_train.py`` holds the LM);
- the image step (``make_image_train_step(mesh)``, ``tests/test_vit.py:36``):
  ViT tiny built over the mesh (its blocks split), three SGD steps
  against JAX's on its ``dp=2,tp=4`` mesh, loss, the first step's
  ``grad_norm`` (against the norm of JAX's first gradients) and
  parameters within 1e-5; ResNet and the MNIST CNN, whose leaf names take no ``tp`` split
  in the reference's rules (held here against ``param_partition_specs``),
  train whole on every rank within the image-mesh limits.

The split each port leaf takes is the reference's rule for its name,
and ``pp`` > 1 still refuses, naming its ROADMAP item.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.models import param_partition_specs
from kubeflow_tpu.models.bert import Bert as JaxBert
from kubeflow_tpu.models.bert import BertConfig as JaxBertConfig
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.train import make_mlm_train_step as jax_mlm_step
from kubeflow_tpu.train import make_optimizer as jax_optimizer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import Bert, bert_tiny
from kubeflow_tpu_torch.parallel import mesh as pmesh
from test_torch_image_mesh import _jax_run as _jax_image_run
from test_torch_image_mesh import _port_flat
from test_torch_mesh_train import _check
from test_torch_mesh_train import _jax_run as _jax_mlm_run
from torch_gang import (
    ENCODER_MESHES,
    IMAGE_CASES,
    LR,
    OPT,
    Gang,
    image_variables,
    mlm_inputs,
)

WORLDS = list(ENCODER_MESHES)
# ViT and BERT at f32 (the acceptance limit); ResNet and MNIST keep the
# image-mesh test's parameter limit (a ReLU flip of a near-zero element)
LOSS_LIMIT = 1e-5
PARAM_LIMIT = {"vit": 1e-5, "resnet_unfused": 1e-3, "resnet_fused": 1e-3,
               "mnist": 1e-3}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return {n: Gang("encoder_tp", n, tmp_path_factory.mktemp(f"enc{n}"))
            for n in WORLDS}


@pytest.fixture(scope="module")
def jax_mesh():
    return create_mesh(MeshConfig(dp=2, tp=4))


@pytest.fixture(scope="module")
def jax_image(jax_mesh):
    """JAX's image step on its dp=2,tp=4 mesh, once a case."""
    runs = {}

    def get(case):
        if case not in runs:
            runs[case] = _jax_image_run(case, jax_mesh)
        return runs[case]

    return get


def _bert():
    cfg = dataclasses.replace(bert_tiny(), dtype="float32")
    jc = JaxBertConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                       n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                       d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len,
                       dtype=jnp.float32, remat=False, scan_layers=False)
    return cfg, jc


@pytest.fixture(scope="module")
def jax_mlm(jax_mesh):
    cfg, jc = _bert()
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.unflatten(convert.random_bert_params(cfg, 0)))
    batch = tuple(jnp.asarray(a) for a in mlm_inputs(cfg.vocab_size))
    return _jax_mlm_run(JaxBert(jc), params, jax_optimizer(LR, **OPT),
                        jax_mesh, jax_mlm_step(jax_mesh), batch)


@pytest.mark.parametrize("n", WORLDS)
def test_mlm_step_over_tp_matches_jax(gangs, jax_mlm, n):
    cfg, _ = _bert()
    got = gangs[n].case("mlm")
    want, want_params = jax_mlm
    _check(got, want, want_params, Bert(cfg),
           convert.unflatten(convert.random_bert_params(cfg, 0)))
    tp = ENCODER_MESHES[n]["tp"]
    shapes = got[0]["shapes"]
    assert shapes["token_embed"] == (cfg.vocab_size // tp, cfg.d_model)
    assert shapes["blocks.0.attn.q_proj"] == (
        cfg.d_model, cfg.n_heads // tp, cfg.d_model // cfg.n_heads)
    assert shapes["mlm_transform"] == (cfg.d_model, cfg.d_model)
    assert shapes["type_embed"] == (cfg.type_vocab_size, cfg.d_model)


def _ref_splits(tree) -> dict:
    """Whether the reference's rules split each leaf over ``tp``, by the
    port's flat key (the leading layer axis of a scanned leaf aside)."""
    specs = param_partition_specs(tree)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: not isinstance(x, dict))[0]
    return {"/".join(str(p.key) for p in path): "tp" in str(spec)
            for path, spec in flat}


def test_port_leaves_take_the_reference_split():
    """Each BERT and ViT leaf splits over ``tp`` exactly where the
    reference's ``leaf_logical_axes`` splits it; no ResNet or MNIST
    leaf does."""
    mesh = pmesh.create_mesh(pmesh.MeshConfig(), device_type="cpu")
    cfg, _ = _bert()
    vcfg, vparams = image_variables("vit")
    for module, params in (
            (Bert(cfg, mesh=mesh), convert.random_bert_params(cfg, 0)),
            (convert.vit_to_trainable(vcfg, vparams, device="cpu",
                                      mesh=mesh), vparams)):
        ref = _ref_splits(convert.unflatten(convert.flatten(params)))
        ours = {convert._jax_key(n, False)[0]: "tp" in pmesh.spec_axes(s)
                for n, s in module.param_specs.items()}
        assert ours == ref
    for case in ("resnet_unfused", "resnet_fused", "mnist"):
        _, variables = image_variables(case)
        tree = variables["params"] if "params" in variables else variables
        assert not any(_ref_splits(tree).values()), case


@pytest.mark.parametrize("case", IMAGE_CASES)
@pytest.mark.parametrize("n", WORLDS)
def test_image_step_over_tp_matches_jax(gangs, jax_image, n, case):
    got = gangs[n].case(f"image/{case}")
    r0 = got[0]
    for rank, g in enumerate(got[1:], 1):
        assert g["metrics"] == r0["metrics"], f"rank {rank}"
    split = any("tp" in pmesh.spec_axes(s) for s in r0["specs"].values())
    assert split == (case == "vit")
    grads, metrics, final = jax_image(case)
    have = _port_flat(case, r0["state"])
    assert [m[2] for m in r0["metrics"]] == [m[2] for m in metrics]
    loss = max(abs(a[0] - b[0]) for a, b in zip(r0["metrics"], metrics))
    err = max(float(np.abs(have[k] - final[k]).max()) for k in final)
    # the first step's clipping norm (over tp: each split leaf's squares
    # summed over its blocks) against the norm of JAX's first gradients
    want_norm = float(np.sqrt(sum(float(np.sum(np.square(
        g.astype(np.float64)))) for g in grads.values())))
    norm = abs(r0["metrics"][0][3] - want_norm) / want_norm
    print(f"{case} at {ENCODER_MESHES[n]} vs jax dp2tp4: loss {loss:.2e} "
          f"param {err:.2e} grad_norm rel {norm:.2e}")
    assert loss <= LOSS_LIMIT, loss
    assert norm <= LOSS_LIMIT, (r0["metrics"][0][3], want_norm)
    assert err <= PARAM_LIMIT[case], err


@pytest.mark.parametrize("n", WORLDS)
def test_pp_still_refuses_by_name(gangs, n):
    for got in gangs[n].case("refused"):
        assert len(got) == 2
        for msg in got:
            assert "pp=2" in msg and "Queue A 2.8" in msg
