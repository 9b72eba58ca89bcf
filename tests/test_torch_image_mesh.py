"""The image train step over ``dp`` against the JAX package's.

A 4-rank gloo gang (``tests/torch_gang.py``, suite ``image_mesh``) runs
``make_image_train_step(mesh)`` at dp = 4 on 8 images (2 a rank) for
three steps of SGD 0.1 with momentum 0.9, from numpy-seeded weights, for
a thin ResNet (stages 1-1, width 16, f32, the conv stem; bn3's scales
drawn at random so the fused sites get a gradient) unfused and fused,
ViT (tiny, f32) and the MNIST CNN. BatchNorm takes the global batch's
statistics (each site all-reduces its ``[Σx, Σx²]``), so the running
statistics come out equal on every rank: that is held bit for bit.

The JAX package runs the same weights and batches through its
``make_image_train_step`` twice: on its dp = 4 CPU mesh (GSPMD) and on
one device (the global batch whole). Against each, with the limits
PERF.md §2 sets for ResNet: every step's loss within 1e-5, the first
step's gradient of every leaf within 2e-2 of its norm (a ReLU flip of a
near-zero element moves a tiny model's gradients by a fraction of a
percent), and the final parameters and statistics within 1e-3. The
readings of both, printed, are in PERF.md (the JAX package's own
unfused ResNet over dp = 8 departs from one device, ROADMAP "Found in
the reference").
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.mnist import MnistCnn as JaxMnist
from kubeflow_tpu.models.resnet import ResNet as JaxResNet
from kubeflow_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from kubeflow_tpu.models.vit import ViT as JaxViT
from kubeflow_tpu.models.vit import ViTConfig as JaxViTConfig
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.parallel.mesh import (
    logical_to_mesh_axes,
    mesh_context,
    spec_for_mesh,
)
from kubeflow_tpu.train import TrainState as JaxState
from kubeflow_tpu.train import create_sharded_state
from kubeflow_tpu.train import make_image_train_step as jax_image_step
from kubeflow_tpu.train.trainer import softmax_cross_entropy as jax_xent
from kubeflow_tpu_torch.models import convert
from torch_gang import (
    IMAGE_CASES,
    IMAGE_FEED_CASES,
    IMAGE_LR,
    IMAGE_STEPS,
    Gang,
    _image_state,
    image_inputs,
    image_variables,
)

LOSS_LIMIT, GRAD_LIMIT, PARAM_LIMIT = 1e-5, 2e-2, 1e-3


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("image_mesh", 4, tmp_path_factory.mktemp("image-gang"))


def _jax_model(case):
    if case.startswith("resnet"):
        cfg, _ = image_variables(case)
        return JaxResNet(JaxResNetConfig(
            stage_sizes=tuple(cfg.stage_sizes), num_classes=10, width=16,
            dtype=jnp.float32, bn_dtype=jnp.float32, stem="conv",
            fused_bn_conv=cfg.fused_bn_conv)), True
    if case == "vit":
        return JaxViT(JaxViTConfig(
            image_size=32, patch_size=8, num_classes=10, d_model=64,
            n_layers=2, n_heads=4, d_ff=128, dtype=jnp.float32, remat=False,
            scan_layers=False)), False
    return JaxMnist(), False


def _flat_jax(case, module) -> dict:
    """A port module's parameters (and ResNet's statistics) as the JAX
    package's flat keys and layouts."""
    if case.startswith("resnet"):
        return convert.flatten(convert.resnet_variables(module))
    if case == "vit":
        return convert.flatten({"params": convert.bert_params(
            module, scan_layers=False)})
    return {f"params/{n.replace('.', '/')}": p.detach().numpy()
            for n, p in module.named_parameters()}


def _port_flat(case, tensors) -> dict:
    """Tensors by the port's names (a state dict, or gradients by
    parameter name) in the JAX package's flat layout."""
    module = _image_state(case).module
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name in tensors:
                t.copy_(tensors[name])
    flat = _flat_jax(case, module)
    names = set(tensors)
    keep = {k for k in flat if k.startswith("batch_stats/")} if any(
        n.endswith((".mean", ".var")) for n in names) else set()
    return {k: v for k, v in flat.items() if k.startswith("params/")
            or k in keep}


def _jax_run(case, mesh):
    """The JAX package's first-step gradients, per-step metrics and final
    variables on ``mesh``, from the port's weights."""
    model, with_stats = _jax_model(case)
    _, variables = image_variables(case)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    if with_stats:
        params, stats = variables["params"], variables["batch_stats"]
        apply_fn = model.apply
    else:
        params, stats = variables, None
        apply_fn = (lambda v, x, train=True: model.apply(v, x))
    images, labels = (jnp.asarray(a) for a in image_inputs(case))

    def init_fn(rng):
        del rng
        return JaxState.create(apply_fn=apply_fn, params=params,
                               batch_stats=stats,
                               tx=optax.sgd(IMAGE_LR, momentum=0.9))

    state, _ = create_sharded_state(init_fn, jax.random.key(0), mesh)
    x_spec = spec_for_mesh(logical_to_mesh_axes(
        ("batch", None, None, None)), mesh)
    y_spec = spec_for_mesh(logical_to_mesh_axes(("batch",)), mesh)

    def loss_fn(p, x, y):
        x = jax.lax.with_sharding_constraint(x, x_spec)
        y = jax.lax.with_sharding_constraint(y, y_spec)
        if with_stats:
            logits, _ = apply_fn({"params": p, "batch_stats": stats}, x,
                                 train=True, mutable=["batch_stats"])
        else:
            logits = apply_fn({"params": p}, x, train=True)
        return jax_xent(logits, y)

    with mesh_context(mesh):
        grads = jax.jit(jax.grad(loss_fn))(state.params, images, labels)
    step = jax_image_step(mesh)
    metrics = []
    for _ in range(IMAGE_STEPS):
        state, m = step(state, images, labels)
        metrics.append((float(m["loss"]), float(m["accuracy"]),
                        int(m["step"])))
    final = {"params": state.params}
    if with_stats:
        final["batch_stats"] = state.batch_stats
    np_tree = (lambda t: convert.flatten(jax.tree_util.tree_map(
        np.asarray, t)))
    return (np_tree({"params": grads}), metrics, np_tree(final))


def _readings(got, want):
    """(largest loss error, largest gradient error over its norm,
    largest parameter or statistic error) of the port's rank 0 against
    one JAX run."""
    grads, metrics, final = want
    case_grads, case_final, case_metrics = got
    loss = max(abs(a[0] - b[0]) for a, b in zip(case_metrics, metrics))
    g_err = max(float(np.linalg.norm(case_grads[k] - grads[k]) /
                      np.linalg.norm(grads[k])) for k in grads)
    p_err = max(float(np.abs(case_final[k] - final[k]).max())
                for k in final)
    return loss, g_err, p_err


def _jax_mesh(layout):
    n = 4 if layout == "dp4" else 1
    return create_mesh(MeshConfig(dp=n), devices=jax.devices()[:n])


@pytest.mark.parametrize("layout", ["one_device", "dp4"])
@pytest.mark.parametrize("case", IMAGE_CASES)
def test_image_step_over_dp_matches_jax(gang, case, layout):
    got = gang.case(f"train/{case}")
    r0 = got[0]
    for rank, g in enumerate(got[1:], 1):
        assert g["metrics"] == r0["metrics"], f"rank {rank}"
        for name, t in r0["state"].items():      # statistics too
            assert torch.equal(g["state"][name], t), (rank, name)
    port = (_port_flat(case, r0["grads"]), _port_flat(case, r0["state"]),
            r0["metrics"])
    want = _jax_run(case, _jax_mesh(layout))
    assert port[0].keys() == want[0].keys()
    assert port[1].keys() == want[2].keys()
    assert [m[2] for m in r0["metrics"]] == [m[2] for m in want[1]]
    loss, g_err, p_err = _readings(port, want)
    print(f"{case} vs jax {layout}: loss {loss:.2e} grad {g_err:.2e} "
          f"param {p_err:.2e}")
    assert loss <= LOSS_LIMIT, loss
    assert g_err <= GRAD_LIMIT, g_err
    assert p_err <= PARAM_LIMIT, p_err


@pytest.mark.parametrize("case", IMAGE_FEED_CASES)
def test_image_step_takes_device_feed_rows(gang, case):
    """``device_feed(loader, mesh)`` at dp = 4: the step takes each
    rank's ``RankRows`` as they are, so loss, accuracy and step are
    those of the same global batch passed whole."""
    want, got = gang.case(f"train/{case}"), gang.case(f"feed/{case}")
    for rank, (w, g) in enumerate(zip(want, got)):
        assert g == w["metrics"], f"rank {rank}"
