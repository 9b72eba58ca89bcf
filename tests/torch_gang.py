"""Rank-side workloads of the port's multi-process tests, and the gang
that runs them.

``python tests/torch_gang.py SUITE OUT`` runs in every rank of a gang
started by :class:`Gang` (``kubeflow_tpu_torch.testing.run_multiprocess``:
the operator's env contract over gloo on the CPU). It runs each case of
SUITE, in the same order on every rank, and saves ``{case: result}``
(or ``{"error": traceback}``) to ``OUT/rank<r>.pt``. The test modules
compute the JAX package's answers in the pytest process while the gang
runs, then compare case by case; the inputs both sides use are the
constants and input functions here. This file imports no JAX: the ranks are
fresh interpreters that never load it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import os
import sys
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch

GANG_TIMEOUT_S = 110.0

# -- shared inputs ----------------------------------------------------------

STEPS = 3
LR = 1e-5
OPT = dict(warmup_steps=1, decay_steps=50)
TRAIN_BATCH, TRAIN_SEQ = 4, 16
# case -> (config overrides, optimizer overrides, loss_chunk, token edit)
TRAIN_CASES: Dict[str, Dict[str, Any]] = {
    "default": {},
    "grad_clip": {"opt": {"grad_clip": 0.05}},
    "kv_replicated": {"cfg": {"n_kv_heads": 1}},
    "loss_chunk": {"loss_chunk": 5},
    "wrapped_id": {"edit": (2, 7, -3)},
    "bad_id": {"edit": (1, 5, 300)},
    "ring": {"cfg": {"attention_impl": "ring"}},
}
LOGIT_IMPLS = ("ring", "ulysses")
SEQ_ATTN = dict(B=4, S=16, H=4, D=8)
SEQ_CASES = {                    # name -> (core, kv heads, causal)
    "ring_causal": ("ring", 4, True),
    "ring_full": ("ring", 4, False),
    "ulysses_causal": ("ulysses", 4, True),
    "ulysses_gqa": ("ulysses", 2, True),
}
COLLECTIVE_MESHES = {"dp4": dict(dp=4), "dp2tp2": dict(dp=2, tp=2)}
COLLECTIVE_AXES = (("dp4", "dp"), ("dp2tp2", "tp"), ("dp2tp2", "dp"))
COLLECTIVE_OPS = ("all_reduce", "all_gather", "reduce_scatter",
                  "all_to_all", "ppermute")
# each op's (input spec, output spec) over the axis, the reference's
COLLECTIVE_SPECS = {
    "all_reduce": ("rows", "all"), "all_gather": ("rows", "all"),
    "reduce_scatter": ("cols", "rows"), "all_to_all": ("rows", "cols"),
    "ppermute": ("rows", "rows"),
}
MLM_BATCH, MLM_SEQ = 4, 16
# the pipeline: pipeline_apply's layer stack and microbatches (M, mb)
PIPE_L, PIPE_DIN = 8, 16
PIPE_APPLY = {"4x6": (4, 6), "7x3": (7, 3)}
# pipelined LM steps: mesh, tiny_config(n_layers=4), 2 microbatches of
# the global batch of 8
PIPE_MESHES = {"dp2pp2": dict(dp=2, pp=2), "pp2tp2": dict(pp=2, tp=2)}
PIPE_LAYERS, PIPE_M, PIPE_BATCH, PIPE_LOGIT_M = 4, 2, 8, 4
# the full mesh: dp 2 x pp 2 x tp 2, MoE with capacity dispatch
FULL_CFG = dict(n_layers=4, n_experts=4, moe_capacity_factor=2.0)
FULL_OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
FULL_STEPS = 4
# MoE over dp 2 x tp 2: case -> config and optimizer overrides; "drops"
# fills 64 slots with 128 choices (capacity 16 of 4 experts)
MOE_CASES: Dict[str, Dict[str, Any]] = {
    "dense": {},
    "capacity": {"cfg": {"moe_capacity_factor": 1.25}},
    "drops": {"cfg": {"moe_capacity_factor": 0.25},
              "opt": {"grad_clip": 0.05}},
    # across two slices: the experts split over dp, replicated over dcn
    "dcn_dense": {"mesh": dict(dcn=2, dp=2)},
    "dcn_capacity": {"cfg": {"moe_capacity_factor": 1.25},
                     "mesh": dict(dcn=2, dp=2)},
}
MOE_MESH = dict(dp=2, tp=2)
MOE_EXPERTS = 4
# the image step over dp = 4: 8 images, SGD 0.1 with momentum 0.9
IMAGE_CASES = ("resnet_unfused", "resnet_fused", "vit", "mnist")
IMAGE_BATCH, IMAGE_STEPS, IMAGE_LR = 8, 3, 0.1
# fed by device_feed over the mesh: BatchNorm's global statistics show a
# batch cut twice
IMAGE_FEED_CASES = ("resnet_unfused", "mnist")
# the elastic shrink: tests/test_elastic.py's tiny model, optimizer and
# (8, 8) global batch; the port's 4 ranks go from 2 slices x tp 2 to 1
ELASTIC_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                   n_kv_heads=4, d_ff=64, max_seq_len=16, remat=False)
ELASTIC_OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20)
ELASTIC_JOB = dict(job="train", namespace="d", uid="u")


def elastic_tokens(step: int) -> np.ndarray:
    """The elastic run's global batch of ``step``: step-keyed, so the
    stream is the same on every topology."""
    return np.random.default_rng([1234, step]).integers(
        0, 64, (8, 8)).astype(np.int32)


def collective_input(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (8, 12)).astype(np.float32)


def train_tokens(case: str, vocab: int) -> np.ndarray:
    toks = np.random.default_rng(7).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    edit = TRAIN_CASES[case].get("edit")
    if edit:
        toks[edit[0], edit[1]] = edit[2]
    return toks


def logit_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(8).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)


def seq_inputs(kv_heads: int):
    c = SEQ_ATTN
    rng = np.random.default_rng(kv_heads)
    q = rng.standard_normal((c["B"], c["S"], c["H"], c["D"]))
    k = rng.standard_normal((c["B"], c["S"], kv_heads, c["D"]))
    v = rng.standard_normal((c["B"], c["S"], kv_heads, c["D"]))
    ct = rng.standard_normal((c["B"], c["S"], c["H"], c["D"]))
    return [a.astype(np.float32) for a in (q, k, v, ct)]


def mlm_inputs(vocab: int):
    rng = np.random.default_rng(11)
    labels = rng.integers(0, vocab, (MLM_BATCH, MLM_SEQ)).astype(np.int32)
    weights = (rng.random((MLM_BATCH, MLM_SEQ)) < 0.3).astype(np.float32)
    tokens = np.where(weights > 0, 103, labels).astype(np.int32)
    return tokens, labels, weights


def pipe_stack() -> np.ndarray:
    return (np.random.default_rng(0).standard_normal(
        (PIPE_L, PIPE_DIN, PIPE_DIN)) * 0.1).astype(np.float32)


def pipe_microbatches(M: int, mb: int) -> np.ndarray:
    return np.random.default_rng(1).standard_normal(
        (M, mb, PIPE_DIN)).astype(np.float32)


def pipe_tokens(vocab: int, seed: int = 9) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (PIPE_BATCH, TRAIN_SEQ)).astype(np.int32)


def image_inputs(case: str):
    """``(images, labels)`` of the image cases: 8 rows, 32x32x3 (28x28x1
    for MNIST), ten classes."""
    rng = np.random.default_rng(8)
    shape = (28, 28, 1) if case == "mnist" else (32, 32, 3)
    images = rng.standard_normal((IMAGE_BATCH,) + shape).astype(np.float32)
    return images, rng.integers(0, 10, IMAGE_BATCH).astype(np.int32)


def image_variables(case: str):
    """The port's config and JAX-layout weights of an image case, from
    numpy seeds: ResNet (stages 1-1, width 16, f32, the conv stem, bn3's
    scales drawn at random so the fused sites get a gradient) in the
    fused layout or unfused from the same weights, ViT tiny (f32,
    unrolled), the MNIST CNN."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.models.vit import vit_tiny

    if case.startswith("resnet"):
        fused = case == "resnet_fused"
        cfg = ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=16,
                           dtype="float32", bn_dtype="float32", stem="conv",
                           fused_bn_conv=True)
        flat = convert.flatten(convert.random_resnet_params(cfg, 7))
        rng = np.random.default_rng(17)
        for key in sorted(flat):
            if key.endswith("bn3/scale"):
                flat[key] = rng.standard_normal(flat[key].shape).astype(
                    np.float32)
        variables = convert.unflatten(flat)
        if not fused:
            variables = convert.unfuse_bn_conv(variables)
        return dataclasses.replace(cfg, fused_bn_conv=fused), variables
    if case == "vit":
        cfg = dataclasses.replace(vit_tiny(10), dtype="float32")
        return cfg, convert.unflatten(convert.random_vit_params(cfg, 0))
    return None, convert.random_mnist_params(0)


def block(x: np.ndarray, how: str, n: int, i: int) -> np.ndarray:
    """Block ``i`` of ``n`` of ``x``: ``rows`` (dim 0), ``cols`` (dim 1)
    or ``all`` (the whole)."""
    if how == "all":
        return x
    d = 0 if how == "rows" else 1
    size = x.shape[d] // n
    return np.take(x, range(i * size, (i + 1) * size), axis=d)


# -- rank side --------------------------------------------------------------


class FixedLoader:
    """A loader whose every batch is ``batch`` (an array or a tuple of
    arrays: a case's global batch), for ``device_feed``."""

    def __init__(self, batch) -> None:
        self.batch = batch

    def next(self):
        return self.batch, 0

    def close(self) -> None:
        pass


def fed_steps(step, state, mesh, batch, steps: int = STEPS):
    """``steps`` steps fed by ``device_feed(loader, mesh)``: each rank's
    leaves arrive wrapped as its rows (``RankRows``), which the step
    takes as they are. Returns each step's ``(loss, second metric,
    step)`` and the final state."""
    from kubeflow_tpu_torch.data import device_feed

    metrics = []
    for leaves in device_feed(FixedLoader(batch), mesh, steps=steps):
        leaves = leaves if isinstance(leaves, tuple) else (leaves,)
        state, m = step(state, *leaves)
        second = m["accuracy"] if "accuracy" in m else m["grad_norm"]
        metrics.append((float(m["loss"]), float(second), int(m["step"])))
    return metrics, state


def _cpu_mesh(**cfg):
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(**cfg), device_type="cpu")


def _mesh_facts(mesh) -> Dict[str, Any]:
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import mesh as pmesh

    groups = {}
    for axes in [(a,) for a in pmesh.MESH_AXES] + [("dcn", "dp"),
                                                    ("dcn", "dp", "tp")]:
        groups["/".join(axes)] = tdist.get_process_group_ranks(
            pmesh.axis_group(mesh, axes))
    return {"ranks": mesh.mesh.tolist(),
            "sizes": [pmesh.axis_size(mesh, a) for a in pmesh.MESH_AXES],
            "coord": list(mesh.get_coordinate()),
            "dp_size": pmesh.data_parallel_size(mesh),
            "groups": groups}


def _mesh_suite() -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.parallel import mesh as pmesh

    def wrong_size():
        try:
            _cpu_mesh(dp=8)
        except ValueError as e:
            return str(e)
        return "no error"

    def gather():
        mesh = _cpu_mesh(dp=2, tp=2)
        full = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
        out = {}
        for name, spec in (("tp", pmesh.PartitionSpec(None, "tp")),
                           ("dp_tp", pmesh.PartitionSpec("dp", "tp")),
                           ("batch", pmesh.PartitionSpec(("dcn", "dp")))):
            mine = pmesh.local_block(full, spec, mesh)
            out[name] = bool(torch.equal(
                pmesh.gather_block(mine, spec, mesh), full))
        return out

    def multislice():
        penv = dist.from_env({"MEGASCALE_NUM_SLICES": "2"})
        return _mesh_facts(dist.multislice_mesh(penv, tp=2,
                                                device_type="cpu"))

    return {
        "dp2_tp2": lambda: _mesh_facts(_cpu_mesh(dp=2, tp=2)),
        "dcn2_tp2": lambda: _mesh_facts(_cpu_mesh(dcn=2, tp=2)),
        "multislice": multislice,
        "wrong_size": wrong_size,
        "gather": gather,
    }


def _collectives_suite() -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.ops import collectives as col
    from kubeflow_tpu_torch.parallel.mesh import axis_index, axis_size

    meshes = {k: _cpu_mesh(**v) for k, v in COLLECTIVE_MESHES.items()}
    full = collective_input()
    ct = collective_input(1)

    def case(mesh_name, axis):
        mesh = meshes[mesh_name]
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        out = {}
        for op in COLLECTIVE_OPS:
            spec_in, spec_out = COLLECTIVE_SPECS[op]
            x = torch.from_numpy(np.ascontiguousarray(
                block(full, spec_in, n, i)))
            if op == "ppermute":
                for shift in (1, 3):
                    out[f"ppermute{shift}"] = col.ppermute_shift(
                        x, mesh, axis, shift)
                xg = x.clone().requires_grad_(True)
                g = torch.from_numpy(np.ascontiguousarray(
                    block(ct, "rows", n, i)))
                (col.ppermute(xg, mesh, axis, 1) * g).sum().backward()
                out["ppermute_grad"] = xg.grad
            else:
                out[op] = getattr(col, op)(x, mesh, axis)
            if op == "all_to_all":
                xg = x.clone().requires_grad_(True)
                g = torch.from_numpy(np.ascontiguousarray(
                    block(ct, "cols", n, i)))
                (col.all_to_all_grad(xg, mesh, axis) * g).sum().backward()
                out["all_to_all_grad"] = xg.grad
        # the differentiable sum, gather and scatter, each rank's input
        # and cotangent scaled by (its index + 1)
        w = float(i + 1)
        rows = np.ascontiguousarray(block(full, "rows", n, i))
        for op, x, g in (
                ("all_gather_grad", rows, ct * w),
                ("reduce_scatter_grad", full * w,
                 np.ascontiguousarray(block(ct, "rows", n, i))),
                ("all_reduce_grad", full * w, ct * w)):
            x = torch.from_numpy(np.array(x)).requires_grad_(True)
            y = getattr(col, op)(x, mesh, axis)
            (y * torch.from_numpy(np.array(g))).sum().backward()
            out[op] = (y.detach(), x.grad)
        # Megatron's f and g over the axis: rank-dependent inputs
        x = torch.from_numpy(full[i]).requires_grad_(True)
        y = col.reduce_from(x, mesh, axis)
        (y * torch.from_numpy(ct[i])).sum().backward()
        out["reduce_from"], out["reduce_from_grad"] = y.detach(), x.grad
        x = torch.from_numpy(full[i]).requires_grad_(True)
        y = col.copy_to(x, mesh, axis)
        (y * torch.from_numpy(ct[i])).sum().backward()
        out["copy_to"], out["copy_to_grad"] = y.detach(), x.grad
        return out

    def bench():
        res = col.bench_all(meshes["dp4"], "dp", size_mb=0.25, iters=2)
        return [{"op": r.op, "n": r.n_devices, "alg": r.alg_gb_s,
                 "bus": r.bus_gb_s, "mean_s": r.mean_s} for r in res]

    cases = {f"{m}/{a}": (lambda m=m, a=a: case(m, a))
             for m, a in COLLECTIVE_AXES}
    cases["bench"] = bench
    return cases


def _seq_parallel_suite() -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.ops import attention as att

    mesh = _cpu_mesh(dp=2, tp=2)

    def case(core, kv_heads, causal):
        q, k, v, ct = (torch.from_numpy(a) for a in seq_inputs(kv_heads))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        fn = (att.ring_attention_sharded if core == "ring"
              else att.ulysses_attention_sharded)
        kk, vv = (att.gqa_repeat(q, k, v) if core == "ring" else (k, v))
        out = fn(q, kk, vv, mesh, causal=causal)
        from kubeflow_tpu_torch.parallel.mesh import (
            PartitionSpec,
            local_block,
        )

        spec = PartitionSpec(("dcn", "dp"), "tp")
        (out * local_block(ct, spec, mesh)).sum().backward()
        return {"out": out.detach(), "dq": q.grad, "dk": k.grad,
                "dv": v.grad}

    return {name: (lambda c=c: case(*c)) for name, c in SEQ_CASES.items()}


def _lm_config(**kw):
    from kubeflow_tpu_torch.models.transformer import tiny_config

    return tiny_config(**kw)


def _mesh_train_suite() -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_lm_train_step,
        make_optimizer,
    )

    mesh = _cpu_mesh(dp=2, tp=2)

    def train(case):
        spec = TRAIN_CASES[case]
        cfg = _lm_config(**spec.get("cfg", {}))
        tx = make_optimizer(LR, **OPT, **spec.get("opt", {}))
        chunk = spec.get("loss_chunk")
        state, _ = create_sharded_state(
            cfg, convert.random_params(cfg, 0), tx, mesh, device="cpu",
            return_hidden=bool(chunk))
        step = make_lm_train_step(mesh, loss_chunk=chunk)
        toks = train_tokens(case, cfg.vocab_size)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, toks)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        return {"metrics": metrics,
                "params": convert.gather_params(state.module)}

    def logits(impl):
        from kubeflow_tpu_torch.parallel.mesh import PartitionSpec, local_block

        cfg = _lm_config(attention_impl=impl)
        model = convert.to_trainable(cfg, convert.random_params(cfg, 0),
                                     device="cpu", mesh=mesh)
        toks = torch.from_numpy(logit_tokens(cfg.vocab_size))
        rows = local_block(toks, PartitionSpec(("dcn", "dp")), mesh)
        with torch.no_grad():
            return model(rows)

    def fed():
        cfg = _lm_config()
        state, _ = create_sharded_state(
            cfg, convert.random_params(cfg, 0), make_optimizer(LR, **OPT),
            mesh, device="cpu")
        return fed_steps(make_lm_train_step(mesh), state, mesh,
                         train_tokens("default", cfg.vocab_size))[0]

    cases = {f"train/{c}": (lambda c=c: train(c)) for c in TRAIN_CASES}
    cases.update({f"logits/{i}": (lambda i=i: logits(i))
                  for i in LOGIT_IMPLS})
    cases["feed"] = fed
    return cases


def _mlm_suite() -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import bert_tiny
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        make_mlm_train_step,
        make_optimizer,
    )

    def mlm():
        import dataclasses

        mesh = _cpu_mesh(dp=2)
        cfg = dataclasses.replace(bert_tiny(), dtype="float32")
        state = create_bert_train_state(
            cfg, convert.random_bert_params(cfg, 0),
            make_optimizer(LR, **OPT), device="cpu")
        step = make_mlm_train_step(mesh)
        batch = mlm_inputs(cfg.vocab_size)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, *batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        return {"metrics": metrics,
                "params": convert.gather_params(state.module)}

    def fed():
        import dataclasses

        mesh = _cpu_mesh(dp=2)
        cfg = dataclasses.replace(bert_tiny(), dtype="float32")
        state = create_bert_train_state(
            cfg, convert.random_bert_params(cfg, 0),
            make_optimizer(LR, **OPT), device="cpu")
        return fed_steps(make_mlm_train_step(mesh), state, mesh,
                         mlm_inputs(cfg.vocab_size))[0]

    return {"mlm": mlm, "feed": fed}


def _pipeline_suite(out: str) -> Dict[str, Callable[[], Any]]:
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.parallel import pipeline as pl
    from kubeflow_tpu_torch.parallel.mesh import axis_index
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_optimizer,
        make_pipelined_lm_train_step,
    )
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    meshes = {"pp4": _cpu_mesh(pp=4)}
    meshes.update({k: _cpu_mesh(**v) for k, v in PIPE_MESHES.items()})

    def stage_fn(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    def apply(shape, grad):
        mesh = meshes["pp4"]
        w = pl.split_stages(torch.from_numpy(pipe_stack()), 4)[
            axis_index(mesh, "pp")].clone().requires_grad_(grad)
        x = torch.from_numpy(pipe_microbatches(*shape))
        y = pl.pipeline_apply(stage_fn, w, x, mesh=mesh)
        if not grad:
            return y.detach()
        (y ** 2).sum().backward()
        return w.grad

    def pipelined_model():
        cfg = _lm_config(n_layers=PIPE_LAYERS)
        model = convert.to_trainable(cfg, convert.random_params(cfg, 0),
                                     device="cpu", mesh=meshes["pp4"])
        return cfg, pl.make_pipelined_lm_forward(
            model, meshes["pp4"], n_microbatches=PIPE_LOGIT_M)

    def logits():
        cfg, fwd = pipelined_model()
        with torch.no_grad():
            return fwd(torch.from_numpy(pipe_tokens(cfg.vocab_size)))

    def ragged():
        _, fwd = pipelined_model()
        try:
            fwd(torch.zeros((6, TRAIN_SEQ), dtype=torch.int32))
        except ValueError as e:
            return str(e)
        return "no error"

    def tx():
        return make_optimizer(LR, **OPT)

    def train(name):
        mesh = meshes[name]
        cfg = _lm_config(n_layers=PIPE_LAYERS)
        state, shard = create_sharded_state(
            cfg, convert.random_params(cfg, 0), tx(), mesh, device="cpu",
            pipelined=True)
        step = make_pipelined_lm_train_step(mesh, n_microbatches=PIPE_M)
        toks = pipe_tokens(cfg.vocab_size)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, toks)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        res = {"metrics": metrics,
               "params": convert.gather_params(state.module),
               "specs": {n: tuple(sp) for n, sp in shard["module"].items()},
               "held": [n for n, _ in state.module.named_parameters()]}
        if name != "dp2pp2":
            return res
        # the gathered checkpoint, restored at the same layout
        names = [n for n, _ in state.module.named_parameters()]
        res["mu"] = convert.gather_named(
            dict(zip(names, state.opt_state["mu"])),
            state.module.param_specs, state.module)
        mgr = CheckpointManager(os.path.join(out, "ckpt-pipe"))
        mgr.save(STEPS, state, wait=True)
        tdist.barrier()
        fresh, _ = create_sharded_state(
            cfg, convert.random_params(cfg, 1), tx(), mesh, device="cpu",
            pipelined=True)
        mgr.restore(fresh)
        same = [torch.equal(a, b) for a, b in zip(
            fresh.module.parameters(), state.module.parameters())]
        for key in ("mu", "nu"):
            same += [torch.equal(a, b) for a, b in zip(
                fresh.opt_state[key], state.opt_state[key])]
        res["restored"] = (all(same) and len(same) == 3 * len(names)
                           and fresh.step == state.step == STEPS
                           and fresh.opt_state["count"] == STEPS)
        return res

    cases = {f"apply/{k}": (lambda k=k: apply(PIPE_APPLY[k], False))
             for k in PIPE_APPLY}
    cases["apply/grad"] = lambda: apply(PIPE_APPLY["4x6"], True)
    def fed(name):
        mesh = meshes[name]
        cfg = _lm_config(n_layers=PIPE_LAYERS)
        state, _ = create_sharded_state(
            cfg, convert.random_params(cfg, 0), tx(), mesh, device="cpu",
            pipelined=True)
        step = make_pipelined_lm_train_step(mesh, n_microbatches=PIPE_M)
        try:
            return fed_steps(step, state, mesh,
                             pipe_tokens(cfg.vocab_size))[0]
        except ValueError as e:
            return str(e)

    cases["logits"] = logits
    cases["ragged"] = ragged
    cases.update({f"train/{k}": (lambda k=k: train(k)) for k in PIPE_MESHES})
    cases.update({f"feed/{k}": (lambda k=k: fed(k)) for k in PIPE_MESHES})
    return cases


def full_mesh_tokens(vocab: int) -> np.ndarray:
    return pipe_tokens(vocab, seed=1)


def _full_mesh_suite() -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_optimizer,
        make_pipelined_lm_train_step,
    )

    def full():
        mesh = _cpu_mesh(dp=2, pp=2, tp=2)
        cfg = _lm_config(**FULL_CFG)
        state, _ = create_sharded_state(
            cfg, convert.random_params(cfg, 0),
            make_optimizer(FULL_OPT["learning_rate"], warmup_steps=1,
                           decay_steps=FULL_OPT["decay_steps"]),
            mesh, device="cpu", pipelined=True)
        step = make_pipelined_lm_train_step(mesh, n_microbatches=2)
        toks = full_mesh_tokens(cfg.vocab_size)
        losses = []
        for _ in range(FULL_STEPS):
            state, m = step(state, toks)
            losses.append(float(m["loss"]))
        return {"losses": losses}

    return {"full": full}


def _moe_mesh_suite(out: str) -> Dict[str, Callable[[], Any]]:
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.parallel.mesh import PartitionSpec, local_block
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_lm_train_step,
        make_optimizer,
    )
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    meshes = {"dp2tp2": _cpu_mesh(**MOE_MESH),
              "dcn2dp2": _cpu_mesh(dcn=2, dp=2)}
    mesh = meshes["dp2tp2"]

    def config(case):
        return _lm_config(n_experts=MOE_EXPERTS,
                          **MOE_CASES[case].get("cfg", {}))

    def train(case):
        cfg = config(case)
        on = meshes["dcn2dp2" if "mesh" in MOE_CASES[case] else "dp2tp2"]

        def tx():
            return make_optimizer(LR, **OPT,
                                  **MOE_CASES[case].get("opt", {}))

        state, _ = create_sharded_state(
            cfg, convert.random_params(cfg, 0), tx(), on, device="cpu")
        step = make_lm_train_step(on)
        toks = train_tokens("default", cfg.vocab_size)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, toks)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        res = {"metrics": metrics,
               "params": convert.gather_params(state.module)}
        if case == "dense":
            # the gathered checkpoint (experts over dp, columns over tp),
            # restored at the same layout
            mgr = CheckpointManager(os.path.join(out, "ckpt-moe"))
            mgr.save(STEPS, state, wait=True)
            tdist.barrier()
            fresh, _ = create_sharded_state(
                cfg, convert.random_params(cfg, 1), tx(), on, device="cpu")
            mgr.restore(fresh)
            res["restored"] = all(torch.equal(a, b) for a, b in zip(
                list(fresh.module.parameters()) + fresh.opt_state["mu"]
                + fresh.opt_state["nu"],
                list(state.module.parameters()) + state.opt_state["mu"]
                + state.opt_state["nu"]))
        return res

    def aux(case):
        cfg = config(case)
        model = convert.to_trainable(cfg, convert.random_params(cfg, 0),
                                     device="cpu", mesh=mesh)
        rows = local_block(torch.from_numpy(logit_tokens(cfg.vocab_size)),
                           PartitionSpec(("dcn", "dp")), mesh)
        with torch.no_grad():
            logits, total = model(rows, return_aux=True)
        return {"logits": logits, "aux": float(total)}

    cases = {f"train/{c}": (lambda c=c: train(c)) for c in MOE_CASES}
    cases.update({f"aux/{c}": (lambda c=c: aux(c))
                  for c in ("dense", "capacity")})
    return cases


def _image_state(case: str, device="cpu", mesh=None):
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.mnist import MnistCnn
    from kubeflow_tpu_torch.train import (
        TrainState,
        create_image_train_state,
        create_vit_train_state,
        make_sgd,
    )

    cfg, variables = image_variables(case)
    tx = make_sgd(IMAGE_LR, momentum=0.9)
    if case.startswith("resnet"):
        return create_image_train_state(cfg, variables, tx, device=device)
    if case == "vit":
        return create_vit_train_state(cfg, variables, tx, device=device,
                                      mesh=mesh)
    return TrainState.create(
        convert.load_params(MnistCnn(), variables).to(device).train(), tx)


# -- mesh serving and the encoders over tp ------------------------------------

# a gang's meshes by world size; tiny LMs by kv heads: tp 2 divides 2
# kv heads, not 1, and tp 4 divides neither
SERVE_MESHES = {2: {"tp2": dict(tp=2)},
                4: {"dp2tp2": dict(dp=2, tp=2), "tp4": dict(tp=4)}}
SERVE_KV = (2, 1)
# the reference engine test's requests (tests/test_engine.py:340)
SERVE_REQS = (([5, 11, 17], 6), ([3, 2, 9, 23], 4))
# the same prompts as one ragged batch for the decode functions: (B, S)
# padded, true lengths, new tokens (the longest request's)
DECODE_PROMPT = ([[5, 11, 17, 0], [3, 2, 9, 23]], [3, 4])
DECODE_NEW = 6
# the lockstep engine's traffic: a same-bucket burst (ragged), prefix
# sharers, a sampled row; a step failure on rank 0 at cycle 5
LOCKSTEP_REQS = (
    ([7, 3, 19, 4, 1, 2, 3, 4, 5, 6, 7, 8, 9], dict(max_new=5,
                                                    prefix_len=8)),
    ([5, 11, 17], dict(max_new=6)),
    ([3, 2, 9, 23], dict(max_new=4)),
    ([9, 23, 41], dict(max_new=5)),
    ([5, 11, 17, 2], dict(max_new=7, temperature=0.8, top_k=20, seed=5)),
    ([7, 3, 19, 4, 1, 2, 3, 4, 40, 41], dict(max_new=6, prefix_len=8)),
)
LOCKSTEP_SLOTS, LOCKSTEP_CYCLES, LOCKSTEP_FAIL_AT = 4, 60, 5
ENCODER_MESHES = {2: dict(tp=2), 4: dict(dp=2, tp=2)}


def serve_lm(kv_heads: int):
    """The tiny LM config and numpy weights of a mesh-serving case."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import tiny_config

    cfg = tiny_config(n_kv_heads=kv_heads)
    return cfg, convert.random_params(cfg, kv_heads)


def engine_kwargs(mode: str) -> Dict[str, Any]:
    """Dense, or paged through the kernel's wrapper (its plain version
    on CPU tensors) with 8-token pages and chunks."""
    if mode == "dense":
        return {}
    return dict(paged=True, kv_page_size=8, prefill_chunk_tokens=8,
                paged_attention_impl="kernel")


def lockstep_workload(eng, *, fail: bool = True) -> Dict[str, Any]:
    """:data:`LOCKSTEP_REQS` through ``eng`` (``autostart=False``), a
    fixed number of ``run_once`` cycles, with one injected step failure
    (recovered by replay); the streams and counters."""
    reqs = [eng.submit(p, **kw) for p, kw in LOCKSTEP_REQS]
    for cycle in range(LOCKSTEP_CYCLES):
        if fail and cycle == LOCKSTEP_FAIL_AT:
            real = eng._step, eng._step_greedy

            def boom(*a, **k):
                raise RuntimeError("injected step failure")

            eng._step = eng._step_greedy = boom
            eng.run_once(timeout=0.01)
            eng._step, eng._step_greedy = real
        else:
            eng.run_once(timeout=0.01)
    return {"streams": [r.result() for r in reqs],
            "counters": (eng.recoveries, eng.batch_prefills,
                         eng.prefix_hits, eng.prefill_chunks)}


def _serve_store(out: str) -> str:
    """Rank 0 exports the kv-2 LM and a 1-layer draft of it; every rank
    then reads the same store."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import tiny_config
    from kubeflow_tpu_torch.serving.model_store import (
        export_model,
        transformer_export_config,
    )

    base = os.path.join(out, "store")
    if tdist.get_rank() == 0:
        cfg, params = serve_lm(2)
        export_model(os.path.join(base, "lm"), "transformer", params,
                     config=transformer_export_config(cfg))
        dcfg = tiny_config(n_layers=1)
        export_model(os.path.join(base, "draft"), "transformer",
                     convert.random_params(dcfg, 9),
                     config=transformer_export_config(dcfg), draft_of="lm")
    tdist.barrier()
    return base


def _post(port: int, path: str, body: Dict[str, Any]):
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{path}",
        json.dumps(body).encode(), {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _mesh_serving_suite(out: str) -> Dict[str, Callable[[], Any]]:
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models import convert, decode
    from kubeflow_tpu_torch.serving import server as srv
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.lockstep import Lockstep

    rank = tdist.get_rank()
    meshes = {k: _cpu_mesh(**v)
              for k, v in SERVE_MESHES[tdist.get_world_size()].items()}

    def split_lm(mesh_name, kv):
        cfg, params = serve_lm(kv)
        return cfg, convert.to_module(cfg, params, device="cpu",
                                      mesh=meshes[mesh_name])

    def decoding(mesh_name, kv):
        """The decode functions on the split model: prefill and step
        logits over both caches, greedy generate, speculative generate
        with a whole draft."""
        cfg, model = split_lm(mesh_name, kv)
        prompt = torch.tensor(DECODE_PROMPT[0], dtype=torch.int32)
        lens = torch.tensor(DECODE_PROMPT[1], dtype=torch.int32)
        out = {"kv_heads": model.cache_kv_heads}
        for mode, page in (("dense", 0), ("paged", 8)):
            c = dataclasses.replace(cfg, kv_page_size=page,
                                    kv_pages=2 * (64 // 8) if page else 0,
                                    paged_attention_impl="kernel")
            cache = decode.init_cache(c, 2, device="cpu",
                                      kv_heads=model.cache_kv_heads)
            if page:
                for row in range(2):
                    decode.arm_slot(cache, row, 0,
                                    np.arange(8) + 8 * row)
            first, cache = decode.prefill(model, cache, prompt, lens)
            step, cache = decode.decode_step(
                model, cache, torch.argmax(first, -1).to(torch.int32))
            out[mode] = {"prefill": first, "step": step,
                         "cache": tuple(cache.k.shape)}
        out["generate"] = decode.generate(model, prompt,
                                          max_new_tokens=DECODE_NEW,
                                          true_len=lens)
        dcfg, dparams = serve_lm(2)
        draft = convert.to_module(dataclasses.replace(dcfg, n_layers=1),
                                  convert.random_params(dataclasses.replace(
                                      dcfg, n_layers=1), 9), device="cpu")
        toks, stats = decode.speculative_generate(
            model, draft, prompt, max_new_tokens=DECODE_NEW, draft_len=3,
            true_len=lens)
        out["speculative"] = (toks, stats)
        return out

    def engine(mesh_name, kv, mode):
        """SPMD: every rank drives its engine alike (the reference
        engine test's requests)."""
        cfg, model = split_lm(mesh_name, kv)
        eng = DecodeEngine(cfg, model, slots=2, autostart=False,
                           device="cpu", mesh=meshes[mesh_name],
                           **engine_kwargs(mode))
        reqs = [eng.submit(p, max_new=n) for p, n in SERVE_REQS]
        for _ in range(12):
            eng.run_once(timeout=0.01)
        k = eng._cache.k
        return {"streams": [r.result() for r in reqs],
                "cache": tuple(k.shape),
                "kv_bytes": 2 * k.numel() * k.element_size()}

    def lockstep(mode):
        """Rank 0 schedules, the others follow its plans; every rank
        logs the tokens it samples."""
        cfg, model = split_lm(next(iter(meshes)), 2)
        mesh = meshes[next(iter(meshes))]
        ls = Lockstep(device="cpu", timeout_s=60)
        kw = dict(slots=LOCKSTEP_SLOTS, autostart=False, device="cpu",
                  mesh=mesh, **engine_kwargs(mode))
        if rank == 0:
            eng = DecodeEngine(cfg, model, link=functools.partial(
                ls.program, "engine", "lm", 1), **kw)
            eng.token_log = []
            got = lockstep_workload(eng)
            eng.close()
            ls.stop()
            got["plans"] = ls.plans_sent
        else:
            eng = DecodeEngine(cfg, model, **kw)
            eng.token_log = []
            while True:
                op, args = ls.recv()
                if op == "stop":
                    break
                if op == "engine" and args[2] != "close":
                    eng.follow(args[2], args[3:])
            got = {}
        got["log"] = eng.token_log
        return got

    def serve(decode_slots):
        """A ModelServer over the mesh on rank 0, followers elsewhere:
        ``:generate`` (engine or unary), speculative, ``:predict`` and
        gRPC ``Generate``; each rank's blocks of the loaded LM."""
        base = _serve_store(out)
        mesh = meshes[next(iter(meshes))]
        if rank != 0:
            f = srv.serve_follower(base, mesh, device="cpu", record=True)
            shapes = {n: tuple(p.shape) for n, p in
                      f.models[("lm", 1)].module.named_parameters()} \
                if ("lm", 1) in f.models else {}
            return {"shapes": shapes,
                    "logs": {k: v for k, v in f.token_logs.items()}}
        s = srv.ModelServer(base, port=0, poll_interval_s=3600,
                            decode_slots=decode_slots, decode_mesh=mesh,
                            device="cpu")
        port = s.start()
        got: Dict[str, Any] = {}
        try:
            lm = s.repo.get("lm")
            got["shapes"] = {n: tuple(p.shape)
                             for n, p in lm.module.named_parameters()}
            eng = s.repo.engine_for("lm", lm)
            if eng is not None:
                eng.token_log = []
                got["engine_mesh"] = eng.mesh is mesh
            prompts = [p for p, _ in SERVE_REQS]
            got["generate"] = _post(port, "lm:generate", {
                "prompt_tokens": prompts, "max_new_tokens": 5})
            got["sampled"] = _post(port, "lm:generate", {
                "prompt_tokens": [prompts[0]], "max_new_tokens": 4,
                "temperature": 0.7, "top_k": 10, "seed": 3})
            if decode_slots == 0:
                got["speculative"] = _post(port, "lm:generate", {
                    "prompt_tokens": prompts, "max_new_tokens": 5,
                    "speculative": True, "draft_len": 3})
                got["predict"] = _post(port, "lm:predict", {
                    "instances": [prompts[0]]})
            from kubeflow_tpu_torch.serving.grpc_server import (
                PredictClient,
                serve_grpc,
            )

            gsrv, gport = serve_grpc(s.repo, 0)
            client = PredictClient(f"127.0.0.1:{gport}")
            try:
                got["grpc"] = client.generate(
                    "lm", np.asarray([prompts[0]], np.int32),
                    max_new_tokens=5)[0].tolist()
                got["grpc_stream"] = [
                    np.asarray(row).tolist() for row in client.generate_stream(
                        "lm", np.asarray([prompts[0]], np.int32),
                        max_new_tokens=5)]
            finally:
                client.close()
                gsrv.stop(grace=None)
            if eng is not None:
                got["log"] = list(eng.token_log)
        finally:
            s.stop()
        got["plans"] = s.repo.lockstep.plans_sent
        return got

    def refused():
        """Decoding from a MoE model over tp, or from a pipeline stage,
        refuses by its ROADMAP item."""
        from kubeflow_tpu_torch.models.transformer import tiny_config

        out = []
        for cfg, mesh in (
                (tiny_config(n_experts=4), meshes[next(iter(meshes))]),
                (tiny_config(), _cpu_mesh(pp=2, **(
                    {"tp": 2} if tdist.get_world_size() == 4 else {})))):
            model = convert.to_module(cfg, convert.random_params(cfg, 0),
                                      device="cpu", mesh=mesh)
            try:
                decode.generate(model, torch.tensor([[5, 11, 17]]),
                                max_new_tokens=2)
                out.append("no error")
            except NotImplementedError as e:
                out.append(str(e))
        return out

    cases: Dict[str, Callable[[], Any]] = {"refused": refused}
    for m in meshes:
        for kv in SERVE_KV:
            cases[f"decode/{m}/kv{kv}"] = functools.partial(decoding, m, kv)
            for mode in ("dense", "paged"):
                cases[f"engine/{m}/kv{kv}/{mode}"] = functools.partial(
                    engine, m, kv, mode)
    for mode in ("dense", "paged"):
        cases[f"lockstep/{mode}"] = functools.partial(lockstep, mode)
    cases["serve/engine"] = functools.partial(serve, 2)
    cases["serve/unary"] = functools.partial(serve, 0)
    return cases


def _encoder_tp_suite() -> Dict[str, Callable[[], Any]]:
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import bert_tiny
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        make_image_train_step,
        make_mlm_train_step,
        make_optimizer,
    )

    mesh = _cpu_mesh(**ENCODER_MESHES[tdist.get_world_size()])

    def mlm():
        cfg = dataclasses.replace(bert_tiny(), dtype="float32")
        state = create_bert_train_state(
            cfg, convert.random_bert_params(cfg, 0),
            make_optimizer(LR, **OPT), device="cpu", mesh=mesh)
        step = make_mlm_train_step(mesh)
        batch = mlm_inputs(cfg.vocab_size)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, *batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        return {"metrics": metrics,
                "shapes": {n: tuple(p.shape)
                           for n, p in state.module.named_parameters()},
                "params": convert.gather_params(state.module)}

    def image(case):
        state = _image_state(case, mesh=mesh)
        step = make_image_train_step(mesh)
        images, labels = image_inputs(case)
        metrics = []
        for _ in range(IMAGE_STEPS):
            state, m = step(state, images, labels)
            metrics.append((float(m["loss"]), float(m["accuracy"]),
                            int(m["step"]), float(m["grad_norm"])))
        return {"metrics": metrics,
                "specs": getattr(state.module, "param_specs", {}),
                "state": {n: t.detach().clone() for n, t in
                          convert.gather_named(
                              dict(state.module.state_dict()),
                              getattr(state.module, "param_specs", {}),
                              state.module).items()}}

    def refused():
        pmesh_ = _cpu_mesh(pp=2, **({"tp": 2} if tdist.get_world_size() == 4
                                    else {}))
        out = []
        for make in (make_mlm_train_step, make_image_train_step):
            try:
                make(pmesh_)
                out.append("no error")
            except NotImplementedError as e:
                out.append(str(e))
        return out

    return {"mlm": mlm, **{f"image/{c}": functools.partial(image, c)
                           for c in IMAGE_CASES}, "refused": refused}


def _image_mesh_suite() -> Dict[str, Callable[[], Any]]:
    import copy

    import torch.distributed as tdist

    from kubeflow_tpu_torch.models.resnet import global_batch_stats
    from kubeflow_tpu_torch.parallel.mesh import PartitionSpec, local_block
    from kubeflow_tpu_torch.train import (
        make_image_train_step,
        softmax_cross_entropy,
    )

    mesh = _cpu_mesh(dp=4)
    rows = PartitionSpec(("dcn", "dp"))

    def grads(state, images, labels):
        """The step's gradients at the state's weights: each rank's rows
        through a copy of the module (its BN statistics untouched), the
        loss's gradient averaged over the ranks."""
        model = copy.deepcopy(state.module)
        with global_batch_stats(mesh):
            logits = model(local_block(images, rows, mesh), train=True)
        loss = softmax_cross_entropy(logits,
                                     local_block(labels, rows, mesh).long())
        params = [p for p in model.parameters() if p.requires_grad]
        out = []
        for g in torch.autograd.grad(loss, params):
            tdist.all_reduce(g)
            out.append(g / 4)
        return dict(zip([n for n, p in model.named_parameters()
                         if p.requires_grad], out))

    def train(case):
        state = _image_state(case)
        images, labels = (torch.from_numpy(a) for a in image_inputs(case))
        res = {"grads": grads(state, images, labels), "metrics": []}
        step = make_image_train_step(mesh)
        for _ in range(IMAGE_STEPS):
            state, m = step(state, images, labels)
            res["metrics"].append((float(m["loss"]), float(m["accuracy"]),
                                   int(m["step"])))
        res["state"] = {n: t.detach().clone() for n, t in
                        state.module.state_dict().items()}
        return res

    def fed(case):
        return fed_steps(make_image_train_step(mesh), _image_state(case),
                         mesh, image_inputs(case), IMAGE_STEPS)[0]

    cases = {f"train/{c}": (lambda c=c: train(c)) for c in IMAGE_CASES}
    cases.update({f"feed/{c}": (lambda c=c: fed(c))
                  for c in IMAGE_FEED_CASES})
    return cases


LM_TINY = ["--device", "cpu", "--vocab-size", "128", "--d-model", "32",
           "--n-layers", "3", "--n-heads", "4", "--d-ff", "64", "--seq-len",
           "16", "--per-device-batch", "2", "--log-every", "1"]
BERT_TINY = ["--device", "cpu", "--vocab-size", "128", "--d-model", "32",
             "--n-layers", "2", "--n-heads", "4", "--d-ff", "64",
             "--seq-len", "16", "--per-device-batch", "2", "--log-every",
             "1", "--checkpoint-every", "2"]
VIT_TINY = ["--device", "cpu", "--image-size", "32", "--patch-size", "8",
            "--num-classes", "10", "--d-model", "32", "--n-layers", "1",
            "--n-heads", "4", "--d-ff", "64", "--per-device-batch", "4",
            "--steps", "1"]
# the image entry points at dp = 2, and the argv of one rank on the same
# global batch: (module, argv at dp = 2, argv at dp = 1)
IMAGE_ENTRY = {
    "resnet": ["--device", "cpu", "--image-size", "32", "--num-classes",
               "10", "--steps", "2", "--warmup-steps", "1", "--log-every",
               "1"],
    "vit": ["--device", "cpu", "--image-size", "32", "--patch-size", "8",
            "--num-classes", "10", "--d-model", "32", "--n-layers", "1",
            "--n-heads", "4", "--d-ff", "64", "--steps", "2",
            "--log-every", "1"],
    "mnist": ["--device", "cpu", "--steps", "3", "--batch-size", "16",
              "--log-every", "1"],
}
IMAGE_ENTRY_BATCH = {"resnet": 2, "vit": 4}   # per device, at dp = 2


def image_entry_argv(entry: str, dp: int) -> List[str]:
    argv = list(IMAGE_ENTRY[entry])
    if entry in IMAGE_ENTRY_BATCH:
        argv += ["--per-device-batch", str(IMAGE_ENTRY_BATCH[entry] * 2 // dp)]
    return argv


@contextlib.contextmanager
def f32_image_entry(entry: str):
    """The entry point's model at f32 and test size: ``resnet18_thin``
    (f32 already) over ResNet-50, the ViT config at f32 compute."""
    from kubeflow_tpu_torch.examples import resnet, vit
    from kubeflow_tpu_torch.models.resnet import resnet18_thin
    from kubeflow_tpu_torch.models.vit import ViTConfig

    saved = resnet.resnet50, vit.ViTConfig
    resnet.resnet50 = lambda num_classes=1000: resnet18_thin(num_classes)
    vit.ViTConfig = lambda **kw: ViTConfig(**dict(kw, dtype="float32"))
    try:
        yield
    finally:
        resnet.resnet50, vit.ViTConfig = saved


def f32_config(**kw):
    """``examples.lm``'s config at f32 compute."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**dict(kw, dtype=torch.float32))


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _examples_suite(out: str) -> Dict[str, Callable[[], Any]]:
    from kubeflow_tpu_torch.examples import common
    from kubeflow_tpu_torch.examples import lm as lm_example
    from kubeflow_tpu_torch.examples import vit as vit_example
    from kubeflow_tpu_torch.parallel import mesh as pmesh
    from kubeflow_tpu_torch.serving import model_store
    from kubeflow_tpu_torch.train import checkpoint

    rank = int(os.environ["KFTPU_PROCESS_ID"])

    def launcher(env, **kw):
        with _env(**env):
            _, mesh, dev = common.launcher_init(device="cpu", **kw)
        return {"sizes": [pmesh.axis_size(mesh, a) for a in pmesh.MESH_AXES],
                "device": str(dev)}

    def lm_run(job, argv, f32=False):
        """``examples.lm.main`` with this rank's checkpoint writes and
        exports counted; ``f32``: the model computes in f32 (bf16
        rounds a tp-split sum otherwise than a whole one)."""
        counts = {"writes": 0, "exports": 0}
        write, export = (checkpoint.CheckpointManager._write,
                         model_store.export_model)
        config = lm_example.TransformerConfig
        if f32:
            lm_example.TransformerConfig = f32_config

        def counted_write(self, *a):
            counts["writes"] += 1
            return write(self, *a)

        def counted_export(*a, **kw):
            counts["exports"] += 1
            return export(*a, **kw)

        checkpoint.CheckpointManager._write = counted_write
        model_store.export_model = counted_export
        try:
            with _env(KFTPU_CHECKPOINT_DIR=os.path.join(out, f"ckpt-{job}"),
                      KFTPU_RESULTS_DIR=os.path.join(out, "results"),
                      KFTPU_JOB_NAME=job):
                loss = lm_example.main(LM_TINY + argv)
        finally:
            checkpoint.CheckpointManager._write = write
            model_store.export_model = export
            lm_example.TransformerConfig = config
        return dict(counts, loss=loss)

    def bert_tp2():
        """``examples.bert.main`` at tp = 2 (``auto_mesh_config``'s on
        two processes) with a checkpoint at step 2: the final loss, and
        the saved ``token_embed``'s shape (whole, gathered)."""
        from kubeflow_tpu_torch.examples import bert as bert_example

        ckpt = os.path.join(out, "bert-tp2")
        with _env(KFTPU_CHECKPOINT_DIR=ckpt, KFTPU_JOB_NAME="bert-tp2"):
            loss = bert_example.main(BERT_TINY + ["--steps", "2"])
        torch.distributed.barrier()     # rank 0's save is on disk
        saved = torch.load(os.path.join(ckpt, "2", checkpoint.STATE_FILE),
                           map_location="cpu", weights_only=True)
        return loss, tuple(saved["module"]["token_embed"].shape)

    def image_run(entry):
        """The entry point at dp = 2 (``tp=1``: the image step splits the
        batch only); its results file, which rank 0 alone writes."""
        import importlib

        module = importlib.import_module(
            f"kubeflow_tpu_torch.examples.{entry}")
        with _env(KFTPU_RESULTS_DIR=os.path.join(out, "results"),
                  KFTPU_JOB_NAME=f"image-{entry}"), f32_image_entry(entry):
            module.main(image_entry_argv(entry, 2))
        return "ran"

    return {
        "launcher/processes": lambda: launcher({}),
        "launcher/slices": lambda: launcher(
            {"MEGASCALE_NUM_SLICES": 2, "MEGASCALE_SLICE_ID": rank}),
        "launcher/tp": lambda: launcher({}, tp=1),
        "lm/dp2": lambda: lm_run("dp2", [
            "--tp", "1", "--steps", "3", "--checkpoint-every", "2",
            "--generate", "3",
            "--export", os.path.join(out, "export-dp2", "lm")]),
        "lm/tp2": lambda: lm_run("tp2", ["--tp", "2", "--steps", "2",
                                         "--checkpoint-every", "1"],
                                 f32=True),
        "launcher/pp2": lambda: launcher({}, pp=2),
        "lm/moe_dp2": lambda: lm_run("moe-dp2", [
            "--tp", "1", "--n-experts", "4", "--steps", "2"], f32=True),
        "vit/tp2": lambda: vit_example.main(VIT_TINY + ["--tp", "2"]),
        "bert/tp2": lambda: bert_tp2(),
        **{f"image/{e}": (lambda e=e: image_run(e)) for e in IMAGE_ENTRY},
    }


def _elastic_suite(out: str) -> Dict[str, Callable[[], Any]]:
    """4 ranks: the spec derivation at 2 and 1 slices of tp 2, then a
    shrink from 2 slices to 1 through the coordinator (ranks 2-3 take
    part in the snapshot and leave; ranks 0-1 re-enter a fresh gloo
    group of 2 through the production re-init, from a refreshed env)."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch.elastic import (
        ElasticCoordinator,
        ResizeSignal,
        lm_init_fn,
        mesh_for_slices,
        shardings_for,
    )
    from kubeflow_tpu_torch.elastic.coordinator import _default_reinit
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.obs.trace import SpanCollector, Tracer
    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.testing.multiprocess import _free_port
    from kubeflow_tpu_torch.train import checkpoint as ckpt
    from kubeflow_tpu_torch.train import make_lm_train_step, make_optimizer

    cfg = _lm_config(**ELASTIC_CFG)
    init_fn = lm_init_fn(cfg, convert.random_params(cfg, 0),
                         make_optimizer(**ELASTIC_OPT))

    def mesh_factory(n):
        return mesh_for_slices(n, tp=2, device_type="cpu")

    def plain(tree):
        """Specs as plain tuples (a pickled PartitionSpec nests)."""
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [plain(v) for v in tree]
        return tuple(tree)

    def specs():
        abstract = init_fn(None, torch.device("meta"))
        return {n: plain(shardings_for(abstract, mesh_factory(n)))
                for n in (2, 1)}

    def whole(state):
        """The state as its checkpoint saves it (a collective)."""
        return ckpt._to_host(ckpt._gather_state(
            ckpt._tree(state), ckpt._specs(state), state))

    def regang(n_slices):
        """The operator's refreshed env contract (a new coordinator
        address, agreed over the old group), then the production
        re-init."""
        port = [_free_port() if tdist.get_rank() == 0 else None]
        tdist.broadcast_object_list(port, src=0)
        os.environ.update({
            dist.ENV_COORDINATOR: f"127.0.0.1:{port[0]}",
            dist.ENV_NUM_PROCESSES: str(2 * n_slices),
            dist.ENV_NUM_SLICES: str(n_slices)})
        _default_reinit(n_slices)

    def shrink():
        collector, signal = SpanCollector(), ResizeSignal()
        coord = ElasticCoordinator(
            manager=ckpt.CheckpointManager(os.path.join(out, "elastic")),
            init_fn=init_fn, make_step=make_lm_train_step,
            mesh_factory=mesh_factory, signal=signal, reinit=regang,
            tracer=Tracer(collector), device="cpu", **ELASTIC_JOB)
        state, start = coord.start(2)
        metrics = []

        def step(n):
            nonlocal state
            state, m = coord.step_fn(state, elastic_tokens(n))
            coord.step = n
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))

        for n in (1, 2, 3):
            step(n)
        pre = whole(state)
        signal.request(1)
        res = {"start": start, "world": tdist.get_world_size(),
               "metrics": metrics}
        try:
            state, resized = coord.maybe_resize(state)
        except SystemExit:
            return {**res, "left": True, "saves": coord.snapshotter.saves}
        post = whole(state)
        step(4)
        return {**res, "left": False, "resized": resized,
                "saves": coord.snapshotter.saves,
                "n_slices": coord.n_slices,
                "new_world": tdist.get_world_size(),
                "state_step": state.step, "pre": pre, "post": post,
                "spans": [(s.name, s.trace_id, s.parent_id)
                          for s in collector.spans()]}

    return {"specs": specs, "shrink": shrink}


def _run(suite: str, out: str) -> None:
    from kubeflow_tpu_torch.parallel import distributed as dist

    torch.set_num_threads(1)
    penv = dist.from_env()
    ran: Dict[str, Any] = {}
    if suite == "collectives":
        # the smoke workload first: it brings the process group up and
        # prints its JSON line on every rank
        from kubeflow_tpu_torch.testing import collective_check

        ran["collective_check"] = collective_check.main(["--device", "cpu"])
    else:
        dist.initialize(penv, backend="gloo")
    cases = {"mesh": _mesh_suite, "collectives": _collectives_suite,
             "seq_parallel": _seq_parallel_suite,
             "mesh_train": _mesh_train_suite, "mlm": _mlm_suite,
             "pipeline": lambda: _pipeline_suite(out),
             "full_mesh": _full_mesh_suite,
             "moe_mesh": lambda: _moe_mesh_suite(out),
             "image_mesh": _image_mesh_suite,
             "mesh_serving": lambda: _mesh_serving_suite(out),
             "encoder_tp": _encoder_tp_suite,
             "elastic": lambda: _elastic_suite(out),
             "examples": lambda: _examples_suite(out)}[suite]()
    for name, fn in cases.items():
        try:
            ran[name] = fn()
        except Exception:  # noqa: BLE001 — reported to the test, per case
            ran[name] = {"error": traceback.format_exc()}
    torch.save(ran, os.path.join(out, f"rank{penv.process_id}.pt"))


# -- test side --------------------------------------------------------------


class Gang:
    """A gang of ``n`` ranks running ``suite``, started at once in a
    thread so the caller can compute its side meanwhile; :meth:`case`
    waits for it."""

    def __init__(self, suite: str, n: int, out: str) -> None:
        from kubeflow_tpu_torch.testing import run_multiprocess

        self.out, self.n = str(out), n
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._future = self._pool.submit(
            run_multiprocess, [os.path.abspath(__file__), suite, self.out],
            n, timeout_s=GANG_TIMEOUT_S, job_name=f"gang-{suite}")
        self._ranks: List[Dict[str, Any]] = []

    def results(self) -> List[Dict[str, Any]]:
        if not self._ranks:
            procs = self._future.result()
            self._pool.shutdown()
            for r in procs:
                if r.returncode != 0:
                    raise AssertionError(
                        f"rank {r.process_id} ended with {r.returncode}:\n"
                        f"{r.stderr[-3000:]}")
            self.stdout = [r.stdout for r in procs]
            self._ranks = [torch.load(os.path.join(self.out, f"rank{i}.pt"),
                                      weights_only=False)
                           for i in range(self.n)]
        return self._ranks

    def case(self, name: str) -> List[Any]:
        """The case's result on every rank, in rank order; a rank's error
        fails the caller with its traceback."""
        got = [r[name] for r in self.results()]
        for i, g in enumerate(got):
            if isinstance(g, dict) and set(g) == {"error"}:
                raise AssertionError(f"rank {i}, case {name}:\n{g['error']}")
        return got


if __name__ == "__main__":
    _run(sys.argv[1], sys.argv[2])
