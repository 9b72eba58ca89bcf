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


def block(x: np.ndarray, how: str, n: int, i: int) -> np.ndarray:
    """Block ``i`` of ``n`` of ``x``: ``rows`` (dim 0), ``cols`` (dim 1)
    or ``all`` (the whole)."""
    if how == "all":
        return x
    d = 0 if how == "rows" else 1
    size = x.shape[d] // n
    return np.take(x, range(i * size, (i + 1) * size), axis=d)


# -- rank side --------------------------------------------------------------


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

    cases = {f"train/{c}": (lambda c=c: train(c)) for c in TRAIN_CASES}
    cases.update({f"logits/{i}": (lambda i=i: logits(i))
                  for i in LOGIT_IMPLS})
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

    return {"mlm": mlm}


LM_TINY = ["--device", "cpu", "--vocab-size", "128", "--d-model", "32",
           "--n-layers", "3", "--n-heads", "4", "--d-ff", "64", "--seq-len",
           "16", "--per-device-batch", "2", "--log-every", "1"]
RESNET_TINY = ["--device", "cpu", "--image-size", "32", "--num-classes",
               "10", "--per-device-batch", "4", "--steps", "1"]
VIT_TINY = ["--device", "cpu", "--image-size", "32", "--patch-size", "8",
            "--num-classes", "10", "--d-model", "32", "--n-layers", "1",
            "--n-heads", "4", "--d-ff", "64", "--per-device-batch", "4",
            "--steps", "1"]


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

    def refused(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return "no error"

    def image_refusals():
        from kubeflow_tpu_torch.examples import mnist, resnet, vit

        return {"resnet": refused(lambda: resnet.main(RESNET_TINY)),
                "vit": refused(lambda: vit.main(VIT_TINY)),
                "mnist": refused(lambda: mnist.main(
                    ["--device", "cpu", "--steps", "1"]))}

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
        "lm/moe_dp2": lambda: refused(lambda: lm_example.main(
            LM_TINY + ["--tp", "1", "--n-experts", "8", "--steps", "1"])),
        "image_refusals": image_refusals,
    }


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
