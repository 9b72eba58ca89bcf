"""Serving over every mesh the reference serves on, against the JAX
package: MoE models split over ``tp`` and ``ep``, ``pp`` as a replica
axis, and what ``dp`` does to the reference's cache.

Three gloo gangs (``tests/torch_gang.py``, suite ``compose_serving``)
serve on the CPU at f32, 2 ranks (``tp=2``, ``pp=2``), 4 (``dp=2 ×
tp=2``, the experts split over ``dp``; ``pp=2 × tp=2``) and 8 (``dp=2 ×
tp=4``, the reference's mesh), a ``tiny_config`` LM with 4 experts under
the dense and the capacity dispatch, numpy-seeded:

- the decode functions: the split model's ragged prefill and next-step
  logits, dense and paged, within 1e-5 of JAX's ``prefill`` and
  ``decode_step``; greedy ``generate`` identical to JAX's;
- the engine (``tests/test_engine.py:743``'s MoE engine, the requests
  of ``:340``), dense and paged: every rank's streams equal to the JAX
  engine's on its ``dp=2,tp=4`` mesh and unsplit; over ``pp`` every rank
  holds every block;
- lockstep over ``pp=2`` and ``pp=2 × tp=2``: rank 0 schedules, the
  others follow; the streams and counters equal the unsplit engine's;
- ``server.main`` over ``KFTPU_SERVING_MESH=pp=2``.

The reference's engine at ``dp=2,tp=4`` declares every cache leaf whole
over ``dp`` (the slots replicated, as the port keeps them), and XLA's
partitioner lays the dense cache's slots and every ``positions`` leaf
over ``dp`` on the first step's output; the test pins both readings.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import shard_params
from kubeflow_tpu.models import TransformerConfig as JaxConfig
from kubeflow_tpu.models import decode as jdec
from kubeflow_tpu.parallel import MeshConfig, create_mesh
from kubeflow_tpu.serving.engine import DecodeEngine as JaxEngine
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.serving.model_store import transformer_export_config
from kubeflow_tpu_torch.testing import run_multiprocess
from torch_gang import (
    COMPOSE_DISPATCH,
    COMPOSE_SERVE_MESHES,
    DECODE_NEW,
    DECODE_PROMPT,
    LOCKSTEP_SLOTS,
    SERVE_REQS,
    Gang,
    engine_kwargs,
    lockstep_workload,
    serve_lm,
    serve_moe,
)

ATOL = 1e-5
MODES = ("dense", "paged")
CASES = [(n, m) for n, meshes in COMPOSE_SERVE_MESHES.items()
         for m in meshes]
PP_CASES = [(n, m) for n, m in CASES if m.startswith("pp")]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return {n: Gang("compose_serving", n,
                    tmp_path_factory.mktemp(f"cs{n}"))
            for n in COMPOSE_SERVE_MESHES}


def _jax_lm(cfg, params):
    jc = JaxConfig(**{**transformer_export_config(cfg),
                      "dtype": jnp.float32})
    return jc, jax.tree_util.tree_map(jnp.asarray,
                                      convert.unflatten(params))


def _jax_engine(jc, params, mesh, **kw):
    eng = JaxEngine(jc, params if mesh is None else
                    shard_params(params, mesh), slots=2, mesh=mesh,
                    autostart=False, **kw)
    reqs = [eng.submit(p, max_new=n) for p, n in SERVE_REQS]
    for _ in range(12):
        eng.run_once(timeout=0.01)
    out = [r.result() for r in reqs]
    return eng, out


@pytest.fixture(scope="module")
def oracle():
    """JAX's answers for the MoE LM by dispatch: the decode logits and
    greedy stream, and its engine's streams unsplit and on its
    ``dp=2,tp=4`` mesh (the experts over dp, their hidden width over
    tp)."""
    out = {}
    prompt = jnp.asarray(DECODE_PROMPT[0], jnp.int32)
    lens = jnp.asarray(DECODE_PROMPT[1], jnp.int32)
    mesh = create_mesh(MeshConfig(dp=2, tp=4))
    for dispatch in COMPOSE_DISPATCH:
        jc, params = _jax_lm(*serve_moe(dispatch))
        first, cache = jdec.prefill(jc, params, prompt, lens)
        step, _ = jdec.decode_step(jc, params, cache,
                                   jnp.argmax(first, -1).astype(jnp.int32))
        got = {"prefill": np.asarray(first), "step": np.asarray(step),
               "generate": np.asarray(jdec.generate(
                   jc, params, prompt, max_new_tokens=DECODE_NEW,
                   true_len=lens))}
        for mode in MODES:
            kw = dict(paged=True, kv_page_size=8) if mode == "paged" else {}
            for name, m in (("unsplit", None), ("dp2tp4", mesh)):
                eng, streams = _jax_engine(jc, params, m, **kw)
                eng.close()
                got[(mode, name)] = streams
        out[dispatch] = got
    return out


@pytest.mark.parametrize("dispatch", list(COMPOSE_DISPATCH))
@pytest.mark.parametrize("n,mesh", CASES)
def test_moe_decode_on_split_model_matches_jax(gangs, oracle, n, mesh,
                                               dispatch):
    want = oracle[dispatch]
    cfg, _ = serve_moe(dispatch)
    layout = COMPOSE_SERVE_MESHES[n][mesh]
    ep, tp = layout.get("dp", 1), layout.get("tp", 1)
    for rank, got in enumerate(gangs[n].case(f"decode/{mesh}/{dispatch}")):
        # every block on every rank; its experts' block over dp and tp
        assert got["blocks"] == cfg.n_layers
        assert got["experts"] == (cfg.n_experts // ep, cfg.d_model,
                                  cfg.d_ff // tp)
        for mode in MODES:
            for key in ("prefill", "step"):
                np.testing.assert_allclose(
                    got[mode][key].numpy(), want[key], atol=ATOL, rtol=0,
                    err_msg=f"{mode} {key} rank {rank}")
        np.testing.assert_array_equal(got["generate"].numpy(),
                                      want["generate"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dispatch", list(COMPOSE_DISPATCH))
@pytest.mark.parametrize("n,mesh", CASES)
def test_moe_engine_on_split_model_matches_jax_engine(gangs, oracle, n,
                                                      mesh, dispatch,
                                                      mode):
    want = oracle[dispatch][(mode, "dp2tp4")]
    assert want == oracle[dispatch][(mode, "unsplit")]
    cfg, _ = serve_moe(dispatch)
    tp = COMPOSE_SERVE_MESHES[n][mesh].get("tp", 1)
    for rank, got in enumerate(
            gangs[n].case(f"engine/{mesh}/{dispatch}/{mode}")):
        assert got["streams"] == want, f"rank {rank}"
        kv = cfg.n_kv_heads
        assert got["cache"][3] == (kv // tp if kv % tp == 0 else kv)


@pytest.fixture(scope="module")
def unsplit_lockstep():
    cfg, params = serve_lm(2)
    model = convert.to_module(cfg, params, device="cpu")
    return {mode: lockstep_workload(DecodeEngine(
        cfg, model, slots=LOCKSTEP_SLOTS, autostart=False, device="cpu",
        **engine_kwargs(mode))) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,mesh", PP_CASES)
def test_lockstep_over_pp_matches_unsplit(gangs, unsplit_lockstep, n, mesh,
                                          mode):
    """``pp`` replicates a served model: every rank holds every block,
    and the lockstep engine's streams and counters are the unsplit
    engine's; every rank samples the same tokens."""
    cfg, _ = serve_lm(2)
    got = gangs[n].case(f"lockstep/{mesh}/{mode}")
    want = unsplit_lockstep[mode]
    assert got[0]["streams"] == want["streams"]
    assert got[0]["counters"] == want["counters"]
    logs = [g["log"] for g in got]
    for rank, (g, log) in enumerate(zip(got, logs)):
        assert g["blocks"] == cfg.n_layers
        assert len(log) == len(logs[0]) > 0
        for (op0, t0), (op, t) in zip(logs[0], log):
            assert op == op0
            np.testing.assert_array_equal(t, t0, err_msg=f"rank {rank}")


_MAIN = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.path.join(os.environ["KFTPU_REPO"], "tests"))
    from torch_gang import SERVE_REQS, _post
    from kubeflow_tpu_torch.parallel import mesh as pmesh
    from kubeflow_tpu_torch.serving import server as srv

    def probe(_):
        (server,) = made
        got = _post(server.port, "lm:generate", {
            "prompt_tokens": [p for p, _ in SERVE_REQS],
            "max_new_tokens": 5})
        mesh = server.repo.decode_mesh
        print(json.dumps({"got": got, "sizes": [
            pmesh.axis_size(mesh, a) for a in pmesh.MESH_AXES]}))
        raise KeyboardInterrupt

    made = []

    class Server(srv.ModelServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    srv.ModelServer = Server
    srv.time.sleep = probe
    srv.main(device="cpu")
""")


def test_main_serves_over_a_pp_mesh(tmp_path):
    """``server.main`` on both ranks of a gang with
    ``KFTPU_SERVING_MESH=pp=2``: rank 0 serves ``:generate`` with the
    JAX engine's tokens, rank 1 follows, and both end when rank 0
    stops."""
    import json
    import os

    from kubeflow_tpu_torch.serving.model_store import export_model

    cfg, params = serve_lm(2)
    export_model(str(tmp_path / "lm"), "transformer", params,
                 config=transformer_export_config(cfg))
    jc, jparams = _jax_lm(cfg, params)
    want = np.asarray(jdec.generate(
        jc, jparams, jnp.asarray(DECODE_PROMPT[0], jnp.int32),
        max_new_tokens=5,
        true_len=jnp.asarray(DECODE_PROMPT[1], jnp.int32)))[:, :5].tolist()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lead, follower = run_multiprocess(["-c", _MAIN], 2, timeout_s=90, env={
        "KFTPU_SERVING_MESH": "pp=2", "KFTPU_MODEL_BASE_PATH":
        str(tmp_path), "KFTPU_REST_PORT": "0", "KFTPU_GRPC_PORT": "0",
        "KFTPU_DECODE_SLOTS": "2", "KFTPU_REPO": repo})
    assert lead.returncode == 0, lead.stderr[-3000:]
    assert follower.returncode == 0, follower.stderr[-3000:]
    out = json.loads(lead.stdout.strip().splitlines()[-1])
    assert out["sizes"] == [1, 1, 2, 1]
    code, body = out["got"]
    assert code == 200 and body["tokens"] == want


@pytest.mark.parametrize("mode", MODES)
def test_reference_engine_keeps_slots_whole_over_dp(mode):
    """What the reference's engine does with ``dp`` (``dp=2,tp=4``): its
    fresh cache names no ``dp`` (the slots are replicated over it, as
    the port's engine keeps them on every data rank), its step takes
    host arrays, and XLA lays the ``positions`` of the first step's
    output cache (and, dense, its slots) over ``dp``. The tokens equal
    the unsplit engine's, as the port's over ``dp`` do
    (``tests/test_torch_mesh_serving.py``)."""
    cfg, params = serve_lm(2)
    jc, jparams = _jax_lm(cfg, params)
    mesh = create_mesh(MeshConfig(dp=2, tp=4))
    kw = dict(paged=True, kv_page_size=8) if mode == "paged" else {}
    eng = JaxEngine(jc, shard_params(jparams, mesh), slots=4, mesh=mesh,
                    autostart=False, **kw)
    fresh = {jax.tree_util.keystr(p): leaf.sharding
             for p, leaf in jax.tree_util.tree_leaves_with_path(eng._cache)}
    for name, sharding in fresh.items():
        assert "dp" not in str(sharding.spec), name
    reqs = [eng.submit(p, max_new=n) for p, n in SERVE_REQS]
    for _ in range(12):
        eng.run_once(timeout=0.01)
    assert isinstance(eng._tokens, np.ndarray)
    after = {jax.tree_util.keystr(p): leaf
             for p, leaf in jax.tree_util.tree_leaves_with_path(eng._cache)}
    pos = next(v for k, v in after.items() if "positions" in k)
    assert {s.index[1] for s in pos.addressable_shards} == {
        slice(0, 2), slice(2, 4)}
    k = next(v for k, v in after.items() if k.endswith("['k']"))
    rows = {s.index[1] for s in k.addressable_shards}
    assert rows == ({slice(0, 2), slice(2, 4)} if mode == "dense"
                    else {slice(None)})
    got = [r.result() for r in reqs]
    eng.close()
    _, whole = _jax_engine(jc, jparams, None, **kw)
    assert got == whole

