"""Serving an LM split over a tensor-parallel mesh against the JAX package.

Two gloo gangs (``tests/torch_gang.py``, suite ``mesh_serving``) run the
port's mesh serving on the CPU: 2 ranks (``tp=2``) and 4 ranks
(``dp=2 × tp=2`` and ``tp=4``), each over ``tiny_config`` LMs with 2 kv
heads and with 1 (so ``tp`` divides the kv heads or does not, and the
cache holds ``KH/tp`` heads or all of them), f32, numpy-seeded weights.
The pytest process computes the JAX package's answers meanwhile:

- the decode functions (``tests/test_decode.py:444``): the split model's
  ragged prefill and next-step logits, dense and paged, within 1e-5 of
  JAX's ``prefill``/``decode_step``; greedy ``generate`` identical to
  JAX's and to its run on the ``dp=2,tp=4`` mesh; speculative decoding
  with a split target and a whole draft equal to the plain stream
  (``tests/test_speculative.py:160``);
- the engine (``tests/test_engine.py:340``): every rank driving its
  engine alike, dense and paged, gives the JAX engine's tokens on its
  ``dp=2,tp=4`` and ``dp=4,tp=2`` meshes and the unsplit oracle's; each
  rank's cache holds ``KH/tp`` kv heads (all where ``tp`` does not divide
  them), so a rank's pool is ``1/tp`` of the unsplit one's bytes;
- lockstep: rank 0 schedules and the others follow its plans through a
  burst, prefix sharing, chunked prefill, a sampled row and a recovered
  step failure; the streams and counters equal the unsplit port
  engine's on the same schedule, and every rank samples the same tokens;
- the server (``tests/test_engine.py:378``): ``:generate`` (engine and
  unary), speculative ``:generate``, ``:predict`` and gRPC
  ``Generate``/``GenerateStream`` answer the oracle's tokens over the
  mesh, and each rank holds only its block of every split leaf.

``parse_serving_mesh``'s errors are the reference's
(``tests/test_engine.py:416``), and a gang whose follower dies ends its
server with an error instead of a hang.
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
from kubeflow_tpu_torch.parallel.mesh import parse_serving_mesh
from kubeflow_tpu_torch.serving.engine import DecodeEngine
from kubeflow_tpu_torch.serving.model_store import transformer_export_config
from kubeflow_tpu_torch.testing import run_multiprocess
from torch_gang import (
    DECODE_NEW,
    DECODE_PROMPT,
    SERVE_KV,
    SERVE_MESHES,
    SERVE_REQS,
    LOCKSTEP_SLOTS,
    Gang,
    engine_kwargs,
    lockstep_workload,
    serve_lm,
)

ATOL = 1e-5
MODES = ("dense", "paged")
CASES = [(n, m, kv) for n, meshes in SERVE_MESHES.items() for m in meshes
         for kv in SERVE_KV]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    return {n: Gang("mesh_serving", n, tmp_path_factory.mktemp(f"serve{n}"))
            for n in SERVE_MESHES}


def _jax_lm(kv):
    cfg, params = serve_lm(kv)
    jc = JaxConfig(**{**transformer_export_config(cfg),
                      "dtype": jnp.float32})
    return jc, jax.tree_util.tree_map(jnp.asarray,
                                      convert.unflatten(params))


@pytest.fixture(scope="module")
def oracle():
    """JAX's answers by kv heads: the decode logits and streams (the
    served requests as one ragged batch), and its engine's streams on
    the reference test's two meshes (kv 2: tp 4 does not divide the kv
    heads, tp 2 does)."""
    out = {}
    prompt = jnp.asarray(DECODE_PROMPT[0], jnp.int32)
    lens = jnp.asarray(DECODE_PROMPT[1], jnp.int32)
    for kv in SERVE_KV:
        jc, params = _jax_lm(kv)
        first, cache = jdec.prefill(jc, params, prompt, lens)
        step, _ = jdec.decode_step(jc, params, cache,
                                   jnp.argmax(first, -1).astype(jnp.int32))
        gen = np.asarray(jdec.generate(
            jc, params, prompt, max_new_tokens=DECODE_NEW, true_len=lens))
        # greedy: a request's n tokens lead the batch row's longer stream
        out[kv] = {"prefill": np.asarray(first), "step": np.asarray(step),
                   "generate": gen,
                   "reqs": [gen[i, :n].tolist()
                            for i, (_, n) in enumerate(SERVE_REQS)],
                   "five": gen[:, :5].tolist()}
    jc, params = _jax_lm(2)
    for shape in (dict(dp=2, tp=4), dict(dp=4, tp=2)):
        mesh = create_mesh(MeshConfig(**shape))
        eng = JaxEngine(jc, shard_params(params, mesh), slots=2, mesh=mesh,
                        autostart=False)
        reqs = [eng.submit(p, max_new=n) for p, n in SERVE_REQS]
        for _ in range(12):
            eng.run_once(timeout=0.01)
        out[f"jax_engine/{shape['tp']}"] = [r.result() for r in reqs]
        eng.close()
    mesh = create_mesh(MeshConfig(dp=2, tp=4))
    out["jax_sharded_generate"] = np.asarray(jax.jit(
        lambda p, t, n: jdec.generate(jc, p, t, max_new_tokens=DECODE_NEW,
                                      true_len=n))(
        shard_params(params, mesh), prompt, lens))
    return out


def test_parse_serving_mesh_validation():
    assert parse_serving_mesh("") is None and parse_serving_mesh(None) is None
    with pytest.raises(ValueError, match="axis"):
        parse_serving_mesh("tpx=4")
    with pytest.raises(ValueError, match="integer size"):
        parse_serving_mesh("tp=")
    with pytest.raises(ValueError, match="integer size"):
        parse_serving_mesh("tp=abc")
    with pytest.raises(ValueError, match="repeats"):
        parse_serving_mesh("tp=2,tp=4")


@pytest.mark.parametrize("n,mesh,kv", CASES)
def test_decode_on_split_model_matches_jax(gangs, oracle, n, mesh, kv):
    want = oracle[kv]
    tp = SERVE_MESHES[n][mesh]["tp"]
    for rank, got in enumerate(gangs[n].case(f"decode/{mesh}/kv{kv}")):
        assert got["kv_heads"] == (kv // tp if kv % tp == 0 else kv)
        for mode in MODES:
            np.testing.assert_allclose(got[mode]["prefill"].numpy(),
                                       want["prefill"], atol=ATOL, rtol=0,
                                       err_msg=f"{mode} rank {rank}")
            np.testing.assert_allclose(got[mode]["step"].numpy(),
                                       want["step"], atol=ATOL, rtol=0,
                                       err_msg=f"{mode} rank {rank}")
            assert got[mode]["cache"][3] == got["kv_heads"]
        np.testing.assert_array_equal(got["generate"].numpy(),
                                      want["generate"])
        toks, stats = got["speculative"]
        np.testing.assert_array_equal(toks.numpy(), want["generate"])
        assert stats["rounds"] >= 1
    if kv == 2:
        np.testing.assert_array_equal(oracle["jax_sharded_generate"],
                                      want["generate"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,mesh,kv", CASES)
def test_engine_on_split_model_matches_jax_engine(gangs, oracle, n, mesh,
                                                  kv, mode):
    want = oracle[kv]["reqs"]
    if kv == 2:     # the JAX engine on its sharded meshes, as the oracle
        assert oracle["jax_engine/4"] == want == oracle["jax_engine/2"]
    cfg, _ = serve_lm(kv)
    tp = SERVE_MESHES[n][mesh]["tp"]
    heads = kv // tp if kv % tp == 0 else kv
    got = gangs[n].case(f"engine/{mesh}/kv{kv}/{mode}")
    whole = None
    for rank, g in enumerate(got):
        assert g["streams"] == want, f"rank {rank}"
        assert g["cache"][3] == heads
        whole = g["kv_bytes"] * kv // heads
        assert g["kv_bytes"] * (kv // heads) == whole
    slots_or_pages = 2 * cfg.max_seq_len if mode == "dense" else 2 * 64
    assert whole == 2 * cfg.n_layers * slots_or_pages * kv * cfg.head_dim * 4


@pytest.fixture(scope="module")
def unsplit_lockstep():
    """The unsplit port engine on the lockstep schedule, by mode."""
    cfg, params = serve_lm(2)
    model = convert.to_module(cfg, params, device="cpu")
    return {mode: lockstep_workload(DecodeEngine(
        cfg, model, slots=LOCKSTEP_SLOTS, autostart=False, device="cpu",
        **engine_kwargs(mode))) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", list(SERVE_MESHES))
def test_lockstep_engine_matches_unsplit(gangs, unsplit_lockstep, n, mode):
    got = gangs[n].case(f"lockstep/{mode}")
    want = unsplit_lockstep[mode]
    assert got[0]["streams"] == want["streams"]
    assert got[0]["counters"] == want["counters"]
    recoveries, bursts, hits, chunks = want["counters"]
    assert recoveries == 1 and hits >= 1
    assert (chunks > 0) if mode == "paged" else (bursts > 0)
    assert got[0]["plans"] > 0
    logs = [g["log"] for g in got]
    for rank, log in enumerate(logs[1:], 1):
        assert len(log) == len(logs[0]) > 0
        for (op0, t0), (op, t) in zip(logs[0], log):
            assert op == op0
            np.testing.assert_array_equal(t, t0, err_msg=f"rank {rank}")


@pytest.mark.parametrize("n", list(SERVE_MESHES))
def test_model_server_split_serving(gangs, oracle, n):
    want = oracle[2]["five"]
    tp = SERVE_MESHES[n][next(iter(SERVE_MESHES[n]))]["tp"]
    cfg, _ = serve_lm(2)
    for kind in ("engine", "unary"):
        got = gangs[n].case(f"serve/{kind}")
        lead = got[0]
        code, body = lead["generate"]
        assert code == 200
        assert body["tokens"] == want
        assert lead["sampled"][0] == 200
        assert lead["grpc"] == [want[0]]
        assert lead["grpc_stream"] == [[t] for t in want[0]]
        # each rank holds its block of every split leaf
        for rank, g in enumerate(got):
            shapes = g["shapes"]
            assert shapes["token_embed"] == (cfg.vocab_size // tp,
                                             cfg.d_model)
            assert shapes["blocks.0.attn.q_proj"] == (
                cfg.d_model, cfg.n_heads // tp, cfg.head_dim)
            assert shapes["blocks.0.mlp.down_proj"] == (cfg.d_ff // tp,
                                                        cfg.d_model)
        if kind == "engine":
            assert lead["engine_mesh"]
            for g in got[1:]:
                (log,) = g["logs"].values()
                assert len(log) == len(lead["log"]) > 0
                for (op0, t0), (op, t) in zip(lead["log"], log):
                    assert op == op0
                    np.testing.assert_array_equal(t, t0)
        else:
            code, body = lead["speculative"]
            assert code == 200 and body["tokens"] == want
            assert body["speculative"]["draft"] == "draft@1"
            code, body = lead["predict"]
            assert code == 200
            _, params = _jax_lm(2)
            jc, _ = _jax_lm(2)
            from kubeflow_tpu.models import Transformer as JaxTransformer

            logits = JaxTransformer(jc).apply(
                {"params": params},
                jnp.asarray([SERVE_REQS[0][0]], jnp.int32))
            np.testing.assert_allclose(np.asarray(body["predictions"]),
                                       np.asarray(logits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", list(SERVE_MESHES))
def test_moe_and_pipelined_decoding_refuse_by_name(gangs, n):
    for got in gangs[n].case("refused"):
        assert len(got) == 2
        for msg in got:
            assert "MoE or pipelined" in msg and "Queue A 2.8" in msg


_DIES = textwrap.dedent("""
    import os, sys, time
    import torch
    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.serving import server as srv
    from kubeflow_tpu_torch.serving.lockstep import Lockstep

    penv = dist.from_env()
    dist.initialize(penv, backend="gloo")
    mesh = srv.parse_serving_mesh("tp=2", device_type="cpu")
    if penv.process_id == 1:
        ls = Lockstep(device="cpu", timeout_s=20)
        ls.recv()                 # the first heartbeat, then gone
        os._exit(3)
    s = srv.ModelServer(sys.argv[1], port=0, decode_mesh=mesh,
                        device="cpu")
    ls = s.repo.lockstep
    deadline = time.monotonic() + 30
    while not ls.broken.is_set() and time.monotonic() < deadline:
        time.sleep(0.1)
    print("broken" if ls.broken.is_set() else "hung")
""")


def test_dead_follower_breaks_the_server_not_hangs(tmp_path):
    (tmp_path / "store").mkdir()
    lead, follower = run_multiprocess(
        ["-c", _DIES, str(tmp_path / "store")], 2, timeout_s=60)
    assert follower.returncode == 3, follower.stderr[-2000:]
    assert lead.returncode == 0, lead.stderr[-2000:]
    assert lead.stdout.strip() == "broken"


_MAIN = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, os.path.join(os.environ["KFTPU_REPO"], "tests"))
    from torch_gang import SERVE_REQS, _post
    from kubeflow_tpu_torch.serving import server as srv

    def probe(_):
        (server,) = made
        got = _post(server.port, "lm:generate", {
            "prompt_tokens": [p for p, _ in SERVE_REQS],
            "max_new_tokens": 5})
        print(json.dumps({"got": got,
                          "mesh": srv.tdist.get_world_size()}))
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


def test_main_serves_over_the_env_mesh(tmp_path, oracle):
    """``server.main`` on every rank of a gang with
    ``KFTPU_SERVING_MESH=tp=2``: rank 0 serves ``:generate`` with the
    oracle's tokens, rank 1 follows, and both end when rank 0 stops."""
    import json
    import os

    from kubeflow_tpu_torch.serving.model_store import export_model

    cfg, params = serve_lm(2)
    export_model(str(tmp_path / "lm"), "transformer", params,
                 config=transformer_export_config(cfg))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lead, follower = run_multiprocess(["-c", _MAIN], 2, timeout_s=90, env={
        "KFTPU_SERVING_MESH": "tp=2", "KFTPU_MODEL_BASE_PATH":
        str(tmp_path), "KFTPU_REST_PORT": "0", "KFTPU_GRPC_PORT": "0",
        "KFTPU_DECODE_SLOTS": "2", "KFTPU_REPO": repo})
    assert lead.returncode == 0, lead.stderr[-3000:]
    assert follower.returncode == 0, follower.stderr[-3000:]
    out = json.loads(lead.stdout.strip().splitlines()[-1])
    assert out["mesh"] == 2
    code, body = out["got"]
    assert code == 200 and body["tokens"] == oracle[2]["five"]


def test_kv_heads_helpers_on_one_rank():
    """A model built over a one-rank mesh decodes as the whole one."""
    cfg, params = serve_lm(2)
    mesh = parse_serving_mesh("tp=1", device_type="cpu")
    split = convert.to_module(cfg, params, device="cpu", mesh=mesh)
    whole = convert.to_module(cfg, params, device="cpu")
    assert split.cache_kv_heads == whole.cache_kv_heads == 2
    for kw in (engine_kwargs("dense"), engine_kwargs("paged")):
        outs = []
        for model, m in ((whole, None), (split, mesh)):
            eng = DecodeEngine(cfg, model, slots=2, autostart=False,
                               device="cpu", mesh=m, **kw)
            reqs = [eng.submit(p, max_new=n) for p, n in SERVE_REQS]
            for _ in range(12):
                eng.run_once(timeout=0.01)
            outs.append([r.result() for r in reqs])
        assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="mesh"):
        DecodeEngine(cfg, whole, slots=2, autostart=False, device="cpu",
                     mesh=mesh)


@pytest.mark.parametrize("H,KH,tp", [(4, 2, 4), (8, 2, 4), (12, 3, 2),
                                     (16, 8, 16), (24, 6, 4)])
def test_kv_window_holds_each_ranks_kv_heads(H, KH, tp):
    """Where the kv heads are replicated, each rank's q heads read the
    contiguous kv heads of their window: at its offset, q head i of the
    rank sits in the group of the kv head its global index maps to."""
    from kubeflow_tpu_torch.models.transformer import kv_window

    g, n = H // KH, H // tp
    for rank in range(tp):
        kv, off, width = kv_window(rank * n, n, g)
        kvs = list(range(KH))[kv]
        assert width == len(kvs) * g and 0 <= off and off + n <= width
        for h in range(n):
            assert kvs[(off + h) // g] == (rank * n + h) // g
        assert kvs[0] == rank * n // g and kvs[-1] == (rank * n + n - 1) // g
