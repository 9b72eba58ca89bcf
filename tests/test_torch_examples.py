"""The port's BERT entry point and launcher on the CPU: train, resume and
finish through ``examples.bert.main``, the restart after the last step,
the metrics lines, and the launcher's refusals."""

import json
import os

import pytest
import torch

from kubeflow_tpu_torch.examples import bert as bert_example
from kubeflow_tpu_torch.examples.common import launcher_init, log_metrics

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--vocab-size", "128", "--d-model", "32",
        "--n-layers", "2", "--n-heads", "4", "--d-ff", "64", "--seq-len",
        "16", "--per-device-batch", "2", "--log-every", "1"]


def _run(monkeypatch, tmp_path, name, steps, *extra, profile=None):
    monkeypatch.setenv("KFTPU_CHECKPOINT_DIR", str(tmp_path / name))
    monkeypatch.setenv("KFTPU_RESULTS_DIR", str(tmp_path / "results"))
    monkeypatch.setenv("KFTPU_JOB_NAME", name)
    if profile:
        monkeypatch.setenv("KFTPU_PROFILE_DIR", str(tmp_path / profile))
        monkeypatch.setenv("KFTPU_PROFILE_START", "1")
        monkeypatch.setenv("KFTPU_PROFILE_STEPS", "2")
    else:
        monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    return bert_example.main(TINY + ["--steps", str(steps), *extra])


def _records(tmp_path, name):
    with open(tmp_path / "results" / f"{name}.jsonl") as f:
        return [json.loads(line) for line in f]


def _saved(tmp_path, name, step):
    return torch.load(tmp_path / name / str(step) / "state.pt",
                      weights_only=True)


def test_resumed_run_matches_an_unbroken_one(monkeypatch, tmp_path):
    """4 steps with a checkpoint every 2, then a restart to 6: it
    resumes at step 4 and takes the unbroken 6-step run's steps exactly
    (per-step data seeds), with the profiler's window captured."""
    _run(monkeypatch, tmp_path, "job", 4, "--checkpoint-every", "2",
         profile="prof")
    assert sorted(os.listdir(tmp_path / "job")) == ["2", "4"]
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    last = _run(monkeypatch, tmp_path, "job", 6, "--checkpoint-every", "2")
    want = _run(monkeypatch, tmp_path, "unbroken", 6, "--checkpoint-every",
                "100")
    assert last == want and last == last          # not NaN
    got = {r["step"]: r["loss"] for r in _records(tmp_path, "job")
           if "done" not in r}
    ref = {r["step"]: r["loss"] for r in _records(tmp_path, "unbroken")
           if "done" not in r}
    assert sorted(got) == [1, 2, 3, 4, 5, 6] and got == ref
    a, b = _saved(tmp_path, "job", 6), _saved(tmp_path, "unbroken", 6)
    assert a["step"] == b["step"] == 6
    for key in a["module"]:
        assert torch.equal(a["module"][key], b["module"][key]), key
    for key in ("mu", "nu"):
        for x, y in zip(a["opt_state"][key], b["opt_state"][key]):
            assert torch.equal(x, y)


def test_restart_after_the_last_step_is_done(monkeypatch, tmp_path, capsys):
    _run(monkeypatch, tmp_path, "job", 2, "--checkpoint-every", "1")
    capsys.readouterr()
    assert _run(monkeypatch, tmp_path, "job", 2) == 0.0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == [{"step": 2, "ts": lines[0]["ts"], "done": True}]


def test_batches_depend_on_the_step_only():
    a = bert_example.batch_for_step(3, 2, 16, 128)
    b = bert_example.batch_for_step(3, 2, 16, 128)
    c = bert_example.batch_for_step(4, 2, 16, 128)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1])
    tokens, labels, weights = a
    assert tokens.dtype == labels.dtype == torch.int32
    assert bool((tokens[weights > 0] == 103).all())


def test_log_metrics_writes_results_dir(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("KFTPU_RESULTS_DIR", str(tmp_path / "r"))
    monkeypatch.setenv("KFTPU_JOB_NAME", "bert-job")
    log_metrics(3, loss=torch.tensor(1.5), note="x")
    log_metrics(4, done=True)
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    with open(tmp_path / "r" / "bert-job.jsonl") as f:
        saved = [json.loads(x) for x in f]
    assert saved == out
    assert out[0]["step"] == 3 and out[0]["loss"] == 1.5
    # a bool has __float__: done logs as 1.0, as in the reference
    assert out[0]["note"] == "x" and out[1]["done"] == 1.0


@pytest.mark.parametrize("env,kw,what", [
    ({"KFTPU_NUM_PROCESSES": "2"}, {}, "2 processes"),
    ({"MEGASCALE_NUM_SLICES": "2"}, {}, "2 slices"),
    ({}, {"tp": 2}, "tp=2"),
    ({}, {"pp": 2}, "pp=2"),
], ids=["processes", "slices", "tp", "pp"])
def test_launcher_refuses_what_needs_a_mesh(monkeypatch, env, kw, what):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    with pytest.raises(NotImplementedError, match="Queue A 7") as err:
        launcher_init(device="cpu", **kw)
    assert what in str(err.value)


def test_launcher_single_process(monkeypatch):
    monkeypatch.setenv("KFTPU_JOB_NAME", "j")
    monkeypatch.delenv("KFTPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("MEGASCALE_NUM_SLICES", raising=False)
    penv, dev = launcher_init(device="cpu", tp=1)
    assert dev == torch.device("cpu") and penv.job_name == "j"
    assert penv.num_processes == 1 and not penv.is_distributed


def test_entry_point_refuses_tp(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="tp=2"):
        _run(monkeypatch, tmp_path, "tp", 1, "--tp", "2")


# -- the LM entry point ------------------------------------------------------

LM_TINY = ["--device", "cpu", "--vocab-size", "128", "--d-model", "32",
           "--n-layers", "3", "--n-heads", "4", "--d-ff", "64", "--seq-len",
           "16", "--per-device-batch", "2", "--log-every", "1"]


def _lm(monkeypatch, tmp_path, name, steps, *extra):
    from kubeflow_tpu_torch.examples import lm as lm_example

    monkeypatch.setenv("KFTPU_CHECKPOINT_DIR", str(tmp_path / name))
    monkeypatch.setenv("KFTPU_RESULTS_DIR", str(tmp_path / "results"))
    monkeypatch.setenv("KFTPU_JOB_NAME", name)
    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    return lm_example.main(LM_TINY + ["--steps", str(steps), *extra])


def _by_key(tmp_path, name, key):
    return {r["step"]: r[key] for r in _records(tmp_path, name) if key in r}


def test_lm_resumed_run_matches_an_unbroken_one(monkeypatch, tmp_path):
    """3 steps, then a restart to 6: it resumes at step 3 and its steps,
    checkpoint and step telemetry match an unbroken 6-step run's bit for
    bit (step ``s`` draws its tokens from ``(1234, s)``)."""
    _lm(monkeypatch, tmp_path, "job", 3, "--checkpoint-every", "3")
    assert sorted(os.listdir(tmp_path / "job")) == ["3"]
    last = _lm(monkeypatch, tmp_path, "job", 6, "--checkpoint-every", "3")
    want = _lm(monkeypatch, tmp_path, "unbroken", 6, "--checkpoint-every",
               "100")
    assert last == want and last == last
    got = _by_key(tmp_path, "job", "loss")
    ref = _by_key(tmp_path, "unbroken", "loss")
    assert sorted(got) == [1, 2, 3, 4, 5, 6] and got == ref
    assert _by_key(tmp_path, "job", "grad_norm") == \
        _by_key(tmp_path, "unbroken", "grad_norm")
    recs = _records(tmp_path, "job")
    assert {"tokens_per_sec", "step_p50_step_s", "step_recompiles"} <= \
        set(recs[-1])
    assert recs[-1]["step_steps"] == 3          # the restarted run's own
    a, b = _saved(tmp_path, "job", 6), _saved(tmp_path, "unbroken", 6)
    for key in a["module"]:
        assert torch.equal(a["module"][key], b["module"][key]), key
    for key in ("mu", "nu"):
        for x, y in zip(a["opt_state"][key], b["opt_state"][key]):
            assert torch.equal(x, y)


def test_lm_restart_after_the_last_step_still_exports(monkeypatch,
                                                      tmp_path):
    """A job preempted between its last checkpoint and its exit trains
    nothing on restart but still samples and exports."""
    from kubeflow_tpu_torch.serving import model_store as store

    _lm(monkeypatch, tmp_path, "job", 2, "--checkpoint-every", "2")
    store_dir = tmp_path / "store" / "lm"
    assert _lm(monkeypatch, tmp_path, "job", 2, "--export",
               str(store_dir), "--generate", "3") == 0.0
    recs = _records(tmp_path, "job")
    assert recs[-3]["done"] == 1.0 and recs[-3]["step"] == 2
    assert len(recs[-2]["sample_tokens"]) == 3
    assert recs[-1]["exported"] == str(store_dir / "1")
    assert store.list_versions(str(store_dir)) == [1]


def test_lm_moe_trains_and_generates(monkeypatch, tmp_path):
    """``--n-experts 2``: MoE blocks train (finite losses, the router
    and the experts move) and the model samples in range."""
    loss = _lm(monkeypatch, tmp_path, "moe", 3, "--n-experts", "2",
               "--generate", "4", "--checkpoint-every", "3")
    assert loss == loss
    saved = _saved(tmp_path, "moe", 3)["module"]
    assert saved["blocks.0.moe.router"].shape == (32, 2)
    assert saved["blocks.2.moe.gate_proj"].shape == (2, 32, 64)
    sample = _by_key(tmp_path, "moe", "sample_tokens")[3]
    assert len(sample) == 4 and all(0 <= t < 128 for t in sample)


def test_lm_exports_a_paired_draft_that_serves(monkeypatch, tmp_path):
    """``--export DIR --draft-layers 1``: the target and ``DIR-draft``
    (``draft_of: lm@1``, one layer) land in the store, the server pairs
    them, and a speculative request returns the plain greedy tokens."""
    import yaml

    from kubeflow_tpu_torch.serving.server import ModelServer

    base = tmp_path / "store"
    _lm(monkeypatch, tmp_path, "job", 2, "--export", str(base / "lm"),
        "--draft-layers", "1", "--draft-distill-steps", "3")
    recs = _records(tmp_path, "job")
    assert recs[-1]["draft_exported"] == str(base / "lm-draft" / "1")
    assert recs[-1]["draft_distill_loss"] >= 0
    with open(base / "lm-draft" / "1" / "model.yaml") as f:
        meta = yaml.safe_load(f)
    assert meta["draft_of"] == "lm@1" and meta["config"]["n_layers"] == 1
    server = ModelServer(str(base), device="cpu")
    try:
        model = server.repo.get("lm")
        assert model.draft.ref == "lm-draft@1"
        body = {"prompt_tokens": [[3, 1, 4, 1, 5]], "max_new_tokens": 4}
        code, plain = server.handle_generate("lm", None, body)
        code2, spec = server.handle_generate(
            "lm", None, dict(body, speculative=True, draft_len=2))
        assert code == code2 == 200
        assert len(spec["tokens"][0]) == 4
        assert spec["speculative"]["draft"] == "lm-draft@1"
        # bf16 weights: a k-token verify may resolve an argmax near-tie
        # unlike a 1-token step (exact only at f32); the prefill's
        # token is the plain stream's
        assert spec["tokens"][0][0] == plain["tokens"][0][0]
    finally:
        server.stop()


def test_lm_batches_depend_on_the_step_only():
    from kubeflow_tpu_torch.examples import lm as lm_example

    a = lm_example.batch_for_step(3, 2, 16, 128)
    assert torch.equal(a, lm_example.batch_for_step(3, 2, 16, 128))
    assert not torch.equal(a, lm_example.batch_for_step(4, 2, 16, 128))
    assert a.dtype == torch.int32 and a.shape == (2, 16)
    assert int(a.min()) >= 0 and int(a.max()) < 128


def test_lm_entry_point_refuses_tp(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="tp=2"):
        _lm(monkeypatch, tmp_path, "tp", 1, "--tp", "2")
