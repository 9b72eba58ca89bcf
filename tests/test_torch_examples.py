"""The port's entry points and launcher on the CPU: train, resume and
finish through ``examples.bert.main`` and ``examples.lm.main``, the
restart after the last step, the metrics lines, the launcher's mesh and
refusals, and the image entry points. A 2-rank gloo gang
(``tests/torch_gang.py``, suite ``examples``) runs what needs two
processes: ``launcher_init``'s mesh (with a ``pp`` axis too),
``examples.lm`` at dp = 2 and at tp = 2 (its results, checkpoints and
export written by rank 0 alone) and with MoE at dp = 2, and the image
entry points at dp = 2, each against one rank on the same global batch
(and ViT's and BERT's ``--tp 2``)."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.examples import bert as bert_example
from kubeflow_tpu_torch.examples.common import launcher_init, log_metrics
from torch_gang import Gang

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


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return Gang("examples", 2, tmp_path_factory.mktemp("examples-gang"))


@pytest.mark.parametrize("case,sizes", [
    ("launcher/pp2", [1, 1, 2, 1]),
], ids=["pp"])
def test_launcher_refuses_what_needs_a_mesh(gang, case, sizes):
    """``launcher_init(pp=2)`` on two processes builds the pipeline axis
    (it refused before the pipeline was ported); on one process
    ``auto_mesh_config`` refuses it, as the reference's does."""
    for got in gang.case(case):
        assert got == {"sizes": sizes, "device": "cpu"}
    with pytest.raises(ValueError, match="pp=2 does not divide"):
        launcher_init(device="cpu", pp=2)


@pytest.mark.parametrize("case,sizes", [
    ("processes", [1, 1, 1, 2]), ("slices", [2, 1, 1, 1]),
    ("tp", [1, 2, 1, 1]),
])
def test_launcher_init_builds_the_mesh(gang, case, sizes):
    """Two processes: ``auto_mesh_config``'s tp = 2 by default; two
    slices give ``dcn`` = 2, as ``tests/test_distributed.py:58`` holds
    the reference's; ``tp=1`` gives dp = 2. Mesh dims ``(dcn, dp, pp,
    tp)``, each rank on the CPU."""
    for got in gang.case(f"launcher/{case}"):
        assert got == {"sizes": sizes, "device": "cpu"}


def test_launcher_single_process(monkeypatch):
    monkeypatch.setenv("KFTPU_JOB_NAME", "j")
    monkeypatch.delenv("KFTPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("MEGASCALE_NUM_SLICES", raising=False)
    penv, mesh, dev = launcher_init(device="cpu", tp=1)
    assert dev == torch.device("cpu") and penv.job_name == "j"
    assert penv.num_processes == 1 and not penv.is_distributed
    assert mesh.mesh_dim_names == ("dcn", "dp", "pp", "tp")
    assert tuple(mesh.mesh.shape) == (1, 1, 1, 1)


def test_entry_point_refuses_tp(monkeypatch, tmp_path):
    """``--tp 2`` on one process: the reference's answer, from
    ``auto_mesh_config``."""
    with pytest.raises(ValueError, match="tp=2 does not divide 1"):
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
    with pytest.raises(ValueError, match="tp=2 does not divide 1"):
        _lm(monkeypatch, tmp_path, "tp", 1, "--tp", "2")


def test_lm_at_dp2_equals_one_rank(gang, monkeypatch, tmp_path):
    """Two ranks at dp = 2 (two rows each) take the losses of one rank
    at the same global batch of four, within 1e-5."""
    _lm(monkeypatch, tmp_path, "one", 3, "--per-device-batch", "4")
    want = _by_key(tmp_path, "one", "loss")
    gang.case("lm/dp2")
    got = _by_key(Path(gang.out), "dp2", "loss")
    assert sorted(got) == [1, 2, 3]
    for step in got:
        np.testing.assert_allclose(got[step], want[step], atol=1e-5, rtol=0)


def test_lm_rank0_alone_writes(gang):
    """Rank 0 alone logs, writes the checkpoints and exports; rank 1
    gathers with it and writes nothing."""
    from kubeflow_tpu_torch.serving import model_store as store

    r0, r1 = gang.case("lm/dp2")
    assert (r0["writes"], r0["exports"]) == (2, 1)
    assert (r1["writes"], r1["exports"]) == (0, 0)
    assert sorted(os.listdir(Path(gang.out) / "ckpt-dp2")) == ["2", "3"]
    assert store.list_versions(str(Path(gang.out) / "export-dp2" /
                                    "lm")) == [1]
    recs = _records(Path(gang.out), "dp2")
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert len(recs[-2]["sample_tokens"]) == 3
    assert not any(line.startswith("{") for line in
                   gang.stdout[1].splitlines())


def test_lm_at_tp2_resumes_at_tp1(gang, monkeypatch, tmp_path):
    """``--tp 2`` trains (two ranks, the vocabulary, heads and MLP split)
    with the losses of one rank, and its step-2 checkpoint (the gathered
    state) resumes a one-rank job whose step 3 takes an unbroken run's
    loss, within 1e-5. At f32 compute: in bf16 a tp-split sum rounds
    otherwise than a whole one (~2e-3 in the first loss)."""
    import shutil

    from kubeflow_tpu_torch.examples import lm as lm_example
    from torch_gang import f32_config

    monkeypatch.setattr(lm_example, "TransformerConfig", f32_config)
    gang.case("lm/tp2")
    shutil.copytree(Path(gang.out) / "ckpt-tp2", tmp_path / "resumed")
    _lm(monkeypatch, tmp_path, "resumed", 3)
    _lm(monkeypatch, tmp_path, "unbroken", 3)
    want = _by_key(tmp_path, "unbroken", "loss")
    got = _by_key(Path(gang.out), "tp2", "loss")
    got.update(_by_key(tmp_path, "resumed", "loss"))
    assert sorted(got) == [1, 2, 3]
    for step in got:
        np.testing.assert_allclose(got[step], want[step], atol=1e-5, rtol=0)


def test_lm_moe_refused_at_dp2(gang, monkeypatch, tmp_path):
    """``--n-experts 4`` at dp = 2 runs (the layout was refused before
    expert parallelism; the name is kept): the experts split over dp,
    and rank 0 logs the losses of one rank at the same global batch of
    four, within 1e-5 (f32 compute)."""
    from kubeflow_tpu_torch.examples import lm as lm_example
    from torch_gang import f32_config

    monkeypatch.setattr(lm_example, "TransformerConfig", f32_config)
    _lm(monkeypatch, tmp_path, "one", 2, "--n-experts", "4",
        "--per-device-batch", "4")
    want = _by_key(tmp_path, "one", "loss")
    gang.case("lm/moe_dp2")
    got = _by_key(Path(gang.out), "moe-dp2", "loss")
    assert sorted(got) == [1, 2]
    for step in got:
        np.testing.assert_allclose(got[step], want[step], atol=1e-5, rtol=0)


@pytest.mark.parametrize("entry", ["resnet", "vit", "mnist"])
def test_image_entry_points_refuse_two_processes(gang, entry, monkeypatch,
                                                 tmp_path):
    """Two processes at dp = 2 run (the layout was refused before the
    image step split the batch; the name is kept): rank 0 logs the
    losses one rank logs on the same global batch, within 1e-5 (f32;
    ResNet's BatchNorm over the global batch)."""
    import importlib

    from torch_gang import f32_image_entry, image_entry_argv

    module = importlib.import_module(f"kubeflow_tpu_torch.examples.{entry}")
    monkeypatch.setenv("KFTPU_RESULTS_DIR", str(tmp_path / "results"))
    monkeypatch.setenv("KFTPU_JOB_NAME", "one")
    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    with f32_image_entry(entry):
        module.main(image_entry_argv(entry, 1))
    want = _by_key(tmp_path, "one", "loss")
    assert gang.case(f"image/{entry}") == ["ran", "ran"]
    got = _by_key(Path(gang.out), f"image-{entry}", "loss")
    assert sorted(got) == sorted(want) and len(got) >= 2
    for step in got:
        np.testing.assert_allclose(got[step], want[step], atol=1e-5, rtol=0)


# -- the image-classification entry points ------------------------------------


def _image_records(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


@pytest.fixture
def thin_resnet(monkeypatch):
    """``resnet18_thin`` in place of ResNet-50, as the reference's
    ``tests/test_data.py`` runs its entry point on the CPU."""
    from kubeflow_tpu_torch.examples import resnet as resnet_example
    from kubeflow_tpu_torch.models.resnet import resnet18_thin

    monkeypatch.setattr(resnet_example, "resnet50",
                        lambda num_classes=1000: resnet18_thin(num_classes))
    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    return resnet_example


RESNET_TINY = ["--device", "cpu", "--image-size", "32", "--num-classes",
               "10", "--per-device-batch", "4", "--log-every", "1"]


def test_resnet_entry_point_trains_on_the_cpu(thin_resnet, capsys):
    """Synthetic tensors: after the warm-up, a metrics line a step with
    a finite loss that falls on the fixed batch, and a final line whose
    images/s ``main`` returns."""
    ips = thin_resnet.main(RESNET_TINY + ["--steps", "3"])
    recs = _image_records(capsys)
    losses = [r["loss"] for r in recs if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2, 3, 3]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert recs[-1]["final"] == 1.0 and recs[-1]["images_per_sec"] == ips
    assert ips > 0 and recs[-1]["images_per_sec_per_chip"] == ips


def test_resnet_entry_point_trains_from_shards(thin_resnet, monkeypatch,
                                               tmp_path, capsys):
    """``--data-dir``: shards → the native loader → the device feed, the
    pixels cast to bf16 on the host and the labels split out; warm-up
    and timed steps take ``warmup + steps`` batches."""
    from kubeflow_tpu_torch import data

    size, n = 32, 32
    rng = np.random.default_rng(1)
    recs = np.concatenate([
        rng.integers(0, 10, (n, 1)).astype(np.float32),
        rng.normal(size=(n, size * size * 3)).astype(np.float32)], axis=1)
    data.write_shards(str(tmp_path), recs, shards=2)
    loaders, batches = [], []
    real_loader, real_feed = thin_resnet.DataLoader, thin_resnet.device_feed

    def loader(*a, **kw):
        made = real_loader(*a, **kw)
        loaders.append((made, made.native))
        return made

    def feed(*a, **kw):
        for batch in real_feed(*a, **kw):
            batches.append(batch)
            yield batch

    monkeypatch.setattr(thin_resnet, "DataLoader", loader)
    monkeypatch.setattr(thin_resnet, "device_feed", feed)
    ips = thin_resnet.main(RESNET_TINY + ["--steps", "2", "--warmup-steps",
                                          "1", "--data-dir", str(tmp_path)])
    (made, native), = loaders
    # native while it ran; closed (its threads joined) when main returns
    assert ips > 0 and native and not made.native
    assert len(batches) == 3
    for batch in batches:
        # over the mesh each leaf is wrapped as this rank's rows
        pixels, labels = (leaf.rows for leaf in batch)
        assert pixels.dtype == torch.bfloat16
        assert pixels.shape == (4, size, size, 3)
        assert labels.dtype == torch.int32 and labels.shape == (4,)
        assert set(labels.tolist()) <= set(range(10))
    losses = [r["loss"] for r in _image_records(capsys) if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))


VIT_TINY = ["--device", "cpu", "--image-size", "32", "--patch-size", "8",
            "--num-classes", "10", "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--d-ff", "128", "--per-device-batch", "4",
            "--log-every", "1"]


def test_vit_entry_point_trains_on_the_cpu(monkeypatch, capsys):
    from kubeflow_tpu_torch.examples import vit as vit_example

    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    ips = vit_example.main(VIT_TINY + ["--steps", "4"])
    recs = _image_records(capsys)
    losses = [r["loss"] for r in recs if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 4]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert ips > 0 and recs[-1]["images_per_sec"] == ips


def test_vit_entry_point_refuses_tp(gang):
    """``--tp 2`` on one process: ``auto_mesh_config`` refuses it; on
    two it trains, the ViT built over the tp = 2 mesh (it refused before
    tensor parallelism for the encoders was ported). BERT's entry point
    at tp = 2 trains too, and its checkpoint is saved whole."""
    from kubeflow_tpu_torch.examples import vit as vit_example

    with pytest.raises(ValueError, match="tp=2 does not divide 1"):
        vit_example.main(VIT_TINY + ["--steps", "1", "--tp", "2"])
    for got in gang.case("vit/tp2"):
        assert np.isfinite(got) and got > 0
    (l0, shape0), (l1, shape1) = gang.case("bert/tp2")
    assert np.isfinite(l0) and l0 == l1
    assert shape0 == shape1 == (128, 32)


def test_mnist_data_is_the_reference(tmp_path):
    """``synthetic_mnist`` gives the reference's arrays, and
    ``load_mnist`` reads idx files as the reference does."""
    import gzip
    import struct

    from kubeflow_tpu.examples import mnist as ref_mnist
    from kubeflow_tpu_torch.examples import mnist as mnist_example

    for n, seed in ((4096, 0), (64, 3)):
        for a, b in zip(mnist_example.synthetic_mnist(n, seed),
                        ref_mnist.synthetic_mnist(n, seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    for name, arr in (("train-images-idx3-ubyte.gz", pixels),
                      ("train-labels-idx1-ubyte.gz", labels)):
        with gzip.open(tmp_path / name, "wb") as f:
            f.write(struct.pack(">I", 0x800 | arr.ndim))
            f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
            f.write(arr.tobytes())
    for a, b in zip(mnist_example.load_mnist(str(tmp_path)),
                    ref_mnist.load_mnist(str(tmp_path))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mnist_entry_point_draws_the_reference_batches(monkeypatch):
    """Both entry points' step functions see the same batches:
    ``RandomState(process_id)`` indices into the same synthetic set."""
    from kubeflow_tpu.examples import mnist as ref_mnist
    from kubeflow_tpu_torch.examples import mnist as mnist_example

    seen = {"ref": [], "port": []}

    def recorder(key):
        def make(*_):
            def step(state, images, labels):
                seen[key].append((np.asarray(images), np.asarray(labels)))
                return state, {"loss": 0.0, "accuracy": 0.5}
            return step
        return make

    monkeypatch.setattr(ref_mnist, "make_image_train_step", recorder("ref"))
    monkeypatch.setattr(mnist_example, "make_image_train_step",
                        recorder("port"))
    flags = ["--steps", "3", "--batch-size", "16", "--log-every", "3"]
    assert ref_mnist.main(flags) == mnist_example.main(
        flags + ["--device", "cpu"]) == 0.5
    assert len(seen["port"]) == len(seen["ref"]) == 3
    for (a, la), (b, lb) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_mnist_entry_point_learns_on_the_cpu(capsys):
    from kubeflow_tpu_torch.examples import mnist as mnist_example

    acc = mnist_example.main(["--device", "cpu", "--steps", "20",
                              "--batch-size", "32", "--log-every", "10"])
    recs = _image_records(capsys)
    assert [r["step"] for r in recs] == [10, 20]
    assert recs[-1]["accuracy"] == acc and acc >= 0.8
    assert recs[-1]["loss"] < recs[0]["loss"]
