"""The port's batch prediction job against ``kubeflow_tpu/serving/
batch_predict.py``.

One MNIST export written by the reference's ``export_model``; the same
7-line JSONL (not a multiple of the batch) through both packages'
``run_batch_predict`` at batch 4: the same summary keys and instance
count, predictions within 1e-5. Also the missing model, an explicit and
the latest version (``model_store.load_latest``), a token model's f32
chunk refused before any launch, the CLI's summary line, and the Job
manifest: the reference's apart from the module and the resource key.
"""

import json

import jax
import numpy as np
import pytest

from kubeflow_tpu.models import MnistCnn
from kubeflow_tpu.serving.batch_predict import (
    batch_predict_job as ref_job,
)
from kubeflow_tpu.serving.batch_predict import (
    run_batch_predict as ref_run,
)
from kubeflow_tpu.serving.model_store import export_model
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.transformer import tiny_config
from kubeflow_tpu_torch.serving import batch_predict
from kubeflow_tpu_torch.serving import model_store as store

SUMMARY_KEYS = {"model_version", "instances", "wall_time_s",
                "instances_per_sec", "output"}


@pytest.fixture(scope="module")
def mnist_repo(tmp_path_factory):
    repo = tmp_path_factory.mktemp("models")
    model = MnistCnn()
    x = np.zeros((1, 28, 28, 1), np.float32)
    params = jax.jit(model.init)(jax.random.key(0), x)["params"]
    export_model(str(repo / "mnist"), "mnist", params, version=1)
    params2 = jax.jit(model.init)(jax.random.key(1), x)["params"]
    export_model(str(repo / "mnist"), "mnist", params2, version=2)
    return repo


def write_instances(path, n=7, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps(rng.random((28, 28, 1)).tolist()) + "\n")


def read_preds(path):
    return np.asarray([json.loads(line)["prediction"] for line in open(path)])


@pytest.mark.parametrize("version", [None, 1])
def test_batch_predict_matches_the_reference(mnist_repo, tmp_path, version):
    inp = tmp_path / "in.jsonl"
    write_instances(inp)
    base = str(mnist_repo / "mnist")
    want = ref_run(base, str(inp), str(tmp_path / "ref.jsonl"),
                   version=version, batch_size=4)
    got = batch_predict.run_batch_predict(
        base, str(inp), str(tmp_path / "port.jsonl"), version=version,
        batch_size=4, device="cpu")
    assert set(got) == set(want) == SUMMARY_KEYS
    assert got["instances"] == want["instances"] == 7
    assert got["model_version"] == want["model_version"] == (version or 2)
    assert got["output"] == str(tmp_path / "port.jsonl")
    preds, ref = read_preds(tmp_path / "port.jsonl"), read_preds(
        tmp_path / "ref.jsonl")
    assert preds.shape == ref.shape == (7, 10)
    np.testing.assert_allclose(preds, ref, atol=1e-5, rtol=0)


def test_padded_chunk_predicts_its_rows_alone(mnist_repo, tmp_path):
    """The padding rows never reach the output, and a row's prediction
    does not depend on the chunk it fell in."""
    inp = tmp_path / "in.jsonl"
    write_instances(inp, n=5, seed=3)
    base = str(mnist_repo / "mnist")
    outs = []
    for bs in (4, 8):
        out = tmp_path / f"b{bs}.jsonl"
        batch_predict.run_batch_predict(base, str(inp), str(out),
                                        batch_size=bs, device="cpu")
        outs.append(read_preds(out))
    assert outs[0].shape == (5, 10)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=0)


def test_batch_predict_missing_model(tmp_path):
    for run in (ref_run, batch_predict.run_batch_predict):
        with pytest.raises(FileNotFoundError, match="no model versions"):
            run(str(tmp_path / "nope"), "in", "out")


def test_load_latest(mnist_repo, tmp_path):
    assert store.load_latest(str(tmp_path / "nope"), device="cpu") is None
    latest = store.load_latest(str(mnist_repo / "mnist"), device="cpu")
    assert latest.version == 2 and latest.kind == "mnist"


def test_token_model_chunk_is_refused_before_the_launch(tmp_path):
    """The reference casts every chunk to f32; a token model refuses it
    as ``:predict`` refuses a float token batch."""
    cfg = tiny_config()
    base = str(tmp_path / "lm")
    store.export_model(base, "transformer", convert.unflatten(
        convert.random_params(cfg, 0)),
        config=store.transformer_export_config(cfg))
    inp = tmp_path / "in.jsonl"
    inp.write_text(json.dumps([1, 2, 3, 4]) + "\n")
    with pytest.raises(ValueError, match="token ids must be integers"):
        batch_predict.run_batch_predict(base, str(inp),
                                        str(tmp_path / "out.jsonl"),
                                        batch_size=2, device="cpu")


def test_main_prints_the_summary(mnist_repo, tmp_path, capsys):
    inp = tmp_path / "in.jsonl"
    write_instances(inp, n=3)
    assert batch_predict.main([
        "--model-base-path", str(mnist_repo / "mnist"), "--input",
        str(inp), "--output", str(tmp_path / "out.jsonl"), "--version",
        "1", "--batch-size", "2", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == SUMMARY_KEYS and summary["instances"] == 3
    assert summary["model_version"] == 1


@pytest.mark.parametrize("version", [None, 3])
def test_batch_predict_job_manifest_is_the_references(version):
    kw = dict(model_base_path="/models/m", input_path="/data/in.jsonl",
              output_path="/data/out.jsonl", version=version, batch_size=16)
    want = ref_job("bp", "kubeflow", tpu_chips=4, **kw)
    got = batch_predict.batch_predict_job("bp", "kubeflow", gpus=4, **kw)
    ctr = got["spec"]["template"]["spec"]["containers"][0]
    assert ctr["command"] == ["python", "-m",
                              "kubeflow_tpu_torch.serving.batch_predict"]
    assert ctr["resources"] == {"limits": {"nvidia.com/gpu": 4}}
    ref_ctr = want["spec"]["template"]["spec"]["containers"][0]
    assert ref_ctr["command"][-1] == "kubeflow_tpu.serving.batch_predict"
    assert ref_ctr["resources"] == {"limits": {"google.com/tpu": 4}}
    ctr["command"], ctr["resources"] = ref_ctr["command"], ref_ctr[
        "resources"]
    assert got == want
    assert "resources" not in batch_predict.batch_predict_job(
        "bp", "kubeflow", **kw)["spec"]["template"]["spec"][
        "containers"][0]
