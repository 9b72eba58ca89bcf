"""The port stands alone: no JAX, no flax, nothing of ``kubeflow_tpu``.

- importing ``kubeflow_tpu_torch`` and every submodule, in a fresh
  interpreter, loads no ``jax*``/``flax*``/``kubeflow_tpu.*`` module;
- an AST scan of the package and ``chip_smoke.py`` finds no such import;
- the entry points (serving, the train states, the BERT entry point and
  its launcher) refuse to run without CUDA unless ``device="cpu"`` is
  passed explicitly.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "kubeflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_submodule_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kubeflow_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('kubeflow_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_loaded = int(out.stdout.split()[0])
    assert n_loaded >= 15, out.stdout


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_need_cuda_unless_cpu_is_explicit(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import tiny_config
    from kubeflow_tpu_torch.serving import model_store as store
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.train import (
        create_image_train_state,
        create_train_state,
        make_optimizer,
        make_sgd,
    )

    cfg = tiny_config()
    params = convert.random_params(cfg, seed=0)
    rcfg = ResNetConfig(stage_sizes=(1,), num_classes=4, width=8,
                        fused_bn_conv=True)
    variables = convert.random_resnet_params(rcfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.resnet_to_trainable(rcfg, variables)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.resnet_to_module(rcfg, variables, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_image_train_state(rcfg, variables, make_sgd(0.1))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.to_trainable(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, params, make_optimizer())
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(cfg, params, autostart=False)
    store.export_model(str(tmp_path / "lm"), "transformer", params,
                       config=store.transformer_export_config(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        store.load_version(str(tmp_path / "lm"), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(str(tmp_path))
    # the explicit CPU opt-in works
    eng = DecodeEngine(cfg, params, autostart=False, device="cpu")
    eng.close()
    state = create_train_state(cfg, params, make_optimizer(), device="cpu")
    assert state.device.type == "cpu"
    state = create_image_train_state(rcfg, variables, make_sgd(0.1),
                                     device="cpu")
    assert state.device.type == "cpu" and state.batch_stats


def test_bert_entry_points_need_cuda_unless_cpu_is_explicit(
        tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from kubeflow_tpu_torch.examples import bert as bert_example
    from kubeflow_tpu_torch.examples.common import launcher_init
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import bert_tiny
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        make_optimizer,
    )

    cfg = bert_tiny()
    params = convert.random_bert_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.bert_to_trainable(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.bert_to_module(cfg, params, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_bert_train_state(cfg, params, make_optimizer())
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher_init()
    monkeypatch.setenv("KFTPU_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    tiny = ["--steps", "1", "--vocab-size", "64", "--d-model", "32",
            "--n-layers", "1", "--n-heads", "2", "--d-ff", "32",
            "--seq-len", "8", "--per-device-batch", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_example.main(tiny)
    assert not (tmp_path / "ckpt").exists()
    # the explicit CPU opt-in works
    assert launcher_init(device="cpu")[2].type == "cpu"
    state = create_bert_train_state(cfg, params, make_optimizer(),
                                    device="cpu")
    assert state.device.type == "cpu"
    loss = bert_example.main(tiny + ["--device", "cpu"])
    assert loss == loss and (tmp_path / "ckpt" / "1").is_dir()


def test_last_modules_are_scanned_and_load_onto_cuda(tmp_path):
    """The modules of the last bring-up slice are in the scan above, and
    the multiplexer's default loader refuses without CUDA unless the CPU
    is asked for."""
    scanned = {str(p.relative_to(PKG)) for p in _sources()
               if PKG in p.parents}
    assert {"ops/autotune.py", "ops/act_compress.py", "obs/xprof.py",
            "obs/export.py", "serving/multiplex.py", "k8s/client.py",
            "tuning/study.py", "examples/common.py"} <= scanned
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.serving import model_store as store
    from kubeflow_tpu_torch.serving.multiplex import ModelMultiplexer

    store.export_model(str(tmp_path / "mnist"), "mnist",
                       convert.random_mnist_params(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelMultiplexer(str(tmp_path), max_resident=1).get("mnist")
    mux = ModelMultiplexer(str(tmp_path), max_resident=1, device="cpu")
    assert mux.get("mnist").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CPU fallback: without a card the smoke exits non-zero and
    prints no result line; alone in a directory it cannot run at all."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_the_lm_slice_is_scanned_and_needs_cuda(tmp_path, monkeypatch):
    """The slice's new modules are among the sources scanned above, and
    the LM entry point, like BERT's, refuses to run without CUDA unless
    ``--device cpu`` is passed."""
    scanned = {str(p.relative_to(PKG)) for p in _sources()
               if PKG in p.parents}
    for mod in ("obs/steps.py", "obs/trace.py", "obs/export.py",
                "obs/xprof.py", "ops/moe.py", "train/distill.py",
                "examples/lm.py"):
        assert mod in scanned, mod
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from kubeflow_tpu_torch.examples import lm as lm_example

    monkeypatch.setenv("KFTPU_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    tiny = ["--steps", "1", "--vocab-size", "64", "--d-model", "32",
            "--n-layers", "1", "--n-heads", "2", "--d-ff", "32",
            "--seq-len", "8", "--per-device-batch", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_example.main(tiny)
    assert not (tmp_path / "ckpt").exists()
    loss = lm_example.main(tiny + ["--device", "cpu"])
    assert loss == loss and (tmp_path / "ckpt" / "1").is_dir()


def test_the_predict_slice_is_scanned(tmp_path):
    """The modules of the ``:predict`` and request-ledger slice are among
    the sources scanned above, and the store loads every kind onto the
    card unless ``device="cpu"`` is passed."""
    scanned = {str(p.relative_to(PKG)) for p in _sources()
               if PKG in p.parents}
    for mod in ("obs/requests.py", "models/mnist.py", "models/convert.py",
                "serving/model_store.py", "serving/server.py",
                "serving/engine.py", "utils/metrics.py"):
        assert mod in scanned, mod
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.serving import model_store as store

    store.export_model(str(tmp_path / "mnist"), "mnist",
                       convert.random_mnist_params(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        store.load_version(str(tmp_path / "mnist"), 1)
    assert store.load_version(str(tmp_path / "mnist"), 1,
                              device="cpu").input_shape == (28, 28, 1)


IMAGE_SLICE = ("serving/grpc_server.py", "serving/predict_pb2.py",
               "models/vit.py", "data/loader.py", "data/__init__.py",
               "examples/resnet.py", "examples/vit.py", "examples/mnist.py")


def test_the_grpc_and_image_slice_is_scanned():
    scanned = {str(p.relative_to(PKG)) for p in _sources()
               if PKG in p.parents}
    for mod in IMAGE_SLICE:
        assert mod in scanned, mod


def test_everything_but_the_generated_messages_imports_without_grpc():
    """The machine with the card has no ``grpc`` or ``protobuf``: with
    both blocked by a meta-path finder, the ``serving``, ``models``,
    ``data`` and ``examples`` packages and every submodule of the port
    but ``serving/predict_pb2.py`` (protoc's output) import, and
    importing ``grpc_server`` loads neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'grpc' or name == 'google.protobuf'"
        " or name.startswith('google.protobuf.'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "for pkg in ('serving', 'models', 'data', 'examples'):\n"
        "    importlib.import_module('kubeflow_tpu_torch.' + pkg)\n"
        "import kubeflow_tpu_torch as pkg\n"
        "n = 0\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if m.name.endswith('.predict_pb2'):\n"
        "        continue\n"
        "    importlib.import_module(m.name)\n"
        "    n += 1\n"
        "from kubeflow_tpu_torch.serving import grpc_server\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] == 'grpc'"
        " or k.startswith('google.protobuf'))\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 40, out.stdout


@pytest.mark.parametrize("entry,tiny", [
    ("resnet", ["--steps", "1", "--warmup-steps", "0", "--image-size", "32",
                "--num-classes", "4", "--per-device-batch", "2"]),
    ("vit", ["--steps", "1", "--image-size", "16", "--patch-size", "8",
             "--num-classes", "4", "--d-model", "16", "--n-layers", "1",
             "--n-heads", "2", "--d-ff", "16", "--per-device-batch", "2"]),
    ("mnist", ["--steps", "1", "--batch-size", "2", "--log-every", "1"]),
])
def test_image_entry_points_need_cuda_unless_cpu_is_explicit(
        monkeypatch, entry, tiny):
    import importlib

    from kubeflow_tpu_torch.models.resnet import resnet18_thin

    mod = importlib.import_module(f"kubeflow_tpu_torch.examples.{entry}")
    if entry == "resnet":
        monkeypatch.setattr(mod, "resnet50",
                            lambda num_classes=1000: resnet18_thin(
                                num_classes))
    monkeypatch.delenv("KFTPU_PROFILE_DIR", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(tiny)
    # images/s, or MNIST's accuracy
    out = mod.main(tiny + ["--device", "cpu"])
    assert (out > 0) if entry != "mnist" else (0.0 <= out <= 1.0)
