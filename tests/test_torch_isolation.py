"""The port stands alone: no JAX, no flax, nothing of ``kubeflow_tpu``.

- importing ``kubeflow_tpu_torch`` and every submodule, in a fresh
  interpreter, loads no ``jax*``/``flax*``/``kubeflow_tpu.*`` module;
- an AST scan of the package and ``chip_smoke.py`` finds no such import;
- the entry points refuse to run without CUDA unless ``device="cpu"``
  is passed explicitly.
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

    cfg = tiny_config()
    params = convert.random_params(cfg, seed=0)
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
