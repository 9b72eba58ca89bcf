"""Checkpoint and resume of a train state.

PyTorch port of ``kubeflow_tpu/train/checkpoint.py``, whose policy it
keeps: step-numbered directories ``<dir>/<step>/``, keep-N retention,
resume from the latest step, an asynchronous save, and a missing
explicit step that raises instead of restoring another.

A state is a :class:`~kubeflow_tpu_torch.train.trainer.TrainState` (the
module's parameters and buffers, the optimizer state — AdamW's ``mu``,
``nu`` and ``count``, or SGD's ``trace`` — and the step) or a nested
dict/list of tensors and numbers. ``save`` copies every tensor to the
host before it returns, so the training loop may update the state in
place at once; a thread then writes the copy with ``torch.save`` into
``<dir>/.tmp-<step>-<pid>/`` and renames it to ``<dir>/<step>/`` when
the file is complete (orbax finalises the same way), so a crash mid-save
never leaves a directory that reads as a step. ``restore`` reads the
file back with ``torch.load(weights_only=True)`` (no pickle) and copies
each tensor into the given state's tensor, on its device, bit for bit.

The step list is read from the directory on every call: a manager sees
steps that another process wrote.

In a job of several processes rank 0 alone writes. A train state whose
module is built over a mesh is saved whole: every rank gathers the full
parameters and optimizer moments (``trainer.state_shardings``, an
all-gather over each split dim: ``tp``, and ``dp`` for MoE experts;
then, for a pipeline stage's module, an all-gather over ``pp`` of every
stage's layers, under their global names and in the whole model's
order) before rank 0 writes them. ``restore`` reads the whole state on
every rank and copies in this rank's blocks of its own layers. So a
checkpoint does not depend on the mesh that wrote it: a job written at
tp = 2 resumes at tp = 1, and one written at dp = 2 × pp = 2 at pp = 1.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import torch

from kubeflow_tpu_torch.parallel import mesh as pmesh

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _tree(state: Any) -> Any:
    """The saved structure of ``state``: a train state as ``{"module",
    "opt_state", "step"}``, any other tree as it is."""
    from kubeflow_tpu_torch.train.trainer import TrainState

    if isinstance(state, TrainState):
        return {"module": dict(state.module.state_dict(keep_vars=True)),
                "opt_state": state.opt_state, "step": state.step}
    return state


def _specs(state: Any) -> Any:
    """The specs tree of a train state built over a mesh, else None."""
    from kubeflow_tpu_torch.train.trainer import TrainState, state_shardings

    if isinstance(state, TrainState) and state.mesh is not None:
        return state_shardings(state, state.mesh)
    return None


def _param_names(state) -> List[str]:
    return [n for n, p in state.module.named_parameters() if p.requires_grad]


def _gather_state(tree: Any, specs: Any, state) -> Any:
    """A mesh-built train state's saved tree, whole: every split tensor
    gathered, and a stage's layers joined by every stage's (a
    collective); the optimizer lists in the whole model's order."""
    from kubeflow_tpu_torch.models.convert import gather_named

    model, own = state.module, specs["module"]
    names = _param_names(state)
    opt = {}
    for key, val in tree["opt_state"].items():
        if isinstance(val, list) and len(val) == len(names):
            val = list(gather_named(dict(zip(names, val)), own,
                                    model).values())
        opt[key] = val
    return {"module": gather_named(tree["module"], own, model),
            "opt_state": opt, "step": tree["step"]}


def _local_state(saved: Any, specs: Any, state) -> Any:
    """This rank's part of a whole saved tree: its own layers (a stage's
    under ``pp``), and its block of each split tensor."""
    from kubeflow_tpu_torch.models.transformer import stage_peer

    if not isinstance(saved, dict) or not isinstance(saved.get("module"),
                                                      dict):
        return saved             # not a train state's: _load_into refuses
    model, own = state.module, specs["module"]
    split = getattr(model, "split", None)
    pp = getattr(split, "pp", 1)
    stage = pmesh.axis_index(state.mesh, "pp") if pp > 1 else 0
    per = model.config.n_layers // pp if pp > 1 else 0

    def mine(name):
        return stage_peer(name, stage, per) if per else name

    def cut(name, t):
        spec = pmesh.tensor_spec(own.get(name))
        return pmesh.local_block(t, spec, state.mesh) \
            if pmesh.is_sharded(spec) else t

    names = _param_names(state)
    local = set(names)
    # the whole model's trainable names, in the saved lists' order
    order = [n for n in saved["module"] if mine(n) in local]
    module = {n: cut(n, saved["module"][n])
              for n in state.module.state_dict(keep_vars=True)
              if n in saved["module"]}
    opt = {}
    for key, val in saved["opt_state"].items():
        if isinstance(val, list) and len(val) == len(order):
            by_name = dict(zip(order, val))
            val = [cut(n, by_name[n]) for n in names]
        opt[key] = val
    return {"module": module, "opt_state": opt, "step": saved["step"]}


def _rank() -> int:
    import torch.distributed as tdist

    return tdist.get_rank() if tdist.is_initialized() else 0


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, (bool, int, float)) or tree is None:
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _load_into(target: Any, saved: Any, path: str) -> Any:
    """``saved`` copied into ``target``'s tensors in place; returns the
    tree with its numbers replaced by the saved ones."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or (
                saved.shape != target.shape or saved.dtype != target.dtype):
            raise ValueError(f"checkpoint {path}: {_describe(saved)} does "
                             f"not fit {_describe(target)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"checkpoint {path}: keys differ")
        for k in target:
            target[k] = _load_into(target[k], saved[k], f"{path}/{k}")
        return target
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise ValueError(f"checkpoint {path}: lengths differ")
        out = [_load_into(t, v, f"{path}/{i}")
               for i, (t, v) in enumerate(zip(target, saved))]
        if isinstance(target, list):
            target[:] = out
            return target
        return tuple(out)
    return saved


def _describe(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return f"{tuple(x.shape)} {x.dtype}"
    return type(x).__name__


class CheckpointManager:
    """Save and restore train states under ``<dir>/<step>/``."""

    def __init__(self, directory: str, *, keep: int = 3) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, *, wait: bool = False) -> None:
        """Copy ``state`` to the host now and write it in the background;
        ``wait`` blocks until it is on disk (end of training, tests).
        A save waits for the one before it. Rank 0 alone writes; a state
        built over a mesh is gathered first, on every rank (call it on
        all of them)."""
        self.wait()
        tree = _tree(state)
        specs = _specs(state)
        if specs is not None:
            tree = _gather_state(tree, specs, state)
        if _rank() != 0:
            return
        snapshot = _to_host(tree)
        self._writer = threading.Thread(
            target=self._write, args=(int(step), snapshot),
            name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        if wait:
            self.wait()

    def _write(self, step: int, snapshot: Any) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        final = os.path.join(self.directory, str(step))
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(snapshot, os.path.join(tmp, STATE_FILE))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        except Exception as e:  # noqa: BLE001 — raised again by wait()
            self._error = e
            shutil.rmtree(tmp, ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint save under {self.directory} "
                               f"failed") from err

    def all_steps(self) -> List[int]:
        """Every step with a complete checkpoint, ascending."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and
                      os.path.isfile(os.path.join(self.directory, n,
                                                  STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reload(self) -> None:
        """The reference's refresh of a cached step list: here every call
        reads the directory, so there is nothing to refresh."""

    def read(self, step: Optional[int] = None) -> Tuple[int, Any]:
        """``(step, tree)``: the whole saved tree of ``step`` (default:
        the latest) on the host, as :meth:`save` wrote it. A missing
        explicit step raises ``FileNotFoundError`` naming the steps
        there are."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self.directory}")
        elif step not in self.all_steps():
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.directory} "
                f"(have {self.all_steps()})")
        return step, torch.load(
            os.path.join(self.directory, str(step), STATE_FILE),
            map_location="cpu", weights_only=True)

    def restore(self, state: Any, step: Optional[int] = None, *,
                saved: Any = None) -> Any:
        """Copy the checkpoint of ``step`` (default: the latest) into
        ``state`` in place and return it; ``saved``: that step's tree,
        already :meth:`read`."""
        if saved is None:
            step, saved = self.read(step)
        specs = _specs(state)
        if specs is not None:     # this rank's blocks of the whole state
            saved = _local_state(saved, specs, state)
        tree = _tree(state)
        loaded = _load_into(tree, saved, str(step))
        if tree is not state:          # a train state
            state.opt_state = loaded["opt_state"]
            state.step = loaded["step"]
            return state
        return loaded

    def restore_or_init(self, state: Any) -> Tuple[Any, int]:
        """Resume from the latest checkpoint, else keep the fresh state.
        Returns ``(state, start_step)``: the same code runs on the first
        start and on every resume."""
        step = self.latest_step()
        if step is None:
            return state, 0
        log.info("resuming from %s step %d", self.directory, step)
        return self.restore(state, step), step

    def close(self) -> None:
        self.wait()
