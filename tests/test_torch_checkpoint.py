"""The port's checkpoint manager on the CPU: the reference's policy
(``tests/test_checkpoint.py``) and a bit-exact resume of the MLM step."""

import os

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.train import (
    create_bert_train_state,
    make_mlm_train_step,
    make_optimizer,
)
from kubeflow_tpu_torch.train import checkpoint as ckpt_mod
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(2)

CFG = BertConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq_len=16, dtype="float32", remat=False)


def _state(seed=0):
    return create_bert_train_state(
        CFG, convert.random_bert_params(CFG, seed),
        make_optimizer(1e-2, warmup_steps=1, decay_steps=50), device="cpu")


def _batch(i):
    rng = np.random.default_rng(100 + i)
    labels = rng.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)
    weights = (rng.random((4, 16)) < 0.3).astype(np.float32)
    tokens = np.where(weights > 0, 103, labels).astype(np.int32)
    return tokens, labels, weights


def _tensors(state):
    """Every tensor a train state saves, by name."""
    out = {f"module/{k}": v for k, v in state.module.state_dict().items()}
    for key in ("mu", "nu"):
        out.update({f"{key}/{i}": t
                    for i, t in enumerate(state.opt_state[key])})
    return out


def _train(state, steps, start=0):
    step = make_mlm_train_step()
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, *_batch(i))
        losses.append(float(m["loss"]))
    return state, losses


def test_save_restore_round_trip_is_bit_exact(tmp_path):
    state, _ = _train(_state(), 2)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(2, state, wait=True)
    assert mgr.latest_step() == 2 and mgr.all_steps() == [2]
    fresh = _state(seed=1)
    assert not torch.equal(fresh.params[0], state.params[0])
    restored = mgr.restore(fresh)
    assert restored is fresh
    assert restored.step == 2 and restored.opt_state["count"] == 2
    want, got = _tensors(state), _tensors(restored)
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    mgr.close()


def test_resumed_run_takes_the_unbroken_runs_steps(tmp_path):
    """Train 2 steps, save, restore into a fresh state in a new manager
    (a restarted job), and take 2 more: losses and every tensor equal
    the unbroken 4-step run's, exactly."""
    unbroken, losses = _train(_state(), 4)
    first, _ = _train(_state(), 2)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, first, wait=True)
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    resumed, start = mgr2.restore_or_init(_state(seed=5))
    assert start == 2
    resumed, tail = _train(resumed, 2, start=2)
    assert tail == losses[2:] and resumed.step == 4
    want, got = _tensors(unbroken), _tensors(resumed)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_retention_keeps_last_n(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for i in range(1, 5):
        state, _ = _train(state, 1, start=i)
        mgr.save(i, state, wait=True)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4"]
    with pytest.raises(FileNotFoundError, match=r"have \[3, 4\]"):
        mgr.restore(state, step=1)
    mgr.close()


def test_restore_nonexistent_step_raises_loudly(tmp_path):
    """An explicit step with no checkpoint raises naming the steps there
    are; a tree of tensors restores in place."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = {"w": torch.arange(4.0), "n": 3}
    mgr.save(2, state, wait=True)
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 5"):
        mgr.restore(state, step=5)
    target = {"w": torch.zeros(4), "n": 0}
    out = mgr.restore(target, step=2)
    assert torch.equal(target["w"], torch.arange(4.0)) and out["n"] == 3
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore({"w": torch.zeros(5), "n": 0})
    mgr.close()


def test_restore_or_init_on_empty_but_existing_directory(tmp_path):
    empty = tmp_path / "ckpt"
    empty.mkdir()
    mgr = CheckpointManager(str(empty))
    state = _state()
    out, start = mgr.restore_or_init(state)
    assert out is state and start == 0 and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        mgr.restore(state)
    mgr.close()


def test_unfinished_step_is_never_the_latest(tmp_path):
    """A save cut off mid-write leaves a temporary directory (or a step
    directory without its file): neither reads as a step."""
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d))
    state = {"w": torch.ones(3)}
    mgr.save(4, state, wait=True)
    (d / ".tmp-9-1234").mkdir()
    (d / ".tmp-9-1234" / ckpt_mod.STATE_FILE).write_bytes(b"\x00partial")
    (d / "7").mkdir()
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    out, start = mgr.restore_or_init({"w": torch.zeros(3)})
    assert start == 4 and torch.equal(out["w"], torch.ones(3))
    mgr.close()


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """``save(wait=False)`` returns while the write is in flight; the
    state may change in place at once, and ``wait()`` puts the values of
    the moment of the save on disk."""
    import threading

    gate = threading.Event()
    real_save = torch.save

    def slow_save(obj, path):
        assert gate.wait(10)
        real_save(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", slow_save)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    w = torch.arange(6.0)
    mgr.save(1, {"w": w})
    assert mgr.all_steps() == []           # still writing
    w.add_(100.0)                          # the loop goes on in place
    gate.set()
    mgr.wait()
    assert mgr.all_steps() == [1]
    out = mgr.restore({"w": torch.zeros(6)})
    assert torch.equal(out["w"], torch.arange(6.0))
    mgr.close()


def test_failed_write_raises_at_wait(tmp_path, monkeypatch):
    def broken_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken_save)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="failed") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    assert mgr.all_steps() == [] and os.listdir(tmp_path / "ckpt") == []
