"""BERT masked-LM pretraining job: the DDP-BERT baseline workload.

PyTorch port of ``kubeflow_tpu/examples/bert.py``:
``python -m kubeflow_tpu_torch.examples.bert --steps 100`` trains BERT
(BERT-base by default) on synthetic token streams with 15% masking,
with checkpoint/resume (``KFTPU_CHECKPOINT_DIR``), the step profiler
(``KFTPU_PROFILE_DIR``/``_START``/``_STEPS``) and one JSON metrics line
every ``--log-every`` steps. Same flags and defaults as the reference,
plus ``--device`` (CUDA by default).

Step ``s`` draws its global batch (``per_device_batch × dp``) from a
generator seeded by ``(99, s)``, so a run resumed from a checkpoint
trains on the batches an unbroken run trains on, and each data-parallel
rank trains on its rows of it (``make_mlm_train_step(mesh)``; the
encoder is whole on every rank, so a mesh with tp > 1 is refused
there). Rank 0 alone logs and writes checkpoints. The weights start
from ``random_bert_params(config, 0)``.
"""

from __future__ import annotations

import argparse
import time

import torch

from kubeflow_tpu_torch.examples.common import (
    checkpoint_dir,
    launcher_init,
    rank_logger,
)
from kubeflow_tpu_torch.models.bert import BertConfig, mask_tokens
from kubeflow_tpu_torch.models.convert import random_bert_params
from kubeflow_tpu_torch.ops.sampling import noise_seed
from kubeflow_tpu_torch.parallel.mesh import data_parallel_size
from kubeflow_tpu_torch.train import (
    create_bert_train_state,
    make_mlm_train_step,
    make_optimizer,
)
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from kubeflow_tpu_torch.utils.profiler import StepProfiler

DATA_SEED = 99


def batch_for_step(step: int, batch: int, seq_len: int, vocab_size: int):
    """``(tokens, labels, weights)`` of step ``step``, on the CPU: labels
    uniform over the vocabulary, then the MLM corruption, all from one
    generator seeded by ``(DATA_SEED, step)``."""
    gen = torch.Generator().manual_seed(noise_seed(DATA_SEED, step))
    labels = torch.randint(0, vocab_size, (batch, seq_len), generator=gen,
                           dtype=torch.int32)
    tokens, weights = mask_tokens(gen, labels)
    return tokens, labels, weights


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--per-device-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--vocab-size", type=int, default=30522)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--n-heads", type=int, default=12)
    p.add_argument("--d-ff", type=int, default=3072)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    penv, mesh, device = launcher_init(tp=args.tp, device=args.device)
    step_fn = make_mlm_train_step(mesh)
    log = rank_logger(penv)
    config = BertConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        d_ff=args.d_ff,
        max_seq_len=args.seq_len,
    )
    batch = args.per_device_batch * data_parallel_size(mesh)
    tx = make_optimizer(args.learning_rate, warmup_steps=20,
                        decay_steps=args.steps + 1)
    state = create_bert_train_state(config, random_bert_params(config, 0),
                                    tx, device=device)

    ckpt = None
    start_step = 0
    if checkpoint_dir():
        ckpt = CheckpointManager(checkpoint_dir())
        state, start_step = ckpt.restore_or_init(state)
    if start_step >= args.steps:
        log(start_step, done=True)
        if ckpt:
            ckpt.close()
        return 0.0

    tokens_per_step = batch * args.seq_len
    last_loss = float("nan")
    t_window = time.perf_counter()
    prof = StepProfiler.from_env()
    for step in range(start_step, args.steps):
        prof.step(step)
        tokens, labels, weights = batch_for_step(
            step, batch, args.seq_len, args.vocab_size)
        state, metrics = step_fn(state, tokens, labels, weights)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            last_loss = float(metrics["loss"])
            dt = time.perf_counter() - t_window
            steps_done = (step + 1 - start_step) % args.log_every or \
                args.log_every
            log(
                step + 1,
                loss=round(last_loss, 4),
                tokens_per_sec=round(tokens_per_step * steps_done / dt, 1),
                step_time_ms=round(dt / steps_done * 1e3, 2),
            )
            t_window = time.perf_counter()
        if ckpt and ((step + 1) % args.checkpoint_every == 0
                     or step + 1 == args.steps):
            ckpt.save(step + 1, state)
    prof.close()
    if ckpt:
        ckpt.close()
    log(args.steps, loss=round(last_loss, 4), done=True)
    return last_loss


if __name__ == "__main__":
    main()
