"""Transformer LM training job with checkpoint/resume: the flagship job.

PyTorch port of ``kubeflow_tpu/examples/lm.py``:
``python -m kubeflow_tpu_torch.examples.lm --steps 100`` trains the
decoder LM (d_model 768, 12 layers, 12 heads, d_ff 3072, vocab 32000,
seq 512, batch 8 by default; ``--n-experts`` makes each MLP a mixture
of experts) on synthetic token streams, under step telemetry
(``make_step_telemetry``: step-time histogram, tokens/s, MFU, HBM
watermarks, the flight recorder), with checkpoint/resume
(``KFTPU_CHECKPOINT_DIR``), the step profiler (``KFTPU_PROFILE_DIR``/
``_START``/``_STEPS``) and one JSON metrics line every ``--log-every``
steps. After training it can greedy-sample (``--generate N``), export
for serving (``--export DIR``) and distill and export a paired
speculative draft (``--draft-layers L``, ``DIR-draft`` with
``draft_of: <name>@1``). Same flags and defaults as the reference, plus
``--device`` (CUDA by default) and ``--attention-impl`` (the
reference's dense default, or ``flash``, which runs the CUDA kernels).

Across processes (the operator's env contract, ``launcher_init``) the
mesh is ``dp × tp`` (``--tp``; by default the reference's
``auto_mesh_config``). Step ``s`` (from 1) draws its GLOBAL batch of
``per_device_batch × dp`` rows from a generator seeded by ``(1234,
s)``, and each data-parallel rank trains on its rows of it: a run
resumed from a checkpoint trains on the batches an unbroken run trains
on, and a run at dp = 2 on the batches of a run at dp = 1. Rank 0 alone
logs, checkpoints (the gathered state, ``train/checkpoint.py``) and
samples, exports and distills, from the gathered parameters. MoE
(``--n-experts``) splits its experts over ``dp`` (expert parallelism,
``models/transformer.py``). The pipeline has no flag here, as the
reference's has none: it is ``launcher_init(pp=...)`` with
``make_pipelined_lm_train_step``. The weights start from
``random_params(config, 0)``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from kubeflow_tpu_torch.examples.common import (
    checkpoint_dir,
    launcher_init,
    log_metrics,
    rank_logger,
    make_step_telemetry,
)
from kubeflow_tpu_torch.models.convert import (
    bert_params,
    random_params,
    unsharded,
)
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.ops.sampling import noise_seed
from kubeflow_tpu_torch.parallel.mesh import data_parallel_size
from kubeflow_tpu_torch.train import (
    create_sharded_state,
    make_lm_train_step,
    make_optimizer,
)
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from kubeflow_tpu_torch.utils.profiler import StepProfiler

DATA_SEED = 1234
PROMPT_SEED = 7


def batch_for_step(step: int, batch: int, seq_len: int,
                   vocab_size: int) -> torch.Tensor:
    """Step ``step``'s ``(batch, seq_len)`` int32 tokens, uniform over
    the vocabulary, on the CPU, from a generator seeded by
    ``(DATA_SEED, step)``."""
    gen = torch.Generator().manual_seed(noise_seed(DATA_SEED, step))
    return torch.randint(0, vocab_size, (batch, seq_len), generator=gen,
                         dtype=torch.int32)


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--per-device-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--n-layers", type=int, default=12)
    p.add_argument("--n-heads", type=int, default=12)
    p.add_argument("--d-ff", type=int, default=3072)
    p.add_argument("--n-experts", type=int, default=0)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--export", default=None, metavar="DIR",
                   help="export the trained model for serving "
                        "(versioned model-store layout)")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedy-decode N tokens as a "
                        "smoke sample")
    p.add_argument("--draft-layers", type=int, default=0, metavar="L",
                   help="with --export: also distill an L-layer draft "
                        "from the trained model and export it as the "
                        "paired speculative draft (<export>-draft, "
                        "draft_of pairing)")
    p.add_argument("--draft-distill-steps", type=int, default=200)
    p.add_argument("--device", default="cuda")
    p.add_argument("--attention-impl", default="dense",
                   choices=("dense", "flash"))
    args = p.parse_args(argv)

    penv, mesh, device = launcher_init(tp=args.tp, device=args.device)
    dp = data_parallel_size(mesh)
    log = rank_logger(penv)
    config = TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=args.n_heads,
        d_ff=args.d_ff,
        max_seq_len=args.seq_len,
        n_experts=args.n_experts,
        attention_impl=args.attention_impl,
    )
    batch = args.per_device_batch * dp
    tx = make_optimizer(args.learning_rate, warmup_steps=20,
                        decay_steps=args.steps + 1)
    state, _ = create_sharded_state(config, random_params(config, 0), tx,
                                    mesh, device=device)

    ckpt = None
    start_step = 0
    if checkpoint_dir():
        ckpt = CheckpointManager(checkpoint_dir())
        state, start_step = ckpt.restore_or_init(state)
    if start_step >= args.steps:
        # restarted after the final checkpoint: nothing left to train,
        # but the sample and the exports must still be delivered
        log(start_step, done=True)
        _finish(args, config, state, penv.is_coordinator)
        if ckpt:
            ckpt.close()
        return 0.0

    telem = make_step_telemetry(tokens_per_step=batch * args.seq_len)
    step_fn = telem.wrap(make_lm_train_step(mesh))
    prof = StepProfiler.from_env()
    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(start_step + 1, args.steps + 1):
        prof.step(step)
        tokens = batch_for_step(step, batch, args.seq_len,
                                config.vocab_size)
        state, metrics = step_fn(state, tokens)
        tokens_done += batch * args.seq_len
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])      # waits for the step
            tps = tokens_done / (time.perf_counter() - t0)
            log(step, loss=loss, grad_norm=metrics["grad_norm"],
                tokens_per_sec=tps,
                tokens_per_sec_per_chip=tps / penv.num_processes,
                **{f"step_{k}": v for k, v in telem.summary().items()})
        if ckpt and (step % args.checkpoint_every == 0 or step == args.steps):
            ckpt.save(step, state)
    prof.close()
    if ckpt:
        ckpt.wait()
        ckpt.close()
    _finish(args, config, state, penv.is_coordinator)
    return float(metrics["loss"])


def _finish(args, config: TransformerConfig, state, coordinator: bool
            ) -> None:
    """Post-training side effects, also on the restarted-after-the-final-
    checkpoint path: the greedy sample, the export, the paired draft,
    by rank 0 from the gathered parameters (every rank gathers)."""
    if not (args.generate or args.export):
        return
    model = unsharded(state.module)
    if not coordinator:
        return
    if args.generate:
        from kubeflow_tpu_torch.models.decode import generate

        prompt_len = max(1, min(8, config.max_seq_len // 2))
        max_new = min(args.generate, config.max_seq_len - prompt_len)
        if max_new < 1:
            log_metrics(args.steps, sample_skipped=(
                f"max_seq_len {config.max_seq_len} leaves no room to "
                "generate"))
        else:
            gen = torch.Generator().manual_seed(noise_seed(PROMPT_SEED, 0))
            prompt = torch.randint(0, config.vocab_size, (1, prompt_len),
                                   generator=gen, dtype=torch.int32)
            out = generate(model, prompt.to(state.device),
                           max_new_tokens=max_new)
            log_metrics(args.steps, sample_tokens=out[0].tolist())
    if args.export:
        from kubeflow_tpu_torch.serving.model_store import (
            export_model,
            transformer_export_config,
        )

        vdir = export_model(
            args.export, "transformer",
            bert_params(model, scan_layers=config.scan_layers), version=1,
            config=transformer_export_config(config))
        log_metrics(args.steps, exported=vdir)
        if args.draft_layers:
            # train -> serve with speculative decoding: a layer-truncated,
            # self-distilled draft exported as this model's paired draft
            from kubeflow_tpu_torch.train.distill import make_draft

            dcfg, draft, stats = make_draft(
                config, model, n_layers=args.draft_layers,
                distill_steps=args.draft_distill_steps)
            name = os.path.basename(os.path.normpath(args.export))
            droot = os.path.join(os.path.dirname(
                os.path.normpath(args.export)), f"{name}-draft")
            ddir = export_model(
                droot, "transformer",
                bert_params(draft, scan_layers=dcfg.scan_layers), version=1,
                config=transformer_export_config(dcfg),
                draft_of=f"{name}@1")
            log_metrics(args.steps, draft_exported=ddir,
                        draft_distill_loss=stats["last_loss"])


if __name__ == "__main__":
    main()
