#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and the port package beside it; without
them it exits non-zero and prints no result. It imports nothing of JAX or
of ``kubeflow_tpu``. Phases, each fatal on failure:

1. build the CUDA kernels from ``kubeflow_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all in parallel) and print the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card, timed
   with CUDA events: paged attention at two lengths, ragged rows up to
   2048 tokens and phase 3's 251-363 (bf16 within atol 8e-3, f32 within
   atol 1e-5, GQA included; repeat calls bit-identical, the fused fold's
   counters back at zero; every bf16 Dh-64 case of a group <= 8, pages of
   16 and a kv-head slice among them, through ``paged_decode_tma_kernel``,
   whose four variants each need a ptxas line and no spill, and every
   other case through ``paged_decode_kernel``; timed beside the floor of
   the timing, a one-element fill), the sampler (token-identical to its plain
   version on the shared adversarial rows of ``tests/sampler_rows.py``
   at V=32000 and 128,256, all at once and each alone, on two of them
   past the clusters' shared memory, and on random rows at B=8 and 1;
   its ptxas registers printed, a spill fails), and
   the flash forward and backward (B=2, H=16, D=64, S=2048 and
   a ragged 1000, causal and not, with and without ``kv_len``, the
   training case S=8192 bf16 causal, and the LM entry point's B=8,
   S=512, H=12 bf16 causal; lse within 1e-5; f32 within 1e-5
   on out and 1e-4 on gradients; bf16 within a norm-relative error of
   4e-4, which a bf16 fault in each output must exceed; a repeat
   backward bit-identical in dQ, dK and dV), timed at the training case
   beside ``scaled_dot_product_attention`` (timed only, each backend
   pinned in turn, the fastest kept), with each flash kernel's ptxas
   registers and spills (the D=64 kernels, the wgmma forward and the
   one-pass wgmma backward, must each have a line and must not spill,
   and no flash kernel may carry ptxas's wgmma serialization note); and
   BERT's
   shape (B=16, S=512, H=12, D=64, bf16, non-causal, with and without
   ``kv_len``),
   timed unmasked beside ``scaled_dot_product_attention(is_causal=False)``
   (the ``bert_shape`` entry of the record's two flash rows);
3. serve the full-width engine-bench LM (vocab 32000, d_model 1024, 8
   layers, 16 heads, max_seq_len 2048; random weights from a numpy seed,
   written as a model-store export) through the port's ``ModelServer``
   with the paged cache and the fused sampler, POST 8 concurrent
   ``:generate`` requests (greedy and sampled, ~300-token prompts, 64 new
   tokens) and require both kernels to have launched during that run;
   the engine gets a fresh ``RequestLedger`` and tracer: 8 records that
   tile their wall clock, each with prefill and decode seconds and 64
   tokens, each trace's ``engine.*`` spans under its
   ``serving.generate`` span;
4. run the same greedy requests through the engine in f32 with the
   kernel and with the gather path (TF32 off) and require identical
   token streams;
5. train the long-context LM (the same width, seq 8192, batch 2, bf16
   compute over f32 params, flash attention, remat) for 4 steps of
   ``make_lm_train_step`` through the step telemetry
   (``make_step_telemetry(sync=True)``) and require the flash kernels to
   have launched (forward 16 per step with remat, the one-pass backward
   8, the dQ and dK/dV kernels of the other routes none), a finite loss
   near ln(32000) that falls, every parameter updated, and the
   telemetry's median step (of steps 2-4) within 10% of the phase's own
   (it also prints the telemetry's tokens/s, MFU from the FLOP probe,
   recompiles and the HBM sampler's peak);
6. one f32 train step (TF32 off) of a 2-layer model at seq 512 with
   flash and with dense attention from the same weights: loss,
   gradients and updated parameters within 1e-5;
7. train ResNet-50 as ``bench/suite.py:bench_resnet50`` runs it with
   ``KFTPU_RESNET_FUSED_BN=1`` (batch 256 of 224x224 images, bf16
   compute and BN over f32 params, the space_to_depth stem, SGD 0.1 with
   momentum 0.9; random weights from a numpy seed) for 5 steps of
   ``make_image_train_step`` and require both bnconv kernels to have
   launched 16 times a step, finite losses near ln(1000) that fall, the
   running statistics moved and every parameter updated; then the same run
   unfused from the same weights, for the card's fused-vs-unfused rate;
8. one f32 train step (TF32 off) of a small ResNet fused and unfused
   from the same weights: loss, gradients and updated parameters within
   the limits of ``resnet_parity_phase``;
9. drive the dense engine (the reference's default) at
   ``bench/suite.py:bench_decode_engine``'s configuration (the phase-3
   widths at max_seq_len 256; random weights from a numpy seed; 48
   requests of 128 prompt tokens and 128 new through 32 slots, 64 steps
   a host round-trip, burst admission in batches of 8): a greedy, a
   fused-sampled (temperature 0.8, top_k 40, top_p 0.95) and a
   bounded-sampled burst, each after the reference bench's warm-up;
   require 128 in-range tokens for every request, batch prefills, the
   sampler launched on the fused burst and the paged kernel never, and
   print tokens/s, the first wave's TTFT (until the 32nd first token
   reaches its request's queue), steps, batch prefills and peak memory;
   then a second fused burst holds every sampler call the engine makes
   (the sampled steps at (32, 32000), the batch prefills' first tokens)
   against the plain sampler on the same inputs, token for token, and
   its streams against the timed burst's; each engine's fresh
   ``RequestLedger`` holds 48 tiling records of 128 tokens, and the
   first wave's TTFT read off it (``bench/suite.py:
   ledger_burst_ttft_ms``) is within 5% of the queue-based reading;
10. the phase-3 export in f32 (TF32 off) through the dense engine with
    burst admission, the paged engine with its kernel, the unary
    ``LoadedModel.generate`` and a default ``ModelServer`` (no
    ``KFTPU_PAGED``, ``decode_slots=0``) ``:generate``: four identical
    greedy streams;
11. train BERT-base as ``bench/suite.py:bench_bert`` does (batch 16, seq
    512, bf16 compute over f32 params, remat, ``attention_impl="auto"``,
    ``make_optimizer(1e-4, warmup_steps=10, decay_steps=1000)``; random
    weights and one fixed batch with 15 % weights from numpy seeds) for 5
    steps of ``make_mlm_train_step`` and require the flash kernels to
    have launched 24 / 12 / 12 times a step (forward with remat, dQ,
    dK/dV), finite losses near ln(30522) that fall, and every parameter
    updated;
12. one f32 MLM step (TF32 off) of a 2-layer BERT at BERT-base's widths
    and seq 512 with ``seq_lengths`` [512, 377, 64, 1], with flash and
    with dense attention from the same weights: loss, gradients and
    updated parameters within 1e-5;
13. ``examples.bert.main`` at its defaults (BERT-base, batch 8, seq 128):
    4 steps with a checkpoint every 2 and the profiler on steps 1-2, a
    restart to 6 steps, and an unbroken 6-step run; the restart resumes
    at step 4, the step-4 checkpoint restores into a fresh state bit for
    bit, steps 5-6 take the unbroken run's losses within 1e-5 relative,
    and the trace names the flash forward, the one-pass backward and
    its dQ pass, and none of the dQ or dK/dV kernels;
14. ``examples.lm.main`` at its defaults (d_model 768, 12 layers, vocab
    32000, seq 512, batch 8, dense attention): 6 steps with a
    checkpoint every 3, a 16-token sample, the export and a 2-layer
    draft distilled 20 steps and exported with ``draft_of: lm@1``; a
    restart at 6 that trains nothing and still exports; and 3 steps
    restarted to 6, whose steps 4-6 take the 6-step run's losses within
    1e-5 relative; losses within 1.0 of ln(32000);
15. the same entry point with ``--n-experts 8`` (top-2, dense dispatch)
    for 4 steps: finite losses, a nonzero auxiliary loss, and a gradient
    on the router and every expert's weights in every layer;
16. a ``ModelServer`` over phase 14's store pairs the draft: 4 prompts
    of 32 tokens, 64 new, greedy, with ``speculative: true, draft_len:
    4`` and without; at f32 (TF32 off) token-identical, with the round
    stats and the four speculative counters; at bf16 timed;
17. ``:predict`` through one ``ModelServer`` (``warmup=True``) over
    exports written by the port's ``export_model`` from numpy seeds:
    ``mnist``, ResNet-50 (``bench_resnet50``'s widths, bf16 over f32,
    the ``conv`` stem) fused and the same weights unfused, BERT-base
    (bf16, ``attention_impl="auto"``) and phase 3's LM. Every padded
    bucket of the image kinds warmed; mnist at batch 1, 3 and 8 held to
    the same weights on the CPU; 8 ResNet images over HTTP launching the
    bnconv forward 16 times a fused call; BERT at (1, 128) over HTTP and
    (8, 512) in process launching the flash forward 12 times a call; no
    backward kernel ever; the LM's last-position argmax at (2, 64) equal
    to ``:generate``'s greedy first token; a wrong-shaped ResNet request
    400; an id past BERT's vocabulary the reference's NaN sequence, the
    card serving on. Each kind's request wall p50 over 3 calls and its
    split (JSON decode, host to device, forward by CUDA events, device
    to host, JSON encode) and peak memory are printed. Before it, both
    kernels are held to their plain versions and timed at the shapes
    ``:predict`` gives them, without autograd (bnconv at the four sites
    at batch 1, 8 and phase 24's batch-prediction chunk of 16, flash at
    (1, 128) and (8, 512));
18. f32 (TF32 off) ``:predict`` parity from the same weights: ResNet-50
    fused against unfused (the same top-1 for 8 images, logits within
    1e-4 of their max-abs) and BERT-base flash against dense (logits
    within 1e-5);
19. the image-classification entry points at the reference's widths:
    ``examples.resnet.main`` (ResNet-50, 224², batch 128, 3 warm-up and
    6 timed steps) on synthetic tensors, then from 256 records of
    shards (~154 MB) through the native loader (required) and the
    device feed; ``examples.vit.main`` (ViT-B/16, batch 64) and
    ``examples.mnist.main`` at its defaults (100 steps of 128). The
    synthetic runs' losses fall, MNIST's accuracy clears 0.9, and none
    of the seven kernels launches (the reference's defaults); images/s,
    ms a step and peak memory printed;
20. the gRPC ``Predict`` core without the transport (this machine has
    no ``grpc``/``protobuf``) over phase 17's exports: binary decode,
    the integer cast and padding, ``LoadedModel.predict``, binary
    encode, each timed, for ResNet-50 fused at batch 8 (f32, uint8 and
    bf16 pixels) and BERT-base at (1, 128) through the binary codec
    (its int32 tokens refused by ``Predict`` itself, as the reference
    refuses them); every output equal to the REST ``:predict``'s, a
    bf16 round trip bit for bit, bnconv forward 16 launches a ResNet
    call and flash forward 12 a BERT call. Where ``grpc`` imports, the
    service runs ``Predict`` and ``Generate`` through ``PredictClient``
    too; else one line says why it did not. Phase 5 also splits each
    step's own wall into the telemetry's window, its work after the
    window and the loop's rest;
21. the mesh path: ``torch.cuda.device_count()`` ranks started through
    the port's ``run_multiprocess`` with the operator's env contract,
    over NCCL, each on its own card (this file with ``--mesh-rank``).
    Each rank checks the five collectives on ``dp`` for their values,
    times them at 64 MB (algorithmic bandwidth; bus bandwidth where
    n > 1) and reports NCCL's version; holds the flash forward and backward
    against their plain versions at each run's local heads, (8, 512,
    12 / tp, 64) bf16 causal, on its card; runs ``examples.lm.main`` at
    its defaults with flash attention through ``launcher_init``'s mesh
    at dp = world, tp = 1 (and tp = 2 where world >= 2), 3 warm-up and
    6 timed steps (step p50, tokens/s per card, MFU, peak GB); holds
    three f32 steps (TF32 off) of the mesh step against three of the
    mesh-less ``make_lm_train_step`` on the same weights and batches
    (loss, grad norm, parameters within 1e-5, and each parameter's
    movement within 2e-3 of its own size); and holds ring and Ulysses
    over ``tp`` = world against flash (logits over their magnitude,
    loss, grad norm within 1e-5).
    The flash rows must launch there;
22. the pipeline, MoE over the mesh and the image step over ``dp``, at
    world 1 over NCCL through ``launcher_init(pp=1)``'s mesh: the flash
    kernels held to their plain versions at one pipelined microbatch
    (2, 512, 12, 64) bf16 causal, and the bnconv kernels at the four
    ResNet-50 sites at batch 128; ``make_pipelined_lm_train_step`` (4
    microbatches) at ``examples/lm.py``'s widths with flash, 3 warm-up
    and 6 timed steps, its flash launches the prediction (12 layers x 4
    ticks a step, the forward doubled by remat), then three f32 steps
    (TF32 off) against ``make_lm_train_step`` over the same mesh (loss,
    grad norm, parameters within 1e-5, movement within 2e-3);
    ``examples.lm.main --n-experts 8 --attention-impl flash`` for 4
    steps, and the f32 MoE mesh step against the mesh-less one, dense
    and capacity 1.25, at the same limits; ResNet-50 fused at batch 128
    through ``make_image_train_step(mesh)`` with BatchNorm over the
    global batch, 2 warm-up and 5 timed steps (bnconv forward and dW 16
    a step), and the f32 mesh step against the mesh-less one (loss 1e-5,
    running statistics 1e-6).
23. mesh serving and the encoders over ``tp`` (:func:`mesh_serving_phase`);
24. the elastic plane, batch prediction, the multislice check and
    Podracer, each part fatal: (a) one gang of two ranks on the card
    over gloo (this file with ``--elastic-rank``) shrinks an f32 run (2
    layers at ``examples/lm.py``'s widths, flash, TF32 off) from 2
    slices to 1 through ``ElasticCoordinator`` (2 steps, the resize, 1
    step) and holds it to 3 unbroken ``make_lm_train_step`` steps (loss,
    grad norm, parameters within 1e-5, movement within 2e-3); both ranks
    re-gang and run the bf16 shrink at ``examples/lm.py``'s widths (6
    layers, flash, global batch 16): 3 steps at 2 slices, rank 1
    snapshots and leaves, rank 0 re-enters at world 1 over NCCL,
    restores the snapshot bit for bit and takes steps 4-6 (``state.step
    == 4`` after the first), the three spans under the job's trace; then
    a ``SHUTDOWN`` snapshot, which a fresh process (``--elastic-resume``,
    started once the gang has ended) resumes at step 7; the snapshot, reshard
    and resume seconds and the checkpoint's bytes are printed. (b)
    ``run_batch_predict`` over phase 17's fused ResNet-50 export, 40
    uint8 images at batch 16: predictions equal to
    ``LoadedModel.predict`` bit for bit, bnconv forward 48 launches. (c)
    ``testing/multislice_check`` one rank a card over NCCL, one slice
    each: ``ok`` and equal losses on every rank, within 1e-5 of plain
    ``make_lm_train_step`` steps on the same weights and tokens. (d)
    ``examples.podracer.main`` at its defaults: the learner's clock
    monotone over 2 → 1 → 2 actor slices;
25. every mesh composition the reference accepts
    (:func:`mesh_compose_phase`), each part fatal: (a) the MoE LM of
    ``examples/lm.py --n-experts 8`` (0.73 B parameters, random weights
    from a numpy seed, exported bf16 and f32) served at world 1 over
    NCCL with phase 3's traffic, then at tp = 2 by a gang of two ranks
    on the card over gloo (this file with ``--compose-rank``), paged and
    dense: f32 greedy and sampled streams equal to the unsplit engine's,
    the ranks sampling the same tokens, the bf16 model's teacher-forced
    logits within twice bf16's own effect; (b) the same gang at pp = 2:
    BERT-base's MLM step and ResNet-50 fused at the entry points'
    batches, timed, and their f32 twins against the unsplit steps; (c)
    ring and Ulysses with 8 experts at tp = 2, f32, against the unsplit
    step (loss, grad norm, parameters within 1e-5, movement 2e-3). The
    MoE LM's depth is cut to 4 layers (:data:`COMPOSE_MOE`);
26. the last modules (:func:`last_modules_phase`), each part fatal: (a)
    the compile ledger: ``make_compile_ledger()`` under a job identity
    while phase 1's quickest source builds into a fresh directory (one
    ``kftpu_compile_seconds`` observation within 10% of the build's
    wall, the library's digest as its fingerprint, its span in the job's
    trace; a load from disk records nothing); phase 1's own build runs
    under a ledger too, and its nvcc seconds by source are printed; (b)
    the tile table: each committed ``sm_90`` paged row's Python
    shared-memory formula equal to the library's, the kernel at its
    shape within phase 2's limits of its plain version, at the phase-2
    shape the row's split within 3% of the split phase 2 ran, the two
    pinned and timed in turns on one set of inputs, and a phase-3-shaped
    serving run whose every paged resolution comes from the table; (c)
    ``record_memory_budget`` of the BERT-base MLM step's first call at
    phase 11's shape, in a process of its own (``--budget-rank``):
    argument + temp + output within 10% of an ``HbmSampler``'s peak; (d) ``ModelMultiplexer(max_resident=1)`` over
    phase 17's ResNet-50 (fused) and BERT-base: A, B, A again, each
    prediction bit for bit a directly loaded model's, the allocated
    bytes at each fault after an eviction within 5% of those before the
    first load, 8 threads faulting one cold model one load; (e)
    ResNet-50 unfused at batch 256 with ``act_compress`` off and on
    (images/s, peak GB), and the f32 loss gate of
    ``tests/test_act_compress.py`` on a thin ResNet.

Each phase prints its seconds. Phase 2 also holds the bnconv forward and
dW kernels, and the autograd function's four gradients, against their
plain versions at the four ResNet-50 sites (bf16 and f32) and at ragged
shapes: bf16 outputs within
a norm-relative error of 4e-4, which a bf16 fault in each must exceed,
f32 within 1e-5, bf16 repeat calls bit-identical; it prints the wgmma
kernels' ptxas registers (a spill fails) and times each kernel at every
site. And it runs the inputs the kernels once refused through them, at
the same limits: flash at head dims 32, 80 and 96 (zero-padded), 256, and
past it 320 and 512 on the wide kernels (f32 and bf16; 256 and 512
timed at B=2, H=16, S=2048, causal), paged decode
at a GQA group of 16, at Dh=96 (bf16) and Dh=256 (f32), and the sampler
at Llama-3's 128,256-token vocabulary (token-identical, timed).

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, the ``{"kernels": [...]}`` record, and ``{"ok": true, ...}``.
In the record, a kernel's ``launches`` sums the paths that run it and
``launches_by_path`` gives each path's own count (zeroed just before
that path, read just after): ``paged_serving`` and ``dense_serving``
(rows 1-2), ``lm_train``, ``bert_train`` and ``bert_entry`` (rows 3-4),
``resnet_train`` (rows 5-6), and on every row ``lm_entry``,
``moe_train`` and ``spec_serving`` (phases 14-16: the reference's dense,
greedy defaults launch none of the kernels, which those phases require)
``predict`` (phase 17's calls), ``image_entry`` (phase 19: none),
``grpc_core`` (phase 20's calls), ``mesh_train`` (phase 21's entry
point run, summed over its ranks) and ``pipe_moe_image`` (phase 22's
pipelined LM step, MoE entry point and ResNet step, each zeroed just
before it and not its f32 parity runs: > 0 on rows 3-6, 0 on rows 1-2),
``mesh_serving`` and ``encoder_tp`` (phase 23; its f32 encoder steps
run the dQ and dK/dV kernels, which must launch, so row 4 reads 0
there), ``elastic`` (phase 24's
bf16 run over both ranks and the resume: > 0 on rows 3-4, 0 on the rest),
``batch_predict`` (48 on row 5, 0 on the rest) and ``mesh_compose``
(phase 25's runs summed over the processes: > 0 on rows 1-2 from (a),
on rows 3-4 from (b)'s BERT, on rows 5-6 from (b)'s ResNet) and
``last_modules`` (phase 26's serving run, BERT step, multiplexed calls
and ResNet steps: > 0 on rows 1, 3 and 5). The flash forward and bnconv forward
rows also carry ``predict_shapes``: their times at the inference shapes.
Row 1 also carries ``tma_launches_by_path``, its launches on
``paged_decode_tma_kernel`` (> 0 on ``paged_serving``, ``mesh_serving``
and ``mesh_compose``), ``floor_ms`` and ``shapes`` (phase 2's, the
serving rows' and phase 2's GQA 16/4 times, each with its bound).
"""

from __future__ import annotations

import gc
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 dense tensor cores
SEED = 0
BENCH = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             n_kv_heads=16, d_ff=4096, max_seq_len=2048)
# the long-context training bench (bench/suite.py:bench_longcontext)
TRAIN = dict(BENCH, max_seq_len=8192, attention_impl="flash", remat=True)
TRAIN_BATCH, TRAIN_STEPS = 2, 4
# (B, S, H, D) of flash in examples/lm.py at its defaults on one rank
# (per-device batch 8, seq 512, 12 heads of 64); tp splits the heads
LM_FLASH_SHAPE = (8, 512, 12, 64)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn``, from CUDA events around each call.

    - Cold L2: a 128 MB write (more than the 50 MB L2) runs before every
      timed call, outside its events, as the serving path's other layers
      evict the K/V pages between two reads of one layer's pool.
    - Device time only: the card then spins (``torch.cuda._sleep``) for
      twice the host time of one call, so the host has enqueued all of
      ``fn``'s launches before the start event is reached and the events
      do not time Python."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    cycles = int(2 * host_s * 2e9) + 200_000   # clocks <= 2 GHz
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def time_turns(fns, rounds: int = 20, warmup: int = 3) -> list:
    """Mean device time of each of ``fns``, timed as :func:`time_ms` times
    one call (cold L2, device time only), in turns inside one loop: every
    other round in reverse order (A, B, B, A, ... for two), so drift over
    the loop falls on each alike."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    host_s = 0.0
    for fn in fns:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t0)
    cycles = int(2 * host_s * 2e9) + 200_000   # clocks <= 2 GHz
    events = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            flush.zero_()
            torch.cuda._sleep(cycles)
            start.record()
            fns[i]()
            end.record()
            events[i].append((start, end))
    torch.cuda.synchronize()
    return [sum(s.elapsed_time(e) for s, e in ev) / rounds for ev in events]


# -- phase 2: kernels against their plain versions ------------------------


def paged_inputs(B, QH, KH, Dh, ps, n_log, dtype, device, seed):
    """Ragged rows over a shared pool: some rows keep their dead pages
    mapped, some map them to the sentinel, one row is all-sentinel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P = B * n_log
    Smax = n_log * ps
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, QH, Dh), generator=gen).to(device, dtype)
    k = torch.randn((P, ps, KH, Dh), generator=gen).to(device, dtype)
    v = torch.randn((P, ps, KH, Dh), generator=gen).to(device, dtype)
    perm = rng.permutation(P).astype(np.int32)
    pages = perm.reshape(B, n_log).copy()
    pos = rng.integers(0, Smax, size=B).astype(np.int32)
    pos[0] = Smax - 1                    # a full row
    for b in range(B):
        if b % 2:                        # dead pages unmapped
            pages[b, pos[b] // ps + 1:] = P
    pages[B - 1, :] = P                  # all-sentinel (disarmed) row
    pos[B - 1] = Smax
    return (q, k, v, torch.as_tensor(pages, device=device),
            torch.as_tensor(pos, device=device), P)


def paged_bytes_ops(q, k, pages, pos, P, ps):
    """Bytes the function must move and flops it must do on THESE
    inputs: each live key's K and V row (kv_pos <= pos on a mapped page),
    q and out once, the table and positions once."""
    B, QH, Dh = q.shape
    KH = k.shape[2]
    pages_np, pos_np = pages.cpu().numpy(), pos.cpu().numpy()
    n_log = pages_np.shape[1]
    live = 0
    for b in range(B):
        for j in range(n_log):
            if pages_np[b, j] == P:
                continue
            live += max(0, min(ps, int(pos_np[b]) - j * ps + 1))
    el = q.element_size()
    nbytes = (2 * live * KH * Dh * el + 2 * q.numel() * el
              + pages_np.nbytes + pos_np.nbytes)
    flops = 4 * live * QH * Dh
    return nbytes, flops


def paged_serving_inputs(B, QH, KH, Dh, ps, n_log, dtype, device, seed):
    """Rows as phase 3's serving run leaves them: positions drawn from
    251-363 (prompts of 251-300 tokens plus up to 64 new), each row's
    pages up to its frontier mapped from a shuffled pool, the rest the
    sentinel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    P = B * n_log
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, QH, Dh), generator=gen).to(device, dtype)
    k = torch.randn((P, ps, KH, Dh), generator=gen).to(device, dtype)
    v = torch.randn((P, ps, KH, Dh), generator=gen).to(device, dtype)
    perm = rng.permutation(P).astype(np.int32)
    pos = rng.integers(251, 364, size=B).astype(np.int32)
    pages = np.full((B, n_log), P, np.int32)
    for b in range(B):
        n = int(pos[b]) // ps + 1
        pages[b, :n] = perm[b * n_log:b * n_log + n]
    return (q, k, v, torch.as_tensor(pages, device=device),
            torch.as_tensor(pos, device=device), P)


# the paged kernel's two timed shapes (B=8, Dh=64, page 64, 32 logical
# pages, bf16): phase 2's ragged rows up to the full 2048 context, and
# phase 3's serving lengths
PAGED_SHAPES = {"phase2": paged_inputs, "serving": paged_serving_inputs}


# the paged TMA kernel's template variants (q heads a block: 1, 2, 4, 8)
PAGED_TMA_VARIANTS = 4


def paged_case(pa, q, k, v, pages, pos, label, atol, *, tma, zero_row):
    """The paged kernel at one case against its plain version: within
    ``atol``, finite, a repeat call bit for bit, the fold counters back at
    0, the all-sentinel last row zeros where ``zero_row``; and the route:
    each of the two calls through ``paged_decode_tma`` exactly where
    ``tma``. Returns the max abs error."""
    import torch

    before = dict(pa.launches)
    got = pa.paged_decode_attention(q, k, v, pages, pos)
    again = pa.paged_decode_attention(q, k, v, pages, pos)
    want = pa.paged_decode_attention_plain(q, k.contiguous(), v.contiguous(),
                                           pages, pos)
    torch.cuda.synchronize()
    check(pa.launches["paged_decode_attention"]
          == before["paged_decode_attention"] + 2,
          f"paged {label}: the kernel did not launch")
    tma_calls = pa.launches["paged_decode_tma"] - before["paged_decode_tma"]
    check(tma_calls == 2 * tma, f"paged {label}: {tma_calls} of 2 calls on "
                                f"the TMA route, want {2 * tma}")
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got.float()).all()),
          f"paged {label}: non-finite output")
    check(err <= atol, f"paged {label}: max abs err {err} > {atol}")
    if zero_row:
        check(got[-1].float().abs().max().item() == 0.0,
              f"paged {label}: all-sentinel row is not zeros")
    check(torch.equal(got, again), f"paged {label}: a repeat call differs")
    counters, _ = pa.device_scratch(q.device, 0, 0)
    check(int(counters.abs().sum()) == 0,
          f"paged {label}: fold counters not reset")
    route = "paged_decode_tma_kernel" if tma else "paged_decode_kernel"
    print(f"paged_attention {label} ({route}): max_abs_err={err:.3e} (atol "
          f"{atol}) mean_abs_out={want.float().abs().mean().item():.3e}; "
          f"repeat call bit-identical", flush=True)
    return err


def check_paged_kernel(device, build_log=""):
    """The paged kernels against their plain version. bf16 at Dh 64 and
    groups of at most 8 must take ``paged_decode_tma_kernel`` (phase 2's
    ragged rows and the serving rows at QH=KH 16 and GQA 16/4, pages of
    16, a slice of the pool's kv heads); f32, a group of 16, Dh 96 and
    256 must take ``paged_decode_kernel``. ``build_log`` is nvcc's output
    for ``paged_attention.cu``: every TMA variant needs a ptxas line and
    no spill. Times phase 2's and the serving rows (QH=KH 16) and phase
    2's GQA rows, each with its bound, beside the timing floor (a
    one-element fill)."""
    import torch

    from kubeflow_tpu_torch.ops import autotune as at
    from kubeflow_tpu_torch.ops import paged_attention as pa

    regs = ptxas_kernels(build_log, r"(paged_decode_tma_kernel)I(Li\d+E)E")
    for (name, variant), (n_regs, st, ld) in sorted(regs.items()):
        print(f"  ptxas {name}<{variant}>: {n_regs} registers, spill "
              f"stores {st} B, loads {ld} B", flush=True)
        check(st == 0 and ld == 0, f"{name}<{variant}> spills")
    if build_log:
        check(len(regs) == PAGED_TMA_VARIANTS,
              f"ptxas lines for {len(regs)} of {PAGED_TMA_VARIANTS} "
              "paged_decode_tma_kernel variants")
    else:
        print("  ptxas: paged_attention was built before this run (no "
              "compiler log)", flush=True)
    results = {}
    # (label, QH, KH, dtype, atol): bf16 tolerance — the plain version
    # rounds scores to bf16 after its einsum (the reference's gather
    # rounding point) while the kernels keep them in f32; both round the
    # output to bf16, so they differ by about one bf16 step of an output
    # of magnitude < 1 (3.9e-3); atol is two such steps. f32 differs only
    # by summation order
    cases = [("bf16", 16, 16, torch.bfloat16, 8e-3),
             ("bf16_gqa", 16, 4, torch.bfloat16, 8e-3),
             ("f32", 16, 16, torch.float32, 1e-5),
             ("f32_gqa", 16, 4, torch.float32, 1e-5)]
    for shape, make in PAGED_SHAPES.items():
        for label, QH, KH, dtype, atol in cases:
            q, k, v, pages, pos, P = make(8, QH, KH, 64, 64, 32, dtype,
                                          device, seed=SEED + QH + KH)
            err = paged_case(pa, q, k, v, pages, pos, f"{shape} {label}",
                             atol, tma=dtype == torch.bfloat16,
                             zero_row=shape == "phase2")
            results[shape, label] = (q, k, v, pages, pos, P, err)
    # the TMA route at pages of 16 (one box a page, 128 pages a row) and
    # over a slice of the pool's kv heads, read in place (kv heads 1-2 of
    # 4 and their q heads)
    q, k, v, pages, pos, P = paged_inputs(8, 8, 2, 64, 16, 128,
                                          torch.bfloat16, device,
                                          seed=SEED + 16)
    err = paged_case(pa, q, k, v, pages, pos, "phase2 bf16_p16", 8e-3,
                     tma=True, zero_row=True)
    results["phase2", "bf16_p16"] = (q, k, v, pages, pos, P, err)
    q, k, v, pages, pos, P = paged_serving_inputs(8, 16, 4, 64, 64, 32,
                                                  torch.bfloat16, device,
                                                  seed=SEED + 5)
    err = paged_case(pa, q[:, 4:12].contiguous(), k[:, :, 1:3],
                     v[:, :, 1:3], pages, pos, "serving bf16_slice", 8e-3,
                     tma=True, zero_row=False)
    results["serving", "bf16_slice"] = (q, k, v, pages, pos, P, err)
    # (label, QH, KH, Dh, dtype, atol): inputs the split kernel takes, a
    # GQA group of 16 (two blocks of 8 q heads), Dh = 96 at bf16 (lanes
    # rounded up to 16), Dh = 256 at f32 (two 16-byte slices a lane)
    wide = [("gqa16_bf16", 32, 2, 64, torch.bfloat16, 8e-3),
            ("dh96_bf16", 16, 16, 96, torch.bfloat16, 8e-3),
            ("dh256_f32", 16, 16, 256, torch.float32, 1e-5)]
    for label, QH, KH, Dh, dtype, atol in wide:
        q, k, v, pages, pos, P = paged_inputs(8, QH, KH, Dh, 64, 32, dtype,
                                              device, seed=SEED + QH + Dh)
        err = paged_case(pa, q, k, v, pages, pos,
                         f"phase2 {label} QH={QH} KH={KH} Dh={Dh}", atol,
                         tma=False, zero_row=True)
        results["phase2", label] = (q, k, v, pages, pos, P, err)
    one = torch.empty(1, device=device)
    floor_ms = time_ms(one.zero_)
    timed = {}
    for shape, label in (("phase2", "bf16"), ("serving", "bf16"),
                         ("phase2", "bf16_gqa")):
        q, k, v, pages, pos, P, _ = results[shape, label]
        with at.record_resolutions() as rec:
            pa.paged_decode_attention(q, k, v, pages, pos)
        kernel_ms = time_ms(lambda: pa.paged_decode_attention(
            q, k, v, pages, pos))
        plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
            q, k, v, pages, pos))
        nbytes, flops = paged_bytes_ops(q, k, pages, pos, P, k.shape[1])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        timed[shape, label] = (kernel_ms, plain_ms, t_bytes, t_ops,
                               rec[0]["split_tokens"])
        print(f"paged_attention {shape} {label} B=8 QH=16 KH={k.shape[2]} "
              f"Dh=64 ps=64 n_log=32 pos={pos.tolist()}: "
              f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={max(t_bytes, t_ops):.4f} ({nbytes} B) "
              f"floor_ms={floor_ms:.4f} (a one-element fill) split_tokens="
              f"{rec[0]['split_tokens']}", flush=True)
    kernel_ms, plain_ms, t_bytes, t_ops, split = timed["phase2", "bf16"]
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "kubeflow_tpu/ops/paged_attention.py:69",
            "max_abs_err": max(r[-1] for r in results.values()),
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "floor_ms": floor_ms,
            "phase2_split_tokens": split,
            "shapes": {f"{sh}/{lb}": {"ms": t[0], "plain_ms": t[1],
                                      "bound_ms": max(t[2], t[3])}
                       for (sh, lb), t in timed.items()}}


def sampler_inputs(device, B=8, V=32000, seed=SEED):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    logits = (3.0 * torch.randn((B, V), generator=gen)).to(device)
    # greedy x2, top-k x2, top-p x2, both, unfiltered
    temp = torch.tensor([0.0, 0.0, 0.8, 1.0, 0.9, 1.2, 0.7, 1.0],
                        device=device)
    top_k = torch.tensor([0, 5, 50, 1, 0, 0, 100, 0], dtype=torch.int32,
                         device=device)
    top_p = torch.tensor([1.0, 0.5, 1.0, 1.0, 0.9, 0.5, 0.8, 1.0],
                         device=device)
    return logits, temp, top_k, top_p


def sampler_rows():
    """``tests/sampler_rows.py`` (the shared adversarial rows and their
    float64 oracle; numpy only), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "sampler_rows", os.path.join(HERE, "tests", "sampler_rows.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# past the 8 slices a cluster holds in shared memory (~315,000 values): the
# cluster keeps its slices in the device-memory workspace
SAMPLER_BIG_V = 2 ** 19 + 3


def sampler_bytes_ops(logits, temp, top_k, top_p) -> tuple:
    """Bytes the sampler must move and operations it must do on these rows:
    each logit read once, the noise only where a row keeps a value (the
    float64 oracle's support), the per-row parameters and the token; per
    element a division and the final draw, and per radix pass over it a
    key and a compare (top-k, 4 passes) or a key, an exp and an add (top-p,
    4 passes and a max)."""
    import numpy as np

    oracle = sampler_rows().oracle_support
    x, t, k, p = (a.cpu().numpy() for a in (logits, temp, top_k, top_p))
    B, V = x.shape
    kept = sum(len(oracle(x[r], t[r], k[r], p[r])) for r in range(B)
               if t[r] > 0)
    nbytes = B * V * 4 + kept * 4 + B * (4 + 4 + 4) + B * 4
    sampled = t > 0
    kf = int((sampled & (k > 0) & (k < V)).sum())
    pf = int((sampled & (p < 1)).sum())
    flops = V * (B + 2 * 4 * kf + (3 * 4 + 1) * pf + 2 * int(sampled.sum()))
    return nbytes, flops


def check_sampler_kernel(device, build_log=""):
    """The cluster sampler against its plain version, token for token: the
    shared adversarial rows at V = 32000 and 128,256 (all rows at once and
    each alone, B = 1) and two of them past the clusters' shared memory
    (B = 2); random rows at B = 8 and B = 1. Prints its ptxas registers
    (a spill fails) and times it at B = 8 and B = 1 (V = 32000) and at
    V = 128,256."""
    import torch

    from kubeflow_tpu_torch.ops import sampling as sm

    regs = ptxas_kernels(build_log, r"(fused_sample_kernel)I(Lb[01]E)E")
    for (name, variant), (n_regs, st, ld) in sorted(regs.items()):
        print(f"  ptxas {name}<{variant}>: {n_regs} registers, spill "
              f"stores {st} B, spill loads {ld} B", flush=True)
        check(st == 0 and ld == 0,
              f"{name}<{variant}> spills ({st} B stored, {ld} B loaded)")
    if build_log:
        check(len(regs) == 2, "no ptxas lines for both fused_sample_kernel "
                              "variants in the build log")
    else:
        print("  ptxas: fused_sample was built before this run (no "
              "compiler log)", flush=True)
    held = 0

    def hold(logits, noise, *args):
        nonlocal held
        before = sm.launches["fused_sample"]
        got = sm.fused_sample(logits, noise, *args)
        want = sm.fused_sample_plain(logits, noise, *args)
        torch.cuda.synchronize()
        check(sm.launches["fused_sample"] == before + 1,
              f"fused_sample B={logits.shape[0]} V={logits.shape[1]} did "
              "not launch")
        check(torch.equal(got, want),
              f"fused_sample B={logits.shape[0]} V={logits.shape[1]} "
              f"differs from plain: {got.tolist()} vs {want.tolist()}")
        held += 1
        return got

    rows = sampler_rows()
    for V in (32000, 128256, SAMPLER_BIG_V):
        names, *arrays = rows.adversarial_rows(V, seed=SEED + 7)
        pick = (list(range(len(names))) if V != SAMPLER_BIG_V else
                [names.index("ties_straddle_k_top_p"),
                 names.index("masked_tail_top_p")])
        x, temp, top_k, top_p = (torch.from_numpy(a[pick]).to(device)
                                 for a in arrays)
        R = len(pick)
        for draw in range(2):
            noise = sm.gumbel_noise(list(range(R)), [draw] * R, V,
                                    device=device)
            hold(x, noise, temp, top_k, top_p)
            if V != SAMPLER_BIG_V:
                for r in range(R):
                    hold(x[r:r + 1], noise[r:r + 1], temp[r:r + 1],
                         top_k[r:r + 1], top_p[r:r + 1])
        print(f"fused_sample adversarial rows V={V} "
              f"({', '.join(names[i] for i in pick)}): token-identical "
              f"over 2 noise draws, B={R}" + (" and each row alone"
                                              if V != SAMPLER_BIG_V else
                                              " (slices in device memory)"),
              flush=True)
        del x, noise
    torch.cuda.empty_cache()

    logits, temp, top_k, top_p = sampler_inputs(device)
    B, V = logits.shape
    for seed in range(4):
        noise = sm.gumbel_noise(list(range(B)), [seed] * B, V,
                                device=device)
        got = hold(logits, noise, temp, top_k, top_p)
        hold(logits[4:5], noise[4:5], temp[4:5], top_k[4:5], top_p[4:5])
    print(f"fused_sample B={B} V={V}: token-identical over 4 noise draws "
          f"({got.tolist()}), and its row 4 alone", flush=True)
    big, _, _, _ = sampler_inputs(device, V=128256, seed=SEED + 1)
    for seed in range(2):
        noise_big = sm.gumbel_noise(list(range(B)), [seed] * B, 128256,
                                    device=device)
        got_big = hold(big, noise_big, temp, top_k, top_p)
    big_ms = time_ms(lambda: sm.fused_sample(big, noise_big, temp, top_k,
                                             top_p))
    big_bytes, big_ops = sampler_bytes_ops(big, temp, top_k, top_p)
    print(f"fused_sample B={B} V=128256 (row on chip, 64 KB a CTA): "
          f"token-identical over 2 noise draws ({got_big.tolist()}); "
          f"kernel_ms={big_ms:.4f} bound_ms="
          f"{max(big_bytes / HBM_BYTES_PER_S, big_ops / F32_FLOPS) * 1e3:.4f}",
          flush=True)
    del big, noise_big
    one = [a[4:5].contiguous() for a in (logits, noise, temp, top_k, top_p)]
    one_ms = time_ms(lambda: sm.fused_sample(*one))
    kernel_ms = time_ms(lambda: sm.fused_sample(logits, noise, temp, top_k,
                                                top_p))
    plain_ms = time_ms(lambda: sm.fused_sample_plain(logits, noise, temp,
                                                     top_k, top_p))
    nbytes, flops = sampler_bytes_ops(logits, temp, top_k, top_p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    print(f"fused_sample: {held} calls token-identical; kernel_ms="
          f"{kernel_ms:.4f} (B=1: {one_ms:.4f}) plain_ms={plain_ms:.4f} "
          f"bound_ms={max(t_bytes, t_ops):.4f} ({nbytes} B, {flops} "
          "operations)", flush=True)
    return {"name": "fused_sample", "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/fused_sample.cu",
            "replaces": "kubeflow_tpu/ops/sampling.py:77",
            "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def flash_inputs(B, S, H, D, dtype, device, seed, masked):
    """q, k, v and a cotangent; with ``masked``, kv_len holds a zero row
    and ragged ones (one ragged row at B = 1), and the cotangent is zero
    at padded q rows, as the masked LM loss weights make it."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, g = (torch.randn((B, S, H, D), generator=gen).to(device, dtype)
                  for _ in range(4))
    lens = None
    if masked:
        lens = torch.tensor([0] + [S - 77] * (B - 1) if B > 1 else [S - 77],
                            dtype=torch.int32, device=device)
        live = torch.arange(S, device=device)[None, :] < lens[:, None]
        g = g * live[:, :, None, None].to(dtype)
    return q, k, v, g, lens


def flash_kernels(q, k, v, g, *, causal, kv_len):
    """(out, lse, dq, dk, dv, delta) through the forward and backward
    wrappers; delta is the autograd function's plain op."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    kw = dict(causal=causal, kv_len=kv_len)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(g, out)
    dq, dk, dv = fa.flash_bwd(q, k, v, g, lse, delta, **kw)
    return out, lse, dq, dk, dv, delta


def flash_launches(q) -> dict:
    """The flash launches one forward and one backward at q's dtype and
    head dim count: the fused backward at bf16 and D <= 64, else the dQ
    and dK/dV kernels."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    bwd = (("flash_bwd",) if fa.fused_backward(q)
           else ("flash_bwd_dq", "flash_bwd_dkv"))
    return {n: int(n == "flash_fwd" or n in bwd) for n in fa.launches}


def check_flash_launched(before: dict, q, label: str) -> None:
    """One forward and one backward launched since ``before``."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    want = {n: before[n] + k for n, k in flash_launches(q).items()}
    check(fa.launches == want, f"flash {label}: launches {fa.launches}, "
                               f"expected {want}")


def over_heads(fn, q, k, v, g, lse, delta, step):
    """``fn`` on ``step`` heads at a time, its outputs joined on the head
    dim: the plain versions hold (B, H, S, S) f32 scores, which at S=8192
    and 16 heads would take ~35 GB."""
    import torch

    parts = []
    for h in range(0, q.shape[2], step):
        sl = slice(h, h + step)
        parts.append(fn(q[:, :, sl], k[:, :, sl], v[:, :, sl], g[:, :, sl],
                        lse[:, sl], delta[:, sl]))
    return tuple(torch.cat(ts, dim=1 if ts[0].dim() == 3 else 2)
                 for ts in zip(*parts))


def flash_plain(causal, kv_len):
    """The plain versions on the same inputs as the kernels: the
    backward passes read the kernel forward's lse and delta, so each
    kernel is held to its own plain version alone."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    kw = dict(causal=causal, kv_len=kv_len)

    def fn(q, k, v, g, lse, delta):
        return (*fa.flash_fwd_plain(q, k, v, **kw),
                fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
                *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    return fn


def flash_faults(causal, kv_len):
    """The plain arithmetic with one bf16 fault in each output, which
    the bf16 limit must reject: out with P left unrounded before P·V; dq
    and dk from dS rounded to bf16; dv from P rounded to bf16 before
    Pᵀ·dO."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16

    def fn(q, k, v, g, lse, delta):
        scale = q.shape[-1] ** -0.5
        out = fa.flash_fwd_plain(q.float(), k.float(), v.float(),
                                 causal=causal, kv_len=kv_len)[0].to(bf)
        p, ds = fa._grad_parts(q, k, v, g, lse, delta, causal, scale,
                               kv_len)
        ds = ds.to(bf).float()
        dq = (torch.einsum("bhst,bthd->bshd", ds, k.float()) * scale)
        dk = torch.einsum("bhst,bshd->bthd", ds, q.float() * scale)
        dv = torch.einsum("bhst,bshd->bthd", p.to(bf).float(), g.float())
        return out, dq.to(bf), dk.to(bf), dv.to(bf)
    return fn


def norm_err(a, b) -> float:
    """||a - b|| / ||b|| over the whole tensor, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# bf16 outputs: norm-relative error limit, between the kernels' own
# reading against their plain versions and the faults of flash_faults
# (PERF.md, Findings, gives both readings)
FLASH_BF16_NORM_LIMIT = 4e-4


def compare_flash(B, S, H, D, dtype, device, seed, *, causal, masked,
                  step=16):
    """Hold the three kernels against their plain versions on one case;
    returns ({name: max abs err}, kernel inputs and outputs)."""
    import torch

    q, k, v, g, lens = flash_inputs(B, S, H, D, dtype, device, seed, masked)
    got = flash_kernels(q, k, v, g, causal=causal, kv_len=lens)
    lse, delta = got[1], got[5]
    want = over_heads(flash_plain(causal, lens), q, k, v, g, lse, delta,
                      step)
    lens_txt = (lens.tolist() if B <= 2 else f"[0,{S - 77},...]") if masked \
        else None
    label = (f"B={B} H={H} S={S} D={D} {str(dtype)[6:]} causal={causal} "
             f"kv_len={lens_txt}")
    want = dict(zip(("out", "lse", "dq", "dk", "dv"), want))
    errs, parts = {}, []
    for (name, b), a in zip(want.items(), got):
        check(bool(torch.isfinite(a.float()).all()),
              f"flash {label}: non-finite {name}")
        err = (a.float() - b.float()).abs().max().item()
        errs[name] = err
        # lse is f32 from f32 sums in both dtypes (and -1e30 on a
        # zero-length row, which a relative bound would swallow)
        if dtype == torch.float32 or name == "lse":
            tol = 1e-5 if name in ("out", "lse") else 1e-4
            check(err <= tol, f"flash {label}: {name} max abs err {err} "
                              f"> {tol}")
            parts.append(f"{name} {err:.2e}/{tol:.0e}")
        else:
            rel = norm_err(a, b)
            check(rel <= FLASH_BF16_NORM_LIMIT,
                  f"flash {label}: {name} norm err {rel} > "
                  f"{FLASH_BF16_NORM_LIMIT}")
            parts.append(f"{name} max {err:.2e} norm {rel:.2e}/"
                         f"{FLASH_BF16_NORM_LIMIT:.0e}")
    print(f"flash {label}: " + " ".join(parts), flush=True)
    if dtype == torch.bfloat16:
        faults = over_heads(flash_faults(causal, lens), q, k, v, g, lse,
                            delta, step)
        readings = []
        for name, bad in zip(("out", "dq", "dk", "dv"), faults):
            rel = norm_err(bad, want[name])
            check(rel > FLASH_BF16_NORM_LIMIT,
                  f"flash {label}: the {name} fault passes the bf16 "
                  f"limit ({rel})")
            readings.append(f"{name} {rel:.2e}")
        print("  faults rejected: " + " ".join(readings), flush=True)
        del faults
    return errs, (q, k, v, g, lse, delta)


def flash_bytes_ops(B, S, H, D, el, causal):
    """Bytes each pass must move and flops it must do at (B, S, H, D):
    inputs read once, outputs written once; flops over the live (q, key)
    pairs, S(S+1)/2 causal (4 D each forward, 6 D dQ, 8 D dK/dV, and 10 D
    dQ, dK and dV together). The fused kernel's f32 dQ workspace is how
    that kernel is built, not work the function needs, so it is not
    counted: :func:`flash_workspace_bytes` gives its traffic."""
    n = B * S * H * D * el
    stats = B * H * S * 4                      # lse or delta, f32
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return {"flash_fwd": (3 * n + n + stats, 4 * pairs * D),
            "flash_bwd": (4 * n + 2 * stats + 3 * n, 10 * pairs * D),
            "flash_bwd_dq": (4 * n + 2 * stats + n, 6 * pairs * D),
            "flash_bwd_dkv": (4 * n + 2 * stats + 2 * n, 8 * pairs * D)}


def flash_workspace_bytes(B, S, H, D):
    """Bytes of the fused backward's f32 dQ workspace, (B, S, H, D), and
    the least traffic it adds: written once by the adds and read once by
    the rounding pass. Reported beside the bound, never in it."""
    size = B * S * H * D * 4
    return size, 2 * size


# the bf16 D = 64 forward's ms at phase 17's inference shapes (B, S) under
# its mma.sync design, on an NVIDIA H100 80GB HBM3 at 700 W: the readings
# the wgmma design is printed beside
FLASH_FWD_MMA_MS = {(1, 128): 0.0098, (8, 512): 0.0483}

# the bf16 D = 64 forward's ms at phase 17's inference shapes under its
# first wgmma design (128 rows a block, 64-key stages, two blocks an SM),
# on an NVIDIA H100 80GB HBM3 at 700 W
FLASH_FWD_WGMMA1_MS = {(1, 128): 0.0109, (8, 512): 0.0416}

# the CUDA kernel each flash wrapper launches for bf16 at D = 64 (the LM,
# BERT, ViT and MoE LM paths): the forward, and the backward in one pass
FLASH_D64_KERNELS = {"flash_fwd": "flash_fwd_wgmma_kernel",
                     "flash_bwd": "flash_bwd_wgmma_kernel"}
# their builds (ptxas variants: D, then the forward's consumer
# warpgroups, 1 for 64 q rows an item, 3 for 192)
FLASH_D64_VARIANTS = {("flash_fwd_wgmma_kernel", "Li64ELi1E"),
                      ("flash_fwd_wgmma_kernel", "Li64ELi3E"),
                      ("flash_bwd_wgmma_kernel", "Li64E")}
# the bf16 D = 64 forward's timed shapes (B, S, H): the LM step, BERT-base,
# :predict's two; phase 2 holds each causal and not, with kv_len, at the
# rows a block its shape class resolves
FWD_TIMED_SHAPES = ((2, 8192, 16), (16, 512, 12), (8, 512, 12),
                    (1, 128, 12))
# the kernels line's records in order: the paged and sampler kernels
# (serving), the flash forward and backward, the bnconv forward and dW
SERVING_RECORDS, FLASH_RECORDS, BNCONV_RECORDS = (slice(0, 2), slice(2, 4),
                                                  slice(4, None))
# the TPU kernel bodies each replaces (kubeflow_tpu/ops/attention.py)
FLASH_REPLACES = {"flash_fwd": "kubeflow_tpu/ops/attention.py:188",
                  "flash_bwd": "kubeflow_tpu/ops/attention.py:369"}
FLASH_ALSO_REPLACES = {"flash_bwd": "kubeflow_tpu/ops/attention.py:422"}


def sdpa_yardstick(q, k, v, g, *, causal):
    """PyTorch's fused attention on the kernels' inputs, timed as a
    yardstick only: ``{"flash_fwd": (ms, backend), "backward": (ms,
    backend)}``, the fastest forward and backward among the backends
    that take the inputs, each pinned in turn (``sdpa_kernel``: flash,
    memory-efficient, cuDNN) and printed. q, k and v are read as
    (B, H, S, D) views; the cotangent is made contiguous in that layout,
    as a model's own would be. The backward is one call for dq, dk and
    dv, and rounds P and dS to bf16, which ``flash_faults`` refuses for
    the port's kernels."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    g_lib = g.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                o_lib = sdpa(qt, kt, vt, is_causal=causal)
                fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
                bwd = time_ms(lambda: torch.autograd.grad(
                    o_lib, (qt, kt, vt), g_lib, retain_graph=True))
        except RuntimeError as e:
            print(f"  sdpa {backend.name}: not taken ({str(e)[:80]})",
                  flush=True)
            continue
        finally:
            o_lib = None
        times[backend.name] = (fwd, bwd)
        print(f"  sdpa {backend.name}: forward {fwd:.4f} ms, backward "
              f"{bwd:.4f} ms", flush=True)
    del qt, kt, vt, g_lib
    torch.cuda.empty_cache()
    check(bool(times), "no pinned scaled_dot_product_attention backend "
                       "took the inputs")
    best = {}
    for i, key in enumerate(("flash_fwd", "backward")):
        name = min(times, key=lambda n: times[n][i])
        best[key] = (times[name][i], name)
    return best


def ptxas_kernels(log: str,
                  pattern: str = r"(flash_[a-z_]+_kernel)I(\w*?Li\d+E)E"
                  ) -> dict:
    """``{key: (registers, spill stores, spill loads)}`` from nvcc's
    ``-Xptxas -v`` lines, for the entry points whose mangled names match
    ``pattern``; the key is its group, or the tuple of its groups. By
    default the flash kernels, keyed (kernel, variant): variant is the
    mangled template arguments (``Li64E`` for the bf16 mma kernels at
    D = 64, ``fLi64E`` for the f32 FMA kernels)."""
    import re

    out, entry, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?" + pattern, line)
        if m:
            entry = m.groups() if len(m.groups()) > 1 else m.group(1)
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), *spills)
            entry = None
    return out


def check_flash_kernels(device, *, B=2, H=16, D=64, S_main=8192, step=4,
                        build_log=""):
    """The flash forward and backward against their plain versions:
    causal and not, with and without kv_len, f32 and bf16, at S=2048 and
    a ragged 1000, then the training path's own case (bf16, causal,
    S_main) with the plain versions run ``step`` heads at a time, and the
    LM entry point's (``LM_FLASH_SHAPE``, bf16, causal). Then each is
    timed there beside the bound, its plain version and PyTorch's fused
    attention (timed only). ``build_log`` is nvcc's output for
    ``flash_attention.cu``: each kernel's registers and spills are
    printed, and the bf16 tensor-core kernels at D = 64 (the training
    path's: the forward at both of its tiles and the fused backward)
    must not spill. The forward and the backward are also held at
    ``FWD_TIMED_SHAPES`` (the LM's, BERT's and ``LM_FLASH_SHAPE`` among
    them), causal and not, with kv_len."""
    import torch

    from kubeflow_tpu_torch.ops import autotune
    from kubeflow_tpu_torch.ops import flash_attention as fa

    regs = ptxas_kernels(build_log)
    for (name, variant), (n_regs, st, ld) in sorted(regs.items()):
        print(f"  ptxas {name}<{variant}>: {n_regs} registers, spill "
              f"stores {st} B, spill loads {ld} B", flush=True)
        if "mma" in name and variant.startswith("Li64E"):
            check(st == 0 and ld == 0,
                  f"{name}<{variant}> spills ({st} B stored, {ld} B "
                  "loaded)")
    if build_log:
        # the kernels the D = 64 paths run: a kernel never compiled must
        # not pass by its absence
        missing = FLASH_D64_VARIANTS - set(regs)
        check(not missing, f"no ptxas lines at D=64 for {sorted(missing)} "
                           "in the build log")
        # ptxas serializes every wgmma of a kernel it cannot prove safe
        # to pipeline, and says so only in an info line (~1.2x slower)
        serialized = [line.strip() for line in build_log.splitlines()
                      if any(f"C751{k}" in line for k in (3, 4, 5, 8))
                      or "instructions are serialized" in line]
        check(not serialized, "ptxas serialized wgmma in flash_attention: "
                              + " | ".join(serialized))
        print("  ptxas: no wgmma serialization note", flush=True)
    else:
        print("  ptxas: flash_attention was built before this run (no "
              "compiler log)", flush=True)

    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    owner = {"out": "flash_fwd", "lse": "flash_fwd", "dq": "flash_bwd",
             "dk": "flash_bwd", "dv": "flash_bwd"}
    cases = [(S, dtype, causal, masked)
             for S in (2048, 1000)
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (True, False) for masked in (False, True)]
    cases.append((S_main, torch.bfloat16, True, False))
    for seed, (S, dtype, causal, masked) in enumerate(cases, SEED + 1):
        before = dict(fa.launches)
        errs, main = compare_flash(B, S, H, D, dtype, device, seed,
                                   causal=causal, masked=masked,
                                   step=step if S == S_main else H)
        check_flash_launched(before, main[0], f"S={S} {dtype}")
        if dtype == torch.bfloat16:     # f32 runs the FMA kernels
            for name, err in errs.items():
                worst[owner[name]] = max(worst[owner[name]], err)
        torch.cuda.empty_cache()
    # the LM entry point's own shape (phases 14 and 21): bf16, causal
    errs, _ = compare_flash(*LM_FLASH_SHAPE, torch.bfloat16, device,
                            SEED + 29, causal=True, masked=False)
    for name, err in errs.items():
        worst[owner[name]] = max(worst[owner[name]], err)
    # the forward's timed shapes, causal and not, with kv_len, each at the
    # rows an item its grid takes on this card (a short grid takes 64)
    for seed, ((b, s, h), causal) in enumerate(
            [(shape, c) for shape in FWD_TIMED_SHAPES
             for c in (True, False)], SEED + 50):
        tile = autotune.flash_tile("flash_fwd", D, torch.bfloat16,
                                   batch_heads=b * h, seq=s,
                                   sms=autotune.sm_count(device))
        check(tile in autotune.flash_tiles("flash_fwd", D, torch.bfloat16),
              f"flash_fwd ({b}, {s}, {h}) resolved the tile {tile}")
        print(f"flash_fwd ({b}, {s}, {h}) causal={causal}: {tile[0]} q rows "
              f"an item", flush=True)
        before = dict(fa.launches)
        errs, case = compare_flash(b, s, h, D, torch.bfloat16, device, seed,
                                   causal=causal, masked=True,
                                   step=step if s == S_main else h)
        check_flash_launched(before, case[0], f"({b}, {s}, {h})")
        for name, err in errs.items():
            worst[owner[name]] = max(worst[owner[name]], err)
        del case
        torch.cuda.empty_cache()
    # head dims the kernels are not built for (zero-padded to 64 or 128)
    for seed, d_pad in enumerate((32, 80, 96), SEED + 30):
        before = dict(fa.launches)
        _, case = compare_flash(B, 1000, 4, d_pad, torch.bfloat16, device,
                                seed, causal=True, masked=True)
        check_flash_launched(before, case[0], f"D={d_pad}")
    # D = 256 (its own build, the FMA kernels) and, past it, the wide
    # kernels: D = 320 and 512, f32 and bf16, at S = 1000 with kv_len;
    # then 256 and 512 in bf16 at B=2, H=16, S=2048, causal, timed
    for seed, (d_wide, dtype) in enumerate(
            [(d, t) for d in (320, 512)
             for t in (torch.float32, torch.bfloat16)], SEED + 34):
        before = dict(fa.launches)
        _, case = compare_flash(B, 1000, 4, d_wide, dtype, device, seed,
                                causal=True, masked=True)
        check_flash_launched(before, case[0], f"D={d_wide} {dtype}")
    wide_ms = {}
    for seed, d_wide in ((SEED + 33, 256), (SEED + 38, 512)):
        before = dict(fa.launches)
        _, wide = compare_flash(B, 2048, H, d_wide, torch.bfloat16, device,
                                seed, causal=True, masked=False, step=4)
        check_flash_launched(before, wide[0], f"D={d_wide}")
        wq, wk, wv, wg, wlse, wdelta = wide
        wide_ms[d_wide] = {
            "flash_fwd": time_ms(lambda: fa.flash_fwd(wq, wk, wv)),
            "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
                wq, wk, wv, wg, wlse, wdelta)),
            "flash_bwd_dkv": time_ms(lambda: fa.flash_bwd_dkv(
                wq, wk, wv, wg, wlse, wdelta))}
        work = flash_bytes_ops(B, 2048, H, d_wide, 2, True)
        kind = "FMA kernel" if d_wide == 256 else "wide FMA kernel"
        for name, t in wide_ms[d_wide].items():
            nbytes, flops = work[name]
            bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            print(f"{name} bf16 causal B={B} H={H} S=2048 D={d_wide} "
                  f"({kind}): kernel_ms={t:.4f} "
                  f"({flops / t / 1e9:.1f} TFLOP/s) bound_ms={bound:.4f} "
                  f"(f32 FMA bound {flops / F32_FLOPS * 1e3:.4f})",
                  flush=True)
        del wide, wq, wk, wv, wg, wlse, wdelta
        torch.cuda.empty_cache()
    # the training path's case (the last of ``cases``): dQ's partials
    # land in a fixed order and dK, dV are owned by one block, so a repeat
    # call is bit-identical in all three; then timing
    q, k, v, g, lse, delta = main
    first = fa.flash_bwd(q, k, v, g, lse, delta)
    for name, a, b in zip(("dq", "dk", "dv"), first,
                          fa.flash_bwd(q, k, v, g, lse, delta)):
        check(torch.equal(a, b), f"flash_bwd: a repeat call's {name} "
                                 "differs")
    del first
    ms = {"flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v)),
          "flash_bwd": time_ms(lambda: fa.flash_bwd(
              q, k, v, g, lse, delta))}
    # PyTorch's fused attention on the same inputs, as a yardstick only
    lib = sdpa_yardstick(q, k, v, g, causal=True)
    lib["flash_bwd"] = lib["backward"]
    library = {name: lib[name][0] for name in ms}

    def plain_fn(fn):
        return lambda: over_heads(fn, q, k, v, g, lse, delta, step)
    plain = {
        "flash_fwd": plain_fn(lambda q, k, v, g, lse, delta:
                              fa.flash_fwd_plain(q, k, v)),
        "flash_bwd": plain_fn(lambda q, k, v, g, lse, delta: (
            fa.flash_bwd_dq_plain(q, k, v, g, lse, delta),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta)))}
    plain = {name: time_ms(fn, iters=5, warmup=1)
             for name, fn in plain.items()}
    work = flash_bytes_ops(B, S_main, H, D, 2, True)
    records = []
    lib_call = {"flash_fwd": "forward", "flash_bwd": "backward, dq+dk+dv"}
    for name in ("flash_fwd", "flash_bwd"):
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        print(f"{name} bf16 causal B={B} H={H} S={S_main} D={D}: "
              f"kernel_ms={ms[name]:.4f} "
              f"({flops / ms[name] / 1e9:.1f} TFLOP/s) "
              f"bound_ms={max(t_bytes, t_ops):.4f} "
              f"(bf16 tensor cores; f32 FMA bound "
              f"{flops / F32_FLOPS * 1e3:.4f}) "
              f"plain_ms={plain[name]:.4f} ({step} heads per call) "
              f"library_ms={library[name]:.4f} (scaled_dot_product_"
              f"attention {lib_call[name]}, {lib[name][1]} backend, dO "
              f"contiguous) [{FLASH_D64_KERNELS[name]}]", flush=True)
        if name == "flash_bwd":
            size, traffic = flash_workspace_bytes(B, S_main, H, D)
            print(f"flash_bwd dQ workspace (not in the bound): {size} bytes "
                  f"f32, {traffic} bytes written and read "
                  f"({traffic / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
                  f"memory rate)", flush=True)
        records.append({
            "name": name, "kernel": FLASH_D64_KERNELS[name],
            "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "max_abs_err": worst[name], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[name], "library_backend": lib[name][1],
            **({"also_replaces": FLASH_ALSO_REPLACES[name]}
               if name in FLASH_ALSO_REPLACES else {})})
    return records


# the ResNet-50 sites of the fused BN + ReLU + 1x1 conv at batch 256:
# (M = pixels, K, N, blocks in the stage); M*K*N is the same at each
RESNET50_SITES = ((802816, 64, 256, 3), (200704, 128, 512, 4),
                  (50176, 256, 1024, 6), (12544, 512, 2048, 3))
# norm-relative limits: bf16 outputs between the kernels' own reading
# against their plain versions (f32 sums in another order, which can
# move an output across a bf16 rounding) and the faults of
# bnconv_faults; f32 outputs differ by summation order only (PERF.md,
# Findings, gives the readings)
BNCONV_BF16_LIMIT = 4e-4
BNCONV_F32_LIMIT = 1e-5


def bnconv_inputs(M, K, N, dtype, device, seed):
    """x, a, b, w and a cotangent dz: a and b as a trained BN leaves
    them (scales near one, shifts that zero ~40% of y), w at 1x1-conv
    init scale."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((M, K), generator=gen).to(device, dtype)
    a = (0.5 + torch.rand((K,), generator=gen)).to(device)
    b = (0.3 * torch.randn((K,), generator=gen) - 0.1).to(device)
    w = (torch.randn((K, N), generator=gen) * K ** -0.5).to(device, dtype)
    dz = torch.randn((M, N), generator=gen).to(device, dtype)
    return x, a, b, w, dz


def bnconv_faults(x, a, b, w, dz, act_dtype):
    """The plain arithmetic with one bf16 fault in each output, which
    the bf16 limit must reject: out and dW from y left unrounded (f32
    products of the unrounded activation); dx from dy rounded to bf16
    before the mask, as autodiff through the unfused ops rounds it."""
    import torch

    del act_dtype   # the fault skips its rounding
    xhat = x.float() * a + b
    y32 = torch.clamp_min(xhat, 0.0)
    out = (y32 @ w.float()).to(x.dtype)
    dw = (y32.t() @ dz.float()).to(w.dtype)
    dy = (dz.float() @ w.float().t()).to(x.dtype).float()
    dx = (torch.where(xhat > 0, dy, 0.0) * a).to(x.dtype)
    return out, dw, dx


def compare_bnconv(M, K, N, dtype, device, seed, act_dtype=None):
    """Hold both kernels, and the autograd function's four gradients
    (kernel forward and dW) against their plain versions on one case;
    returns ({kernel: max abs err}, the inputs)."""
    import torch

    from kubeflow_tpu_torch.ops import bnconv as bc

    x, a, b, w, dz = bnconv_inputs(M, K, N, dtype, device, seed)
    ins = [t.clone().requires_grad_(True) for t in (x, a, b, w)]
    out = bc.fused_scale_relu_matmul(*ins, act_dtype)
    grads = torch.autograd.grad(out, ins, dz)
    got = {"out": out.detach(), "dx": grads[0], "da": grads[1],
           "db": grads[2], "dw": grads[3],
           "dw_f32": bc.bnconv_dw(x, a, b, dz, act_dtype)}
    want = dict(zip(("dx", "da", "db", "dw"), bc.fused_vjp(
        x, a, b, w, dz, act_dtype, dw_fn=bc.bnconv_dw_plain)))
    want["out"] = bc.bnconv_fwd_plain(x, a, b, w, act_dtype)
    want["dw_f32"] = bc.bnconv_dw_plain(x, a, b, dz, act_dtype)
    torch.cuda.synchronize()
    act = "" if act_dtype is None else f" act {str(act_dtype)[6:]}"
    label = f"({M}, {K}, {N}) {str(dtype)[6:]}{act}"
    errs, parts = {"bnconv_fwd": 0.0, "bnconv_dw": 0.0}, []
    for name, got_t in got.items():
        check(bool(torch.isfinite(got_t.float()).all()),
              f"bnconv {label}: non-finite {name}")
        err = (got_t.float() - want[name].float()).abs().max().item()
        owner = "bnconv_fwd" if name == "out" else "bnconv_dw"
        errs[owner] = max(errs[owner], err)
        limit = (BNCONV_BF16_LIMIT if got_t.dtype == torch.bfloat16
                 else BNCONV_F32_LIMIT)
        rel = norm_err(got_t, want[name])
        check(rel <= limit, f"bnconv {label}: {name} norm err {rel} > "
                            f"{limit}")
        parts.append(f"{name} {rel:.2e}")
    if dtype == torch.bfloat16:
        # each output tile is owned by one block and dW's splits fold in
        # split order: repeat calls are bit-identical
        check(torch.equal(bc.bnconv_fwd(x, a, b, w, act_dtype), got["out"])
              and torch.equal(bc.bnconv_dw(x, a, b, dz, act_dtype),
                              got["dw_f32"]),
              f"bnconv {label}: a repeat call differs")
        parts.append("repeat bit-identical")
    print(f"bnconv {label}: norm errs {' '.join(parts)} (limits bf16 "
          f"{BNCONV_BF16_LIMIT:.0e}, f32 {BNCONV_F32_LIMIT:.0e})",
          flush=True)
    if dtype == torch.bfloat16 or act_dtype == torch.bfloat16:
        readings = []
        for name, bad in zip(("out", "dw", "dx"),
                             bnconv_faults(x, a, b, w, dz, act_dtype)):
            if name == "dx" and dtype != torch.bfloat16:
                continue        # an f32 dy has no bf16 rounding to skip
            limit = (BNCONV_BF16_LIMIT if bad.dtype == torch.bfloat16
                     else BNCONV_F32_LIMIT)
            rel = norm_err(bad, want[name])
            check(rel > limit, f"bnconv {label}: the {name} fault passes "
                               f"the limit ({rel} <= {limit})")
            readings.append(f"{name} {rel:.2e}")
        print("  faults rejected: " + " ".join(readings), flush=True)
    return errs, (x, a, b, w, dz)


def bnconv_bytes_ops(M, K, N, el):
    """Bytes each kernel must move and flops it must do at one site:
    x, the (K,) a and b, w or dz read once, out or dW written once."""
    x, ab = M * K * el, 2 * K * 4
    return {"bnconv_fwd": (x + ab + K * N * el + M * N * el, 2 * M * K * N),
            "bnconv_dw": (x + ab + M * N * el + K * N * el, 2 * M * K * N)}


def check_bnconv_kernels(device, build_log=""):
    """Both bnconv kernels against their plain versions at the four
    ResNet-50 sites (bf16, as the path runs them, and f32), a ragged
    shape (f32 with a bf16 activation too), then each timed at every
    site beside its bound, its plain version and a bare bf16
    ``torch.matmul`` of a precomputed y (for scale: no PyTorch call
    computes either function). Per-step figures sum the 16 sites.
    ``build_log`` is nvcc's output for ``bnconv.cu``: the bf16 wgmma
    kernels' registers and spills are printed, and a spill fails."""
    import torch

    from kubeflow_tpu_torch.ops import bnconv as bc

    wgmma = ("bnconv_fwd_wgmma_kernel", "bnconv_dw_wgmma_kernel")
    if build_log:
        regs = ptxas_kernels(build_log, r"(bnconv_(?:fwd|dw)_wgmma_kernel)")
        check(set(regs) == set(wgmma),
              f"no ptxas lines for {sorted(set(wgmma) - set(regs))}")
        for name, (n_regs, st, ld) in sorted(regs.items()):
            print(f"  ptxas {name}: {n_regs} registers, spill stores {st} "
                  f"B, spill loads {ld} B", flush=True)
            check(st == 0 and ld == 0,
                  f"{name} spills ({st} B stored, {ld} B loaded)")
    else:
        print("  ptxas: bnconv was built before this run (no compiler log)",
              flush=True)

    bf, f32 = torch.bfloat16, torch.float32
    worst = {"bnconv_fwd": 0.0, "bnconv_dw": 0.0}
    cases = [(M, K, N, dt, None) for M, K, N, _ in RESNET50_SITES
             for dt in (bf, f32)]
    cases += [(1000, 72, 200, bf, None), (1000, 72, 200, f32, None),
              (1000, 72, 200, f32, bf), (77, 20, 40, bf, None)]
    for seed, (M, K, N, dt, act) in enumerate(cases, SEED + 40):
        errs, _ = compare_bnconv(M, K, N, dt, device, seed, act)
        for name, err in errs.items():
            worst[name] = max(worst[name], err)
        torch.cuda.empty_cache()
    per_step = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                           ops_ms=0.0, matmul_ms=0.0)
                for name in worst}
    for M, K, N, blocks in RESNET50_SITES:
        x, a, b, w, dz = bnconv_inputs(M, K, N, bf, device, SEED + 60)
        y = bc.activation(x, a, b)
        fns = {"bnconv_fwd": (lambda: bc.bnconv_fwd(x, a, b, w),
                              lambda: bc.bnconv_fwd_plain(x, a, b, w),
                              lambda: torch.matmul(y, w)),
               "bnconv_dw": (lambda: bc.bnconv_dw(x, a, b, dz, None, bf),
                             lambda: bc.bnconv_dw_plain(x, a, b, dz, None,
                                                        bf),
                             lambda: torch.matmul(y.t(), dz))}
        work = bnconv_bytes_ops(M, K, N, 2)
        for name, (kernel, plain, matmul) in fns.items():
            ms, plain_ms = time_ms(kernel), time_ms(plain, iters=5)
            matmul_ms = time_ms(matmul)
            nbytes, flops = work[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            print(f"{name} bf16 ({M}, {K}, {N}): kernel_ms={ms:.4f} "
                  f"bound_ms={max(t_bytes, t_ops):.4f} ({nbytes} B, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{nbytes / ms / 1e9:.2f} TB/s) plain_ms={plain_ms:.4f} "
                  f"bf16 matmul of y alone {matmul_ms:.4f}", flush=True)
            acc = per_step[name]
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", max(t_bytes, t_ops)),
                             ("bytes_ms", t_bytes), ("ops_ms", t_ops),
                             ("matmul_ms", matmul_ms)):
                acc[key] += blocks * val
        del x, a, b, w, dz, y
        torch.cuda.empty_cache()
    records = []
    for name, line in (("bnconv_fwd", 79), ("bnconv_dw", 100)):
        acc = per_step[name]
        print(f"{name} per step (16 sites): kernel_ms={acc['ms']:.4f} "
              f"bound_ms={acc['bound_ms']:.4f} plain_ms="
              f"{acc['plain_ms']:.4f} bf16 matmul of y alone "
              f"{acc['matmul_ms']:.4f}", flush=True)
        records.append({
            "name": name, "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/bnconv.cu",
            "replaces": f"kubeflow_tpu/ops/bnconv.py:{line}",
            "max_abs_err": worst[name], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_ms"] >= acc["ops_ms"]
                         else "operations"),
            "library_ms": None})
    return records


# -- phase 3: serving end to end --------------------------------------------


def write_export(base: str, cfg) -> None:
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.serving.model_store import (
        export_model,
        transformer_export_config,
    )

    params = convert.random_params(cfg, SEED)
    export_model(os.path.join(base, "lm"), "transformer", params,
                 config=transformer_export_config(cfg))


def prompts_for(n, length, vocab, seed=SEED):
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    return [rng.integers(0, vocab, size=length - 7 * i).tolist()
            for i in range(n)]


def _post(url, body, stream):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"HTTP {resp.status}")
        if not stream:
            return json.loads(resp.read()), None
        lines, ttft = [], None
        for raw in resp:
            if ttft is None:
                ttft = time.perf_counter() - t0
            lines.append(json.loads(raw))
        return lines, ttft


def serve_phase(base: str, cfg, device, *, n_requests=8, prompt_len=300,
                max_new=64, decode_mesh=None):
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving.server import ModelServer

    saved = {k: os.environ.get(k) for k in ("KFTPU_PAGED",
                                             "KFTPU_SAMPLER_IMPL")}
    os.environ["KFTPU_PAGED"] = "1"
    os.environ["KFTPU_SAMPLER_IMPL"] = "fused"
    server = ModelServer(base, port=0, decode_slots=8,
                         decode_steps_per_sync=4, device=device,
                         decode_mesh=decode_mesh)
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/lm:generate"
    try:
        # warm-up: engine build, first cuBLAS handles; not counted
        _post(url, {"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 2},
              False)
        led, col = fresh_trace(server.repo.engine_for(
            "lm", server.repo.get("lm")))
        prompts = prompts_for(n_requests, prompt_len, cfg.vocab_size)
        bodies = []
        for i, p in enumerate(prompts):
            body = {"prompt_tokens": [p], "max_new_tokens": max_new,
                    "stream": i % 2 == 1, "seed": 100 + i}
            if i >= n_requests // 2:   # sampled requests
                body.update(temperature=0.8, top_k=[0, 50, 40, 0][i % 4],
                            top_p=[0.9, 1.0, 0.95, 1.0][i % 4])
            bodies.append(body)
        results = [None] * n_requests
        errors = []

        def run(i):
            try:
                results[i] = _post(url, bodies[i], bodies[i]["stream"])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        ops.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(not errors, "; ".join(errors))
        ttfts = []
        for i, (payload, ttft) in enumerate(results):
            if bodies[i]["stream"]:
                rows = [ln["tokens"] for ln in payload if "tokens" in ln]
                check(payload[-1].get("done") is True,
                      f"stream {i} did not finish: {payload[-1]}")
                toks = [r[0] for r in rows]
                ttfts.append(ttft)
            else:
                toks = payload["tokens"][0]
            check(len(toks) == max_new, f"request {i}: {len(toks)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"request {i}: token out of range")
        recs = led.records("lm")
        check(len(recs) == n_requests, f"{len(recs)} ledger records for "
                                       f"{n_requests} requests")
        ledger_records(led, [r.rid for r in recs], max_new)
        check(all(r.chunks >= 1 for r in recs), "a paged record counts no "
                                                "prefill chunk")
        from kubeflow_tpu_torch.obs.trace import DEFAULT_COLLECTOR

        for rec in recs:
            # the handler's span continues into the engine's: one trace
            # a request, the ledger keyed by it
            root = [s for s in DEFAULT_COLLECTOR.trace(rec.rid)
                    if s.name == "serving.generate"]
            spans = {s.name: s for s in col.trace(rec.rid)}
            check(len(root) == 1 and root[0].attrs.get("http.status")
                  == 200, f"record {rec.rid}: serving spans {root}")
            for name in ("engine.queue_wait", "engine.admit",
                         "engine.prefill_chunk", "engine.first_token",
                         "engine.decode"):
                check(name in spans, f"trace {rec.rid}: no {name} "
                                     f"({sorted(spans)})")
            check(spans["engine.queue_wait"].parent_id == root[0].span_id,
                  f"trace {rec.rid}: engine.queue_wait is not a child of "
                  f"serving.generate")
        return {"wall_s": wall,
                "tokens_per_s": n_requests * max_new / wall,
                "ttft_s": ttfts, "launches": launches,
                "ledger_p50_s": ledger_p50(recs),
                "ledger_ttft_ms": sorted(round(r.ttft_ms, 1)
                                         for r in recs)}
    finally:
        server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- phase 4: kernel vs gather greedy parity in f32 -------------------------


def load_f32(base: str, cfg, device, mesh=None):
    """The export's weights in an f32 model, TF32 off: (config, model);
    with ``mesh``, the model built over it."""
    import dataclasses

    import torch
    import yaml

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.serving.model_store import (
        MODEL_FILE,
        read_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vdir = os.path.join(base, "lm", "1")
    with open(os.path.join(vdir, MODEL_FILE)) as f:
        meta = yaml.safe_load(f)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg32, convert.to_module(cfg32, read_params(vdir, meta),
                                    device=device, mesh=mesh)


PARITY_PROMPTS = dict(n=4, length=200, max_new=24)


def parity_prompts(vocab: int):
    return prompts_for(PARITY_PROMPTS["n"], PARITY_PROMPTS["length"], vocab,
                       seed=SEED + 7)


def parity_phase(base: str, cfg, device):
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    max_new = PARITY_PROMPTS["max_new"]
    cfg32, model = load_f32(base, cfg, device)
    prompts = parity_prompts(cfg.vocab_size)
    streams = {}
    for impl in ("kernel", "gather"):
        eng = DecodeEngine(cfg32, model, slots=8, paged=True,
                           paged_attention_impl=impl, autostart=False,
                           device=device)
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        while eng.active_count or eng.pending_count:
            eng.run_once(timeout=0.01)
        streams[impl] = [r.result() for r in reqs]
        eng.close()
        eng._pool.check_idle()
    check(streams["kernel"] == streams["gather"],
          f"f32 kernel vs gather greedy streams differ: "
          f"{streams['kernel']} vs {streams['gather']}")
    del model
    return streams["kernel"]


# -- phase 5: long-context training ------------------------------------------


def train_setup(device):
    """The slice's configuration on ``device``: (config, train state,
    the fixed numpy token batch), as ``bench_longcontext`` builds them."""
    import numpy as np

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import create_train_state, make_optimizer

    cfg = TransformerConfig(**TRAIN, dtype="bfloat16")
    state = create_train_state(
        cfg, convert.random_params(cfg, SEED),
        make_optimizer(3e-4, warmup_steps=5, decay_steps=100),
        device=device)
    tokens = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq_len)).astype(np.int32)
    return cfg, state, tokens


def train_flops(cfg, n_params: int) -> int:
    """Flops of one step, by ``bench_longcontext``'s count (:510-512):
    6·N·tokens plus the causal attention matmuls, remat excluded."""
    S = cfg.max_seq_len
    return (6 * n_params * TRAIN_BATCH * S
            + 6 * cfg.n_layers * TRAIN_BATCH * S * S * cfg.d_model)


def train_phase(device, *, steps=TRAIN_STEPS):
    """The slice's configuration: 4 steps on one fixed numpy batch,
    through the step telemetry (``make_step_telemetry(sync=True)``: the
    card synchronized before each step's end, the first step under the
    FLOP counter, the HBM sampler after each step)."""
    import math

    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.examples.common import make_step_telemetry
    from kubeflow_tpu_torch.train import make_lm_train_step

    t0 = time.perf_counter()
    cfg, state, tokens = train_setup(device)
    S = cfg.max_seq_len
    before = {n: p.detach().clone() for n, p in
              state.module.named_parameters()}
    n_params = sum(p.numel() for p in before.values())
    print(f"train state built: {time.perf_counter() - t0:.1f}s, "
          f"{n_params} params", flush=True)
    telem = make_step_telemetry(tokens_per_step=TRAIN_BATCH * S, sync=True)
    # the telemetry's work after a step's window (its bookkeeping, and
    # on step 1 the FLOP counter's read), timed apart so that each
    # step's own wall splits into window + after + the rest (before the
    # window and the loop)
    after = []
    for hook in ("_read_probe", "_on_step"):
        def timed(*a, _fn=getattr(telem, hook), _hook=hook, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                after.append((_hook, time.perf_counter() - t))
        setattr(telem, hook, timed)
    step = telem.wrap(make_lm_train_step())
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        losses.append(float(m["loss"]))        # syncs the step
        times.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    summary = telem.summary()
    telem_s = [r.duration for r in telem.recorder.records()]
    # the median of steps 2.. (step 1 is the FLOP probe and warms up):
    # the phase's own times also hold the telemetry's bookkeeping and
    # whatever the interpreter does around it (a garbage collection)
    own_med = statistics.median(times[1:])
    telem_med = statistics.median(telem_s[1:])
    split, i = [], 0
    for k in range(steps):
        probe = on_step = 0.0
        while i < len(after):
            hook, t = after[i]
            i += 1
            if hook == "_read_probe":
                probe += t
            else:
                on_step += t
                break
        split.append({"own_ms": times[k] * 1e3,
                         "window_ms": telem_s[k] * 1e3,
                         "probe_read_ms": probe * 1e3,
                         "bookkeeping_ms": on_step * 1e3,
                         "rest_ms": (times[k] - telem_s[k] - probe
                                     - on_step) * 1e3})
    # on a miss, each step's split says where the host time went: inside
    # the telemetry's window, in its probe read or bookkeeping after it,
    # or outside both (the rest)
    check(abs(telem_med - own_med) <= 0.1 * own_med,
          f"train: telemetry median {telem_med * 1e3:.1f} ms vs the "
          f"phase's own {own_med * 1e3:.1f} ms (steps 2..); per step "
          + "; ".join(", ".join(f"{k} {v:.1f}" for k, v in d.items())
                      for d in split))
    check(summary["recompiles"] == 0 and telem.flops_per_step,
          f"train: telemetry {summary}, flops {telem.flops_per_step}")
    hbm = telem.hbm_sampler.beacon_fields()
    check(hbm.get("peakBytes", 0) > 0, f"train: no HBM sample ({hbm})")
    # the fused backward once a layer, and PR 19's pair never
    per_step = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd": cfg.n_layers,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"train: {name} launched {launches[name]} times, expected "
              f"{n * steps} ({n} per step)")
    check(all(math.isfinite(x) for x in losses), f"train: losses {losses}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) <= 1.5,
          f"train: step-1 loss {losses[0]} not within ln(V)={ln_v:.3f}"
          f" +- 1.5")
    check(losses[-1] < losses[0],
          f"train: loss did not fall: {losses}")
    unchanged = [n for n, p in state.module.named_parameters()
                 if torch.equal(p.detach(), before[n])]
    check(not unchanged, f"train: parameters not updated: {unchanged}")
    step_s = sum(times[1:]) / (steps - 1)      # step 1 warms up
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "mean_step_ms": step_s * 1e3,
            "tokens_per_s": TRAIN_BATCH * S / step_s,
            "mfu": train_flops(cfg, n_params) / step_s / BF16_FLOPS,
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "grad_norm": float(m["grad_norm"]),
            "telemetry": dict(summary, own_median_step_s=own_med,
                              median_step_s=telem_med, step_s=telem_s,
                              own_step_s=times, split=split,
                              tokens_per_s=telem._rates()["tokens_per_sec"],
                              flops_per_step=telem.flops_per_step,
                              hbm_peak_gb=hbm["peakBytes"] / 1e9)}


# -- phase 6: flash vs dense training parity in f32 -------------------------


def train_parity_phase(device):
    """One f32 step (TF32 off) with flash and with dense attention from
    the same weights and batch. lr 1e-5 with no warmup: AdamW's first
    update is about lr * sign(g) for every entry, so an entry whose
    gradient sign differs moves 2e-5 apart and fails the 1e-5 check."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import (
        create_train_state,
        make_lm_train_step,
        make_optimizer,
        next_token_loss,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(vocab_size=32000, d_model=256, n_layers=2, n_heads=4,
                n_kv_heads=4, d_ff=1024, max_seq_len=512, dtype="float32",
                remat=True)
    params = convert.random_params(TransformerConfig(**base), SEED + 3)
    tokens = np.random.default_rng(SEED + 4).integers(
        0, 32000, (2, 512)).astype(np.int32)
    res = {}
    for impl in ("flash", "dense"):
        cfg = TransformerConfig(**base, attention_impl=impl)
        state = create_train_state(cfg, params, make_optimizer(
            1e-5, warmup_steps=0), device=device)
        model = state.module
        toks = torch.as_tensor(tokens, device=device)
        grads = torch.autograd.grad(next_token_loss(model(toks), toks),
                                    state.params)
        state, m = make_lm_train_step()(state, tokens)
        res[impl] = (float(m["loss"]), float(m["grad_norm"]), grads,
                     [p.detach() for p in state.params])
    (lf, nf, gf, pf), (ld, nd, gd, pd) = res["flash"], res["dense"]
    g_err = max((a - b).abs().max().item() for a, b in zip(gf, gd))
    p_err = max((a - b).abs().max().item() for a, b in zip(pf, pd))
    check(abs(lf - ld) <= 1e-5, f"parity: loss {lf} vs {ld}")
    check(abs(nf - nd) <= 1e-5 * nd, f"parity: grad_norm {nf} vs {nd}")
    check(g_err <= 1e-5, f"parity: gradients differ by {g_err}")
    check(p_err <= 1e-5, f"parity: updated params differ by {p_err}")
    return {"loss": (lf, ld), "grad_norm": (nf, nd), "grad_err": g_err,
            "param_err": p_err}


# -- phase 7: ResNet-50 training ----------------------------------------------

# bench/suite.py:bench_resnet50 with KFTPU_RESNET_FUSED_BN=1
RESNET_BATCH, RESNET_STEPS = 256, 5


def resnet50_train_flops_per_image(stem: str) -> float:
    """Analytic fwd+bwd flops per 224^2 image, 3 x forward
    (bench/suite.py:62-70): the 7x7-stem forward is ~4.11 GFLOP; the
    space_to_depth stem's 2x2 conv replaces its 0.236 GFLOP stem conv
    with 0.077 GFLOP."""
    fwd = 4.11e9 if stem == "conv" else 4.11e9 - 0.236e9 + 0.077e9
    return 3.0 * fwd


def resnet_setup(device, *, fused=True, act_compress=False):
    """``bench_resnet50``'s configuration on ``device``: (config, train
    state, images, labels). ResNet-50 with bf16 compute and BN over f32
    params, the space_to_depth stem, ``optax.sgd(0.1, momentum=0.9)``;
    random weights from a numpy seed (bn3 scales zero), the same in
    both layouts; one batch of 256 random-normal 224x224x3 bf16 images
    and labels in [0, 1000), made on the host from a seed and kept on
    the card, reused every step as the bench reuses its batch."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.train import create_image_train_state, make_sgd

    variables = convert.random_resnet_params(
        ResNetConfig(fused_bn_conv=True), SEED)
    if not fused:
        variables = convert.unfuse_bn_conv(variables)
    cfg = ResNetConfig(num_classes=1000, fused_bn_conv=fused,
                       act_compress=act_compress)
    state = create_image_train_state(cfg, variables,
                                     make_sgd(0.1, momentum=0.9),
                                     device=device)
    rng = np.random.default_rng(SEED + 5)
    images = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 224, 224, 3), dtype=np.float32)).to(
            device, torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).to(device)
    return cfg, state, images, labels


def resnet_phase(device, *, fused=True, steps=RESNET_STEPS):
    """``steps`` steps of ``make_image_train_step``; with ``fused``, the
    slice's path: each bnconv kernel launched 16 times a step, finite
    losses with the first within ln(1000) +- 1.5, running statistics
    moved and every parameter updated."""
    import math

    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.train import make_image_train_step

    t0 = time.perf_counter()
    cfg, state, images, labels = resnet_setup(device, fused=fused)
    model = state.module
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: s.clone() for n, s in state.batch_stats.items()}
    n_params = sum(p.numel() for p in before.values())
    print(f"resnet50 state built (fused_bn_conv={fused}): "
          f"{time.perf_counter() - t0:.1f}s, {n_params} params", flush=True)
    step = make_image_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, accs, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, images, labels)
        losses.append(float(m["loss"]))          # syncs the step
        times.append(time.perf_counter() - t0)
        accs.append(float(m["accuracy"]))
    launches = ops.launch_counts()
    check(all(math.isfinite(x) for x in losses),
          f"resnet50: losses {losses}")
    n_sites = sum(cfg.stage_sizes)
    for name in ("bnconv_fwd", "bnconv_dw"):
        want = n_sites * steps if fused else 0
        check(launches[name] == want,
              f"resnet50 (fused_bn_conv={fused}): {name} launched "
              f"{launches[name]} times, expected {want}")
    if fused:
        ln_c = math.log(cfg.num_classes)
        check(abs(losses[0] - ln_c) <= 1.5,
              f"resnet50: step-1 loss {losses[0]} not within "
              f"ln(1000)={ln_c:.3f} +- 1.5")
        check(losses[-1] < losses[0],
              f"resnet50: loss did not fall on the fixed batch: {losses}")
        # an update below f32 resolution at the parameter's size rounds
        # away (bn3 scales start at zero, so the gradients behind them
        # are tiny for the first steps); the momentum trace shows it was
        # applied all the same
        traces = dict(zip([n for n, _ in model.named_parameters()],
                          state.opt_state["trace"]))
        same = [n for n, p in model.named_parameters()
                if torch.equal(p.detach(), before[n])]
        unchanged = [n for n in same if not traces[n].abs().max() > 0]
        check(not unchanged, f"resnet50: parameters not updated: "
                             f"{unchanged[:8]}")
        rounded = {n: (0.1 * traces[n].abs().max()).item() for n in same}
        still = [n for n, s in state.batch_stats.items()
                 if torch.equal(s, stats0[n])]
        check(not still, f"resnet50: running statistics not moved: "
                         f"{still[:8]}")
    step_s = sum(times[1:]) / (steps - 1)        # step 1 warms up
    flops = resnet50_train_flops_per_image(cfg.stem) * RESNET_BATCH
    return {"losses": losses, "accuracy": accs,
            "rounded_away": rounded if fused else {},
            "step_ms": [t * 1e3 for t in times],
            "mean_step_ms": step_s * 1e3,
            "images_per_s": RESNET_BATCH / step_s,
            "mfu": flops / step_s / BF16_FLOPS,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


# -- phase 8: fused vs unfused ResNet step in f32 ----------------------------


# f32 limits of the fused-vs-unfused step. The forwards differ in
# summation order only (~3e-6 of the logits), but an element of a block
# output within that of zero takes the other side of its ReLU, and its
# whole gradient moves: at 262,144 elements in the last block one such
# flip moves every gradient below it by ~0.2% of its norm (the port's
# two layouts on the CPU read 2.4e-3 and 8.5e-3 per leaf, two seeds;
# the card, with no flip, 8.0e-6). A wiring fault (a wrong layout, a
# lost rounding, a dropped split) moves the leaves it touches by ~1.
# Parameters move by lr times gradients.
RESNET_PARITY_LOSS = 1e-5
RESNET_PARITY_GRAD = 2e-2
RESNET_PARITY_PARAM = 1e-3


def resnet_parity_phase(device):
    """One f32 train step (TF32 off in matmul and cuDNN) of a small
    ResNet (stages 1-1-1-1, width 64, 128x128 images, batch 8), fused and
    unfused from the same weights with bn3's scales randomised (at zero
    no gradient reaches the fused sites). The loss, every gradient and
    every updated parameter agree within the limits below, and the
    fused step launches both kernels at its 4 sites."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.train import (
        create_image_train_state,
        make_image_train_step,
        make_sgd,
        softmax_cross_entropy,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(stage_sizes=(1, 1, 1, 1), num_classes=100, width=64,
                dtype="float32", bn_dtype="float32")
    variables = convert.random_resnet_params(
        ResNetConfig(**base, fused_bn_conv=True), SEED + 6)
    rng = np.random.default_rng(SEED + 7)
    flat = convert.flatten(variables)
    for key in flat:
        if key.endswith("bn3/scale"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(
                np.float32)
    variables = convert.unflatten(flat)
    images = torch.from_numpy(rng.standard_normal(
        (8, 128, 128, 3), dtype=np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 100, 8)).to(device)
    res = {}
    for fused in (True, False):
        tree = variables if fused else convert.unfuse_bn_conv(variables)
        cfg = ResNetConfig(**base, fused_bn_conv=fused)
        state = create_image_train_state(cfg, tree, make_sgd(
            0.1, momentum=0.9), device=device)
        grads = torch.autograd.grad(
            softmax_cross_entropy(state.module(images), labels),
            state.params)
        grads = convert.flatten(convert.resnet_grads(state.module, grads))
        ops.reset_launches()
        state, m = make_image_train_step()(state, images, labels)
        launches = ops.launch_counts()
        params = convert.flatten(convert.resnet_variables(state.module))
        if fused:
            grads = convert.flatten(convert.unfuse_bn_conv(
                convert.unflatten(grads)))
            params = convert.flatten(convert.unfuse_bn_conv(
                convert.unflatten(params)))
            for name in ("bnconv_fwd", "bnconv_dw"):
                check(launches[name] == 4, f"parity: {name} launched "
                                           f"{launches[name]} times, not 4")
        res[fused] = (float(m["loss"]), grads, params)
    (lf, gf, pf), (lu, gu, pu) = res[True], res[False]
    check(gf.keys() == gu.keys() and pf.keys() == pu.keys(),
          "parity: the fused and unfused trees differ")
    g_err = max(float(np.linalg.norm(gf[k] - gu[k]) / np.linalg.norm(gu[k]))
                for k in gu)
    p_err = max(float(np.abs(pf[k] - pu[k]).max()) for k in pu)
    check(abs(lf - lu) <= RESNET_PARITY_LOSS,
          f"parity: loss {lf} vs {lu}")
    check(g_err <= RESNET_PARITY_GRAD,
          f"parity: a gradient differs by {g_err} of its norm")
    check(p_err <= RESNET_PARITY_PARAM,
          f"parity: updated params/statistics differ by {p_err}")
    return {"loss": (lf, lu), "grad_err": g_err, "param_err": p_err}


# -- phase 9: the dense engine at bench_decode_engine's configuration -------

# kubeflow_tpu/bench/suite.py:bench_decode_engine (:836) and
# engine_bench_setup (:666): 48 requests of 128 prompt tokens and 128
# new through 32 slots, 64 steps a host round-trip, bursts of 8
DENSE = dict(BENCH, max_seq_len=256)
DENSE_REQUESTS, DENSE_PROMPT, DENSE_NEW = 48, 128, 128
DENSE_SLOTS, DENSE_SYNC, DENSE_BATCH = 32, 64, 8
DENSE_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


def dense_setup(device):
    """(config, model, prompts (48, 128)) from numpy seeds."""
    import numpy as np

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**DENSE, dtype="bfloat16")
    model = convert.to_module(cfg, convert.random_params(cfg, SEED),
                              device=device)
    prompts = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (DENSE_REQUESTS, DENSE_PROMPT), dtype=np.int32)
    return cfg, model, prompts


def drain(eng) -> None:
    while eng.active_count or eng.pending_count:
        eng.run_once(timeout=0.01)


def dense_engine(cfg, model, device, sampler_impl=None):
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(cfg, model, slots=DENSE_SLOTS,
                        steps_per_sync=DENSE_SYNC,
                        admit_batch_max=DENSE_BATCH,
                        sampler_impl=sampler_impl, paged=False,
                        autostart=False, device=device)


def dense_warm(eng, prompts, kw) -> None:
    """The reference bench's warm-up: bursts of 1, 2, 4 and 8 requests
    of ``steps_per_sync + 1`` tokens (every batch-prefill shape)."""
    n = 1
    while True:
        warms = [eng.submit(prompts[i], max_new=DENSE_SYNC + 1, **kw)
                 for i in range(n)]
        drain(eng)
        for w in warms:
            w.result()
        if n >= min(eng.admit_batch_max, eng.slots):
            return
        n *= 2


class StampedQueue(queue.Queue):
    """A request's token queue that notes when its first item arrives:
    ``first_put`` on the script's clock, ``first_put_engine`` on the
    engine's (``clock``), beside the ledger's stamps."""

    def __init__(self, clock=time.monotonic):
        super().__init__()
        self.first_put = None
        self.first_put_engine = None
        self._clock = clock

    def put(self, item, *args, **kwargs):
        if self.first_put is None:
            self.first_put = time.perf_counter()
            self.first_put_engine = self._clock()
        super().put(item, *args, **kwargs)


def dense_burst(eng, prompts, kw):
    """Submit every prompt (seed = its index), drive the engine through
    ``run_once`` until it is idle; (requests, streams, t0). Each request's
    queue stamps its first token's arrival (``StampedQueue``)."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=DENSE_NEW, seed=i, **kw)
            for i, p in enumerate(prompts)]
    for r in reqs:              # nothing is queued before the first run_once
        r.out = StampedQueue(eng.clock)
    drain(eng)
    return reqs, [r.result() for r in reqs], t0


def hold_dense_sampler(eng, prompts, kw, want) -> dict:
    """The fused burst again, every sampler call of the engine held
    against ``fused_sample_plain`` on the same inputs (token-identical);
    the streams must equal the timed burst's. Returns the calls held,
    by shape."""
    import collections

    import torch

    from kubeflow_tpu_torch.ops import sampling as sm
    from kubeflow_tpu_torch.serving import engine as engine_mod

    shapes = collections.Counter()

    def held(logits, noise, temp, top_k, top_p):
        got = sm.fused_sample(logits, noise, temp, top_k, top_p)
        ref = sm.fused_sample_plain(logits, noise, temp, top_k, top_p)
        check(torch.equal(got, ref),
              f"dense path: fused_sample {tuple(logits.shape)} differs "
              f"from plain: {got.tolist()} vs {ref.tolist()}")
        shapes["x".join(map(str, logits.shape))] += 1
        return got

    engine_mod.fused_sample = held
    try:
        _, streams, _ = dense_burst(eng, prompts, kw)
    finally:
        engine_mod.fused_sample = sm.fused_sample
    check(streams == want, "the held fused burst's streams differ from "
                           "the timed burst's (same seeds)")
    return dict(shapes)


def dense_run(cfg, model, prompts, device, *, sampler_impl=None,
              sampled=False):
    """One burst of 48 requests through a fresh dense engine after its
    warm-up. The first wave's TTFT is the wall from the first submit
    until the 32nd first token reached its request's queue (the
    reference bench's burst TTFT). Launch counts are zeroed just before
    the burst and read just after. A fused run then holds the sampler
    against its plain version on the dense path's own calls."""
    import statistics

    import torch

    from kubeflow_tpu_torch import ops

    eng = dense_engine(cfg, model, device, sampler_impl)
    check(not eng.paged, "the dense engine came up paged")
    led, _ = fresh_trace(eng)
    kw = DENSE_SAMPLED if sampled else {}
    dense_warm(eng, prompts, kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0, bp0 = eng.steps_total, eng.batch_prefills
    ops.reset_launches()
    reqs, toks, t0 = dense_burst(eng, prompts, kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for i, t in enumerate(toks):
        check(len(t) == DENSE_NEW, f"dense request {i}: {len(t)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in t),
              f"dense request {i}: token out of range")
    firsts = [(r.out.first_put - t0) * 1e3 for r in reqs[:DENSE_SLOTS]]
    recs = ledger_records(led, [r.rid for r in reqs], DENSE_NEW)
    # the reference bench's burst TTFT, off the ledger, against the
    # phase's own reading at the requests' queues
    ledger_ttft = ledger_burst_ttft_ms(led, reqs[:DENSE_SLOTS])
    loop_s, loop_max_s = admission_loop_s(led, reqs[:DENSE_SLOTS])
    print(f"phase 9 first wave: admission loop {loop_s:.6f} s of host time "
          f"from the batch's stamp to the 32nd first token's queue put "
          f"(largest member {loop_max_s:.6f} s); ledger TTFT "
          f"{ledger_ttft:.2f} ms, queues {max(firsts):.2f} ms", flush=True)
    check(abs(ledger_ttft - max(firsts)) <= 0.05 * max(firsts),
          f"first-wave TTFT: ledger {ledger_ttft:.2f} ms vs queues "
          f"{max(firsts):.2f} ms")
    out = {"tokens_per_s": DENSE_REQUESTS * DENSE_NEW / wall,
           "wall_s": wall, "ttft_ms": max(firsts),
           "ledger_ttft_ms": ledger_ttft,
           "admission_loop_s": loop_s,
           "ledger_p50_s": ledger_p50(recs),
           "ttft_ms_median": statistics.median(firsts),
           "steps": eng.steps_total - steps0,
           "batch_prefills": eng.batch_prefills - bp0,
           "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "sampler": eng.sampler_impl}
    check(out["batch_prefills"] > 0, "the burst admitted no batch prefill")
    check(launches["paged_decode_attention"] == 0,
          "the paged kernel launched on the dense path")
    if eng.sampler_impl == "fused":
        out["held"] = hold_dense_sampler(eng, prompts, kw, toks)
    eng.close()
    return out


def dense_phase(device):
    """Greedy (the default bounded sampler), fused-sampled and
    bounded-sampled runs; the fused run must launch the sampler, and
    every one of its calls on a second burst must match the plain
    sampler."""
    import torch

    cfg, model, prompts = dense_setup(device)
    runs = {"greedy": dense_run(cfg, model, prompts, device),
            "fused": dense_run(cfg, model, prompts, device,
                               sampler_impl="fused", sampled=True),
            "bounded": dense_run(cfg, model, prompts, device,
                                 sampled=True)}
    check(runs["fused"]["sampler"] == "fused"
          and runs["bounded"]["sampler"] == "bounded",
          f"samplers: {runs['fused']['sampler']}, "
          f"{runs['bounded']['sampler']}")
    check(runs["fused"]["launches"]["fused_sample"] > 0,
          "fused_sample never launched on the dense path")
    check(f"{DENSE_SLOTS}x{DENSE['vocab_size']}" in runs["fused"]["held"],
          f"no sampled step held at ({DENSE_SLOTS}, {DENSE['vocab_size']}):"
          f" {runs['fused']['held']}")
    del model
    torch.cuda.empty_cache()
    return runs


# -- phase 10: dense, paged and unary greedy parity in f32 --------------------


def f32_export(base: str) -> None:
    """Beside the export ``lm``, ``lm32``: the same weights file under an
    f32 config, for the server's f32 unary run."""
    import yaml

    from kubeflow_tpu_torch.serving.model_store import MODEL_FILE

    src, dst = (os.path.join(base, m, "1") for m in ("lm", "lm32"))
    os.makedirs(dst)
    os.link(os.path.join(src, "params.npz"),
            os.path.join(dst, "params.npz"))
    with open(os.path.join(src, MODEL_FILE)) as f:
        meta = yaml.safe_load(f)
    meta["config"]["dtype"] = "float32"
    with open(os.path.join(dst, MODEL_FILE), "w") as f:
        yaml.safe_dump(meta, f)


def dense_parity_phase(base: str, cfg, device, *, n=4, max_new=24,
                       prompt_len=200):
    """The phase-3 export in f32 (TF32 off) through the dense engine with
    burst admission, the paged engine with its kernel, the unary
    ``LoadedModel.generate``, and a default ``ModelServer`` (no
    ``KFTPU_PAGED``, ``decode_slots=0``): four identical greedy streams
    (every path decodes at batch 4)."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.model_store import LoadedModel
    from kubeflow_tpu_torch.serving.server import ModelServer

    cfg32, model = load_f32(base, cfg, device)
    prompts = prompts_for(n, prompt_len, cfg.vocab_size, seed=SEED + 7)
    streams = {}
    for mode in ("dense", "paged"):
        ops.reset_launches()
        eng = DecodeEngine(cfg32, model, slots=n, paged=mode == "paged",
                           paged_attention_impl="kernel", autostart=False,
                           device=device)
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        drain(eng)
        streams[mode] = [r.result() for r in reqs]
        launched = ops.launch_counts()["paged_decode_attention"]
        check(launched == 0 if mode == "dense" else launched > 0,
              f"{mode}: paged kernel launches {launched}")
        if mode == "dense":
            check(eng.batch_prefills == 1, "phase 10: no burst admission")
        eng.close()
    lens = np.asarray([len(p) for p in prompts], np.int32)
    padded = np.zeros((n, 256), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    loaded = LoadedModel(kind="transformer", version=1, module=model,
                         apply=lambda m, x: m(x))
    streams["unary"] = loaded.generate(padded, lens, max_new, 0.0, 0,
                                       greedy=True).tolist()
    del model, loaded
    torch.cuda.empty_cache()
    os.environ.pop("KFTPU_PAGED", None)
    f32_export(base)
    server = ModelServer(base, port=0, device=device)
    port = server.start()
    try:
        check(server.repo.engine_for("lm32", server.repo.get("lm32"))
              is None, "the default ModelServer built a decode engine")
        out, _ = _post(f"http://127.0.0.1:{port}/v1/models/lm32:generate",
                       {"prompt_tokens": prompts, "max_new_tokens": max_new},
                       False)
        streams["server"] = out["tokens"]
    finally:
        server.stop()
    for mode in ("paged", "unary", "server"):
        check(streams[mode] == streams["dense"],
              f"f32 greedy streams differ, dense vs {mode}: "
              f"{streams['dense']} vs {streams[mode]}")
    return streams["dense"]


# -- phase 2, BERT's shape: the flash kernels non-causal at (16, 512, 12, 64)


# bench/suite.py:bench_bert (:366): BERT-base at batch 16, seq 512
BERT_BATCH, BERT_SEQ, BERT_STEPS = 16, 512, 5


def check_flash_bert_shape(device) -> dict:
    """The flash forward and backward against their plain versions at
    BERT's shape (B=16, S=512, H=12, D=64, bf16, non-causal) and the entry
    point's (B=8, S=128), with and without kv_len, at phase 2's limits;
    then each timed unmasked at BERT's shape beside its
    bound, its plain version and ``scaled_dot_product_attention``
    (``is_causal=False``, forward and backward). Returns ``{kernel:
    {max_abs_err, ms, bound_ms, bound_by, plain_ms, library_ms}}``."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    B, S, H, D = BERT_BATCH, BERT_SEQ, 12, 64
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    owner = {"out": "flash_fwd", "lse": "flash_fwd", "dq": "flash_bwd",
             "dk": "flash_bwd", "dv": "flash_bwd"}
    # the entry point's default (batch 8, seq 128: one 64-row tile pair)
    # first, then BERT's bench shape, the unmasked case last
    for seed, (b, s, masked) in enumerate(
            ((8, 128, True), (8, 128, False), (B, S, True), (B, S, False)),
            SEED + 40):
        errs, case = compare_flash(b, s, H, D, torch.bfloat16, device, seed,
                                   causal=False, masked=masked, step=H)
        for name, err in errs.items():
            worst[owner[name]] = max(worst[owner[name]], err)
    q, k, v, g, lse, delta = case                  # the unmasked case
    kw = dict(causal=False)
    ms = {"flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v, **kw)),
          "flash_bwd": time_ms(lambda: fa.flash_bwd(
              q, k, v, g, lse, delta, **kw))}
    plain = {
        "flash_fwd": time_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw),
                             iters=5, warmup=1),
        "flash_bwd": time_ms(lambda: (
            fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)),
            iters=5, warmup=1)}
    lib = sdpa_yardstick(q, k, v, g, causal=False)
    lib["flash_bwd"] = lib["backward"]
    library = {name: lib[name][0] for name in ms}
    work = flash_bytes_ops(B, S, H, D, 2, False)
    out = {}
    for name in ms:
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = {"max_abs_err": worst[name], "ms": ms[name],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "plain_ms": plain[name], "library_ms": library[name],
                     "library_backend": lib[name][1]}
        print(f"{name} bf16 non-causal B={B} H={H} S={S} D={D} (BERT): "
              f"kernel_ms={ms[name]:.4f} "
              f"({flops / ms[name] / 1e9:.1f} TFLOP/s) "
              f"bound_ms={max(t_bytes, t_ops):.4f} "
              f"plain_ms={plain[name]:.4f} library_ms={library[name]:.4f} "
              f"(scaled_dot_product_attention, is_causal=False, "
              f"{'forward' if name == 'flash_fwd' else 'backward'}, "
              f"{lib[name][1]} backend, dO contiguous) "
              f"[{FLASH_D64_KERNELS[name]}]", flush=True)
        if name == "flash_bwd":
            size, traffic = flash_workspace_bytes(B, S, H, D)
            print(f"flash_bwd dQ workspace (BERT, not in the bound): {size} "
                  f"bytes f32, {traffic} bytes written and read "
                  f"({traffic / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
                  f"memory rate)", flush=True)
    del q, k, v, g, case
    torch.cuda.empty_cache()
    return out


# -- phase 11: BERT-base masked-LM training ----------------------------------


def bert_train_flops(cfg, n_params: int) -> int:
    """Flops of one step by ``bench_bert``'s count (:412-414):
    6·N·tokens plus the attention matmuls, 12·L·B·S²·d, remat
    excluded."""
    tokens = BERT_BATCH * BERT_SEQ
    return (6 * n_params * tokens
            + 12 * cfg.n_layers * BERT_BATCH * BERT_SEQ * BERT_SEQ
            * cfg.d_model)


def bert_setup(device):
    """``bench_bert``'s configuration on ``device``: (config, train
    state, (tokens, labels, weights)). BERT-base (bf16 compute over f32
    params, remat, ``attention_impl="auto"``: the flash kernels on the
    card), ``make_optimizer(1e-4, warmup_steps=10, decay_steps=1000)``,
    random weights from a numpy seed, and one batch of 16 x 512 uniform
    tokens and labels with 15 % weights, made from a seed and kept on
    the card, reused every step as the bench reuses its batch."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import bert_base
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        make_optimizer,
    )

    cfg = bert_base()
    state = create_bert_train_state(
        cfg, convert.random_bert_params(cfg, SEED + 6),
        make_optimizer(1e-4, warmup_steps=10, decay_steps=1000),
        device=device)
    rng = np.random.default_rng(SEED + 7)
    shape = (BERT_BATCH, BERT_SEQ)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)).to(device)
    weights = torch.from_numpy((rng.random(shape) < 0.15).astype(
        np.float32)).to(device)
    return cfg, state, (tokens, labels, weights)


def bert_phase(device, *, steps=BERT_STEPS):
    """``steps`` steps of ``make_mlm_train_step`` on :func:`bert_setup`'s
    state and batch. Flash must launch 24 / 12 times a step (forward
    with remat, the one-pass backward) and the dQ and dK/dV kernels
    never; losses finite, the first within
    ln(30522) +- 1.5, falling; every parameter updated."""
    import math

    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.train import make_mlm_train_step

    t0 = time.perf_counter()
    cfg, state, batch = bert_setup(device)
    model = state.module
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_params = sum(p.numel() for p in before.values())
    print(f"bert-base state built: {time.perf_counter() - t0:.1f}s, "
          f"{n_params} params", flush=True)
    step = make_mlm_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    ops.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))        # syncs the step
        times.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    L = cfg.n_layers
    for name, n in (("flash_fwd", 2 * L), ("flash_bwd", L),
                    ("flash_bwd_dq", 0), ("flash_bwd_dkv", 0)):
        check(launches[name] == n * steps,
              f"bert: {name} launched {launches[name]} times, expected "
              f"{n * steps} ({n} per step)")
    check(all(math.isfinite(x) for x in losses), f"bert: losses {losses}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) <= 1.5,
          f"bert: step-1 loss {losses[0]} not within ln(V)={ln_v:.3f} "
          f"+- 1.5")
    check(losses[-1] < losses[0], f"bert: loss did not fall: {losses}")
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(p.detach(), before[n])]
    check(not unchanged, f"bert: parameters not updated: {unchanged}")
    step_s = sum(times[1:]) / (steps - 1)      # step 1 warms up
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "mean_step_ms": step_s * 1e3,
            "tokens_per_s": BERT_BATCH * BERT_SEQ / step_s,
            "mfu": bert_train_flops(cfg, n_params) / step_s / BF16_FLOPS,
            "base_gb": base_gb,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "grad_norm": float(m["grad_norm"]), "launches": launches}


# -- phase 12: BERT flash vs dense MLM step in f32, with padding -------------


def bert_parity_phase(device):
    """One f32 MLM step (TF32 off) of a 2-layer BERT at BERT-base's
    widths, seq 512, rows of 512, 377, 64 and 1 valid tokens
    (``seq_lengths``; the loss weights zero the padding), with flash and
    with dense attention from the same weights: loss, gradients and
    updated parameters within 1e-5. lr 1e-5 with no warmup, as in phase
    6."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        global_norm,
        make_optimizer,
        masked_lm_loss,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dict(n_layers=2, dtype="float32", remat=True)
    cfg = BertConfig(**base)
    params = convert.random_bert_params(cfg, SEED + 8)
    lengths = [512, 377, 64, 1]
    rng = np.random.default_rng(SEED + 9)
    shape = (len(lengths), BERT_SEQ)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(
        device)
    live = np.arange(BERT_SEQ)[None, :] < np.array(lengths)[:, None]
    w = (rng.random(shape) < 0.15) & live
    w[:, 0] = True                    # every row has a weighted position
    weights = torch.from_numpy(w.astype(np.float32)).to(device)
    tokens = torch.where(weights > 0, 103, labels)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    res = {}
    for impl in ("flash", "dense"):
        state = create_bert_train_state(
            BertConfig(**base, attention_impl=impl), params,
            make_optimizer(1e-5, warmup_steps=0), device=device)
        loss = masked_lm_loss(state.module(tokens, seq_lengths=lens),
                              labels, weights)
        grads = torch.autograd.grad(loss, state.params)
        norm = global_norm(grads)
        state.apply_gradients(grads, norm)
        res[impl] = (loss.item(), norm.item(), grads,
                     [p.detach() for p in state.params])
    (lf, nf, gf, pf), (ld, nd, gd, pd) = res["flash"], res["dense"]
    g_err = max((a - b).abs().max().item() for a, b in zip(gf, gd))
    p_err = max((a - b).abs().max().item() for a, b in zip(pf, pd))
    check(abs(lf - ld) <= 1e-5, f"bert parity: loss {lf} vs {ld}")
    check(abs(nf - nd) <= 1e-5 * nd, f"bert parity: grad_norm {nf} vs {nd}")
    check(g_err <= 1e-5, f"bert parity: gradients differ by {g_err}")
    check(p_err <= 1e-5, f"bert parity: updated params differ by {p_err}")
    return {"loss": (lf, ld), "grad_norm": (nf, nd), "grad_err": g_err,
            "param_err": p_err}


# -- phase 13: the BERT entry point, checkpoint/resume and the profiler ------


def _entry_main(module: str, argv, env):
    """``kubeflow_tpu_torch.examples.<module>.main(argv)`` with the env
    contract ``env`` set around the call (and the rest of the contract's
    keys unset); returns its result."""
    import importlib

    mod = importlib.import_module(f"kubeflow_tpu_torch.examples.{module}")
    keys = ("KFTPU_CHECKPOINT_DIR", "KFTPU_RESULTS_DIR", "KFTPU_JOB_NAME",
            "KFTPU_PROFILE_DIR", "KFTPU_PROFILE_START",
            "KFTPU_PROFILE_STEPS")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(env)
    try:
        return mod.main(argv)
    finally:
        for k in keys:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def _losses(results: str, job: str) -> dict:
    with open(os.path.join(results, f"{job}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in recs if "done" not in r}


def bert_entry_phase(device):
    """``python -m kubeflow_tpu_torch.examples.bert`` at its defaults
    (BERT-base, batch 8, seq 128) on the card: 4 steps with a checkpoint
    every 2 and the profiler on steps 1-2, a restart to 6 steps, and an
    unbroken 6-step run. The restart resumes at step 4; a restore of the
    step-4 checkpoint into a fresh state on the card equals the saved
    tensors bit for bit; steps 5-6 take the unbroken run's losses within
    1e-5 relative; the trace names the flash forward, the one-pass
    backward and its dQ pass, and none of the dQ or dK/dV kernels."""
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        make_optimizer,
    )
    from kubeflow_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
    )

    work = tempfile.mkdtemp(prefix="kftpu-bert-")
    try:
        ckpt, results = (os.path.join(work, d) for d in ("ckpt", "results"))
        prof = os.path.join(work, "profile")
        argv = ["--log-every", "1", "--checkpoint-every", "2"]
        env = {"KFTPU_CHECKPOINT_DIR": ckpt, "KFTPU_RESULTS_DIR": results}
        ops.reset_launches()
        t0 = time.perf_counter()
        _entry_main("bert", argv + ["--steps", "4"], dict(
            env, KFTPU_JOB_NAME="first", KFTPU_PROFILE_DIR=prof,
            KFTPU_PROFILE_START="1", KFTPU_PROFILE_STEPS="2"))
        t_first = time.perf_counter() - t0
        check(CheckpointManager(ckpt).all_steps() == [2, 4],
              f"bert entry: checkpoints {os.listdir(ckpt)}")
        resumed = _entry_main("bert", argv + ["--steps", "6"],
                              dict(env, KFTPU_JOB_NAME="restart"))
        unbroken = _entry_main(
            "bert", ["--log-every", "1", "--checkpoint-every", "100",
                     "--steps", "6"],
            {"KFTPU_CHECKPOINT_DIR": os.path.join(work, "ckpt2"),
             "KFTPU_RESULTS_DIR": results, "KFTPU_JOB_NAME": "unbroken"})
        launches = ops.launch_counts()
        first = _losses(results, "first")
        restart = _losses(results, "restart")
        want = _losses(results, "unbroken")
        check(sorted(first) == [1, 2, 3, 4] and sorted(restart) == [5, 6],
              f"bert entry: the restart did not resume at step 4 "
              f"({sorted(first)}, {sorted(restart)})")
        rel = {s: abs(restart[s] - want[s]) / abs(want[s]) for s in (5, 6)}
        rel["6 unrounded"] = abs(resumed - unbroken) / abs(unbroken)
        check(all(r <= 1e-5 for r in rel.values()),
              f"bert entry: resumed losses {restart} ({resumed}) vs "
              f"unbroken {want} ({unbroken})")
        check(all(abs(first[s] - want[s]) <= 1e-5 * abs(want[s])
                  for s in first),
              f"bert entry: first run {first} vs unbroken {want}")
        # the step-4 checkpoint restored into a fresh state on the card
        cfg = BertConfig(max_seq_len=128)
        state = create_bert_train_state(
            cfg, convert.random_bert_params(cfg, 1),
            make_optimizer(), device=device)
        CheckpointManager(ckpt).restore(state, step=4)
        saved = torch.load(os.path.join(ckpt, "4", STATE_FILE),
                           map_location="cpu", weights_only=True)
        pairs = [(t, saved["module"][k]) for k, t in
                 state.module.state_dict().items()]
        for key in ("mu", "nu"):
            pairs += list(zip(state.opt_state[key], saved["opt_state"][key]))
        differ = sum(not torch.equal(t.cpu(), s) for t, s in pairs)
        check(differ == 0 and state.step == 4 and
              state.opt_state["count"] == 4,
              f"bert entry: {differ} of {len(pairs)} restored tensors "
              f"differ from the saved ones")
        # the last checkpoints of the resumed and the unbroken run
        a = torch.load(os.path.join(ckpt, "6", STATE_FILE),
                       weights_only=True)
        b = torch.load(os.path.join(work, "ckpt2", "6", STATE_FILE),
                       weights_only=True)
        param_diff = max((a["module"][k] - b["module"][k]).abs().max().item()
                         for k in a["module"])
        traces = [os.path.join(prof, f) for f in os.listdir(prof)]
        check(len(traces) == 1, f"bert entry: traces {traces}")
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        kernels = {n: sorted(x for x in names if n in x)
                   for n in ("flash_fwd_wgmma", "flash_bwd_wgmma",
                             "flash_bwd_dq_out")}
        check(all(kernels.values()),
              f"bert entry: the trace lacks a flash kernel: {kernels}")
        pair = sorted(x for x in names if "flash_bwd_dkv" in x or (
            "flash_bwd_dq" in x and "flash_bwd_dq_out" not in x))
        check(not pair, f"bert entry: the trace holds the dQ or dK/dV "
                        f"kernels beside the fused backward: {pair}")
        return {"first_losses": first, "restart_losses": restart,
                "unbroken_losses": want, "rel_err": rel,
                "param_diff": param_diff, "restored": len(pairs),
                "trace_kernels": kernels, "launches": launches,
                "trace_mb": os.path.getsize(traces[0]) / 1e6,
                "first_run_s": t_first}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phase 14: the LM entry point at its defaults ----------------------------


def _reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(device) -> float:
    import torch

    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e9


def _records(results: str, job: str) -> list:
    with open(os.path.join(results, f"{job}.jsonl")) as f:
        return [json.loads(line) for line in f]


def lm_entry_phase(device, store: str, *, size=(), vocab=32000):
    """``python -m kubeflow_tpu_torch.examples.lm`` at its defaults (d
    768, 12 layers, 12 heads, d_ff 3072, vocab 32000, seq 512, batch 8;
    dense attention, bf16 over f32 params, remat) on the card:

    - 6 steps with a checkpoint every 3, a 16-token sample, the export
      to ``<store>/lm`` and a 2-layer draft distilled 20 steps and
      exported as ``<store>/lm-draft`` (``draft_of: lm@1``);
    - a restart at ``--steps 6``: it trains nothing and still exports;
    - 3 steps, restarted to 6: steps 4-6 take the 6-step run's losses
      within 1e-5 relative.

    Losses finite and within 1.0 of ln(32000); the sample 16 ids in
    range. ``size`` (extra flags) and ``vocab`` shrink the run for a
    rehearsal on the CPU. Returns the numbers phase 14 prints."""
    import math

    import yaml

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving.model_store import MODEL_FILE

    work = tempfile.mkdtemp(prefix="kftpu-lm-")
    try:
        results = os.path.join(work, "results")
        ckpt_a, ckpt_b = (os.path.join(work, d) for d in ("a", "b"))
        _reset_peak(device)
        ops.reset_launches()
        t0 = time.perf_counter()
        flags = ["--device", str(device), *size]
        _entry_main("lm", flags + [
            "--steps", "6", "--checkpoint-every", "3", "--log-every", "1",
            "--generate", "16", "--export", os.path.join(store, "lm"),
            "--draft-layers", "2", "--draft-distill-steps", "20"],
                    {"KFTPU_CHECKPOINT_DIR": ckpt_a,
                     "KFTPU_RESULTS_DIR": results, "KFTPU_JOB_NAME": "a"})
        t_full = time.perf_counter() - t0
        peak_gb = _peak_gb(device)
        launches = ops.launch_counts()
        check(not any(launches.values()),
              f"lm entry: kernels launched on the dense default path: "
              f"{launches}")
        recs = _records(results, "a")
        losses = {r["step"]: r["loss"] for r in recs if "loss" in r}
        ln_v = math.log(vocab)
        check(sorted(losses) == [1, 2, 3, 4, 5, 6] and all(
            math.isfinite(x) and abs(x - ln_v) <= 1.0
            for x in losses.values()),
            f"lm entry: losses {losses} (ln V = {ln_v:.4f})")
        sample = next(r["sample_tokens"] for r in recs
                      if "sample_tokens" in r)
        check(len(sample) == 16 and all(0 <= t < vocab for t in sample),
              f"lm entry: sample {sample}")
        with open(os.path.join(store, "lm-draft", "1", MODEL_FILE)) as f:
            meta = yaml.safe_load(f)
        check(meta.get("draft_of") == "lm@1"
              and meta["config"]["n_layers"] == 2
              and os.path.isfile(os.path.join(store, "lm", "1",
                                              MODEL_FILE)),
              f"lm entry: exports {os.listdir(store)}, draft meta {meta}")
        draft_loss = next(r["draft_distill_loss"] for r in recs
                          if "draft_distill_loss" in r)
        last = next(r for r in reversed(recs) if "loss" in r)
        # the restart after the last checkpoint: no step, still exports
        again = os.path.join(work, "again", "lm")
        _entry_main("lm", flags + ["--steps", "6", "--export", again],
                    {"KFTPU_CHECKPOINT_DIR": ckpt_a,
                     "KFTPU_RESULTS_DIR": results,
                     "KFTPU_JOB_NAME": "a-done"})
        done = _records(results, "a-done")
        check(done[0].get("done") and done[0]["step"] == 6
              and not any("loss" in r for r in done)
              and done[-1].get("exported") == os.path.join(again, "1"),
              f"lm entry: the done restart logged {done}")
        # 3 steps, then a restart to 6, against the 6-step run
        argv = flags + ["--log-every", "1", "--checkpoint-every", "3"]
        env = {"KFTPU_CHECKPOINT_DIR": ckpt_b, "KFTPU_RESULTS_DIR": results}
        _entry_main("lm", argv + ["--steps", "3"],
                    dict(env, KFTPU_JOB_NAME="b"))
        _entry_main("lm", argv + ["--steps", "6"],
                    dict(env, KFTPU_JOB_NAME="b6"))
        b6 = [r for r in _records(results, "b6") if "loss" in r]
        resumed = {r["step"]: r["loss"] for r in b6}
        check(sorted(resumed) == [4, 5, 6],
              f"lm entry: the restart logged steps {sorted(resumed)}")
        rel = {s: abs(resumed[s] - losses[s]) / abs(losses[s])
               for s in resumed}
        check(all(r <= 1e-5 for r in rel.values()),
              f"lm entry: resumed {resumed} vs unbroken {losses}")
        # the FLOP probe's cost: the restart's first step runs under the
        # counter in a warm process, against run a's p50 (unprobed)
        return {"losses": losses, "resumed": resumed, "rel_err": rel,
                "probe_step_s": b6[0]["step_p50_step_s"],
                "sample": sample, "draft_loss": draft_loss,
                "tokens_per_s": last["tokens_per_sec"],
                "mfu": last.get("step_mfu"),
                "p50_step_s": last["step_p50_step_s"],
                "p99_step_s": last["step_p99_step_s"],
                "recompiles": last["step_recompiles"], "peak_gb": peak_gb,
                "full_run_s": t_full, "launches": launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phase 15: the LM entry point with MoE ------------------------------------


def lm_moe_phase(device, *, steps=4, size=()):
    """``examples.lm.main --n-experts 8`` (k = 2, dense dispatch) for 4
    steps at the entry point's other defaults. The first step's state
    and batch also go through one forward and backward of the loss the
    step optimizes (LM loss + 0.01 · aux): the aux term must be nonzero
    and the router and every expert's three weights in every layer must
    get a nonzero gradient. Losses finite. ``size`` shrinks the run for
    a rehearsal on the CPU."""
    import math

    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.examples import lm as lm_example
    from kubeflow_tpu_torch.train.trainer import next_token_loss

    seen = {}
    real = lm_example.make_lm_train_step

    def probed(*args, **kw):
        step = real(*args, **kw)

        def run(state, tokens):
            if not seen:
                model = state.module
                toks = torch.as_tensor(tokens, device=state.device)
                out, aux = model(toks, return_aux=True)
                total = next_token_loss(out, toks) + 0.01 * aux
                names = [n for n, _ in model.named_parameters()]
                grads = torch.autograd.grad(total, state.params)
                seen["aux"] = float(aux.detach())
                seen["zero"] = [
                    (n, e) for n, g in zip(names, grads) if ".moe." in n
                    for e in range(g.shape[0] if "router" not in n
                                   else 1)
                    if not bool((g[e] if "router" not in n else g).any())]
                seen["moe_tensors"] = sum(".moe." in n for n in names)
                seen["layers"] = len(model.blocks)
                del out, aux, total, grads
            return step(state, tokens)

        return run

    work = tempfile.mkdtemp(prefix="kftpu-moe-")
    lm_example.make_lm_train_step = probed
    try:
        _reset_peak(device)
        ops.reset_launches()
        _entry_main("lm", ["--device", str(device), *size, "--steps",
                           str(steps), "--n-experts", "8", "--log-every",
                           "1"],
                    {"KFTPU_RESULTS_DIR": work, "KFTPU_JOB_NAME": "moe"})
        launches = ops.launch_counts()
        recs = [r for r in _records(work, "moe") if "loss" in r]
    finally:
        lm_example.make_lm_train_step = real
        shutil.rmtree(work, ignore_errors=True)
    losses = [r["loss"] for r in recs]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"moe: losses {losses}")
    check(seen.get("aux", 0.0) > 0, f"moe: aux term {seen.get('aux')}")
    check(seen["moe_tensors"] == 4 * seen["layers"] and not seen["zero"],
          f"moe: {seen['moe_tensors']} MoE tensors; zero gradients at "
          f"{seen['zero'][:8]}")
    check(not any(launches.values()), f"moe: kernels launched {launches}")
    return {"losses": losses, "aux": seen["aux"],
            "p50_step_s": recs[-1]["step_p50_step_s"],
            "tokens_per_s": recs[-1]["tokens_per_sec"],
            "peak_gb": _peak_gb(device), "launches": launches}


# -- phase 16: speculative serving of phase 14's pair -------------------------


def _spec_request(base, prompts, max_new, **extra):
    body = dict({"prompt_tokens": prompts, "max_new_tokens": max_new},
                **extra)
    t0 = time.perf_counter()
    out, _ = _post(f"{base}/v1/models/lm:generate", body, False)
    return out, time.perf_counter() - t0


def spec_serving_phase(device, store: str, *, n=4, prompt_len=32,
                       max_new=64, draft_len=4, vocab=32000):
    """A ``ModelServer`` over phase 14's store pairs ``lm-draft`` with
    ``lm`` at load. 4 prompts of 32 tokens, 64 new, greedy:

    - f32 (TF32 off; the same weights under f32 configs): the
      ``speculative: true, draft_len: 4`` tokens equal the plain
      request's token for token, the response carries the round stats
      and the four speculative counters move by them; the target as its
      own draft (``speculative_generate_jit``) accepts every proposal
      and gives the same tokens;
    - bf16 (the exports as they are): both requests timed, after one
      warm-up each; exactness is the reference's guarantee at f32 only.
    """
    import numpy as np
    import torch
    import yaml

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models.decode import speculative_generate_jit
    from kubeflow_tpu_torch.serving.model_store import MODEL_FILE
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY

    rng = np.random.default_rng(SEED + 16)
    prompts = rng.integers(0, vocab, (n, prompt_len)).tolist()
    f32 = tempfile.mkdtemp(prefix="kftpu-spec32-")
    counters = {k: DEFAULT_REGISTRY.counter(
        f"kftpu_serving_speculative_{k}_total")
        for k in ("requests", "draft_tokens", "accepted_tokens")}
    out = {}
    try:
        for name in ("lm", "lm-draft"):
            src, dst = (os.path.join(d, name, "1") for d in (store, f32))
            os.makedirs(dst)
            os.link(os.path.join(src, "params.npz"),
                    os.path.join(dst, "params.npz"))
            with open(os.path.join(src, MODEL_FILE)) as f:
                meta = yaml.safe_load(f)
            meta["config"]["dtype"] = "float32"
            with open(os.path.join(dst, MODEL_FILE), "w") as f:
                yaml.safe_dump(meta, f)
        ops.reset_launches()
        for label, root in (("f32", f32), ("bf16", store)):
            server = ModelServer(root, port=0, device=device)
            port = server.start()
            base = f"http://127.0.0.1:{port}"
            try:
                pair = server.repo.get("lm").draft
                check(pair is not None and pair.ref == "lm-draft@1",
                      f"spec {label}: draft pair {pair}")
                before = {k: c.get(model="lm") for k, c in
                          counters.items()}
                spec_kw = dict(speculative=True, draft_len=draft_len)
                if label == "bf16":       # warm-ups, untimed
                    _spec_request(base, prompts, max_new)
                    _spec_request(base, prompts, max_new, **spec_kw)
                plain, t_plain = _spec_request(base, prompts, max_new)
                spec, t_spec = _spec_request(base, prompts, max_new,
                                             **spec_kw)
                st = spec["speculative"]
                check({"rounds", "draft_tokens", "accepted"} <= set(st)
                      and st["draft_tokens"] == st["rounds"] * draft_len,
                      f"spec {label}: stats {st}")
                moved = {k: c.get(model="lm") - before[k]
                         for k, c in counters.items()}
                if label == "f32":
                    check(moved == {"requests": 1,
                                    "draft_tokens": st["draft_tokens"],
                                    "accepted_tokens": st["accepted"]},
                          f"spec f32: counters moved {moved}, stats {st}")
                    check(spec["tokens"] == plain["tokens"],
                          f"spec f32: speculative {spec['tokens']} vs "
                          f"plain {plain['tokens']}")
                    # the target as its own draft: every proposal is
                    # accepted, each round rolls back nothing. As in the
                    # reference, "accepted" sums the rows while
                    # "draft_tokens" counts one row's proposals
                    model = server.repo.get("lm").lm_params
                    toks, perfect = speculative_generate_jit(
                        model, model,
                        torch.tensor(prompts, dtype=torch.int32,
                                     device=device),
                        max_new_tokens=max_new, draft_len=draft_len)
                    check(toks.tolist() == plain["tokens"]
                          and perfect["accepted"]
                          == n * perfect["draft_tokens"] > 0,
                          f"spec f32, perfect draft: {perfect}, "
                          f"{toks.tolist()} vs {plain['tokens']}")
                    out["perfect_draft"] = perfect
                else:       # the warm-up and the timed request
                    check(moved["requests"] == 2,
                          f"spec bf16: counters moved {moved}")
                toks = n * max_new
                out[label] = {
                    "plain_tokens_per_s": toks / t_plain,
                    "spec_tokens_per_s": toks / t_spec,
                    "rounds": st["rounds"], "accepted": st["accepted"],
                    "draft_tokens": st["draft_tokens"],
                    "acceptance_rate": st["acceptance_rate"],
                    "accepted_per_proposal":
                        st["accepted"] / (n * st["draft_tokens"]),
                    "same_tokens": spec["tokens"] == plain["tokens"]}
            finally:
                server.stop()
                del server
        out["launches"] = ops.launch_counts()
        check(not any(out["launches"].values()),
              f"spec: kernels launched {out['launches']}")
        return out
    finally:
        shutil.rmtree(f32, ignore_errors=True)


# -- the request ledger on the serving phases (3 and 9) ----------------------


def fresh_trace(eng):
    """Give ``eng`` a fresh ledger and a tracer into a fresh collector on
    its own clock: (ledger, collector)."""
    from kubeflow_tpu_torch.obs.requests import RequestLedger
    from kubeflow_tpu_torch.obs.trace import SpanCollector, Tracer

    led, col = RequestLedger(), SpanCollector()
    eng.rledger = led
    eng.tracer = Tracer(col, clock=eng.clock)
    return led, col


def ledger_records(led, rids, tokens: int) -> list:
    """The finished records of ``rids``: each tiles its wall clock
    exactly, has prefill and decode seconds and ``tokens`` tokens."""
    from kubeflow_tpu_torch.obs.requests import DECODE, PREFILL, check_tiling

    check(led.live_count() == 0, f"{led.live_count()} records left live")
    by_rid = {r.rid: r for r in led.records()}
    recs = []
    for i, rid in enumerate(rids):
        rec = by_rid.get(rid)
        check(rec is not None, f"request {i}: no ledger record")
        try:
            check_tiling(rec)
        except AssertionError as e:
            raise SmokeFailure(f"request {i}: record does not tile: {e}")
        check(PREFILL in rec.seconds and DECODE in rec.seconds,
              f"request {i}: phases {sorted(rec.seconds)}")
        check(rec.tokens == tokens,
              f"request {i}: {rec.tokens} tokens recorded, not {tokens}")
        recs.append(rec)
    return recs


def ledger_p50(recs) -> dict:
    """Median seconds of each phase over the records that have it."""
    phases = sorted({p for r in recs for p in r.seconds})
    return {p: round(statistics.median(r.seconds[p] for r in recs
                                       if p in r.seconds), 6)
            for p in phases}


def admission_loop_s(led, wave) -> tuple:
    """Host seconds of the engine's per-member admission loop
    (``serving/engine.py:_admit_batch``, its ``_emit_first`` calls,
    which put every member's first token before any member's spans) as
    the wave saw it: from a member's batch stamp (the ledger's
    first emit, one stamp a batch) to its first token's queue put, both
    on the engine's clock. Returns (the gap of the member whose first
    token reached its queue last, the 32nd; the largest gap)."""
    gaps = [r.out.first_put_engine - (r.t_submit + led.ttft_ms(r.rid) / 1e3)
            for r in wave]
    last = max(range(len(wave)), key=lambda i: wave[i].out.first_put)
    return gaps[last], max(gaps)


def ledger_burst_ttft_ms(led, wave) -> float:
    """The reference bench's burst TTFT off the ledger
    (``bench/suite.py:ledger_burst_ttft_ms``): wall from the wave's first
    submit until every member held its first token."""
    ttfts = [led.ttft_ms(r.rid) for r in wave]
    check(all(f is not None for f in ttfts), "a wave member has no TTFT")
    return (max(r.t_submit + f / 1e3 for r, f in zip(wave, ttfts))
            - min(r.t_submit for r in wave)) * 1e3


# -- phase 17: :predict for every servable kind through one ModelServer ------


# calls a kind for its p50s: cut from 5 to 3 with phase 26 added
PREDICT_CALLS = 3
PREDICT_BUCKETS = (1, 2, 4, 8)
# bench/suite.py:bench_resnet50's widths and dtypes, the serving stem
RESNET_SERVING = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000, width=64,
                      dtype="bfloat16", param_dtype="float32",
                      bn_dtype="bfloat16", stem="conv")
# bench/suite.py:bench_bert's widths (BERT-base)
BERT_SERVING = dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12,
                    d_ff=3072, max_seq_len=512, dtype="bfloat16",
                    param_dtype="float32", attention_impl="auto")


def randomized_bn(variables, seed):
    """ResNet variables with every BN scale near one (bn3's too, which
    the reference's init zeroes, so that the fused layer's output is not
    multiplied away), shifts and running means small, running variances
    in [0.5, 1.5)."""
    import numpy as np

    from kubeflow_tpu_torch.models import convert

    rng = np.random.default_rng(seed)
    flat = convert.flatten(variables)
    for key, arr in flat.items():
        if key.endswith("/scale"):
            arr = 1.0 + 0.2 * rng.standard_normal(arr.shape)
        elif key.endswith("/bias") or key.endswith("/mean"):
            arr = 0.1 * rng.standard_normal(arr.shape)
        elif key.endswith("/var"):
            arr = 0.5 + rng.random(arr.shape)
        flat[key] = np.asarray(arr, np.float32)
    return convert.unflatten(flat)


def resnet_serving_variables():
    """Fused-layout ResNet-50 variables (conv stem) from a numpy seed."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig

    cfg = ResNetConfig(**{**RESNET_SERVING, "stage_sizes":
                          tuple(RESNET_SERVING["stage_sizes"])},
                       fused_bn_conv=True)
    return randomized_bn(convert.random_resnet_params(cfg, SEED + 70),
                         SEED + 71)


def write_predict_store(root: str, base: str, image: int = 224) -> None:
    """``mnist``; ResNet-50 fused (``resnet50``) and the same weights
    unfused (``resnet50u``); BERT-base (``bert``); and phase 3's LM
    export (``lm``, linked), all random from numpy seeds and written by
    the port's ``export_model``."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.serving.model_store import export_model

    os.makedirs(root, exist_ok=True)
    export_model(os.path.join(root, "mnist"), "mnist",
                 convert.random_mnist_params(SEED + 72))
    variables = resnet_serving_variables()
    shape = (image, image, 3)
    export_model(os.path.join(root, "resnet50"), "resnet", variables,
                 config=dict(RESNET_SERVING, fused_bn_conv=True),
                 input_shape=shape)
    export_model(os.path.join(root, "resnet50u"), "resnet",
                 convert.unfuse_bn_conv(variables),
                 config=dict(RESNET_SERVING, fused_bn_conv=False),
                 input_shape=shape)
    export_model(os.path.join(root, "bert"), "bert",
                 convert.random_bert_params(BertConfig(**BERT_SERVING),
                                            SEED + 73),
                 config=BERT_SERVING)
    os.symlink(os.path.join(base, "lm"), os.path.join(root, "lm"))


def _post_raw(url, raw: bytes) -> tuple:
    """(status, response bytes, seconds) of one POST of an encoded body,
    an HTTP error's included; the seconds end when the response's last
    byte is read (the client's own JSON work lies outside)."""
    req = urllib.request.Request(url, data=raw, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            code, data = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    return code, data, time.perf_counter() - t0


def _post_status(url, body) -> tuple:
    """(status, JSON body) of one POST, an HTTP error's included."""
    code, data, _ = _post_raw(url, json.dumps(body).encode())
    return code, json.loads(data)


def predict_split(loaded, raw: bytes, max_batch: int) -> dict:
    """One request's server-side work in process, split as the handler
    runs it: JSON decode (and the f32 cast and batch padding), host to
    device, the forward (CUDA events), device to host, JSON encode."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.serving.server import _pad_batch

    t0 = time.perf_counter()
    arr = np.asarray(json.loads(raw)["instances"])
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    padded, n = _pad_batch(arr, max_batch)
    t1 = time.perf_counter()
    x = torch.as_tensor(padded).to(loaded.device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    y = loaded.forward(x)
    end.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out = y.float().cpu().numpy()[:n]
    t4 = time.perf_counter()
    json.dumps({"predictions": out.tolist(),
                "model_version": str(loaded.version)})
    t5 = time.perf_counter()
    return {"decode_ms": (t1 - t0) * 1e3, "h2d_ms": (t2 - t1) * 1e3,
            "forward_ms": start.elapsed_time(end),
            "forward_wall_ms": (t3 - t2) * 1e3, "d2h_ms": (t4 - t3) * 1e3,
            "encode_ms": (t5 - t4) * 1e3}


def counted(totals: dict, fn, *, want=None):
    """``fn()`` with the launch counts zeroed just before it and read just
    after, added into ``totals`` (the predict path's record); the call
    must launch ``want`` (kernel: count). Returns ``fn()``'s result."""
    from kubeflow_tpu_torch import ops

    ops.reset_launches()
    result = fn()
    launched = ops.launch_counts()
    for kern, n in launched.items():
        totals[kern] += n
    for kern, n in (want or {}).items():
        check(launched[kern] == n,
              f"a :predict call launched {kern} {launched[kern]} times, "
              f"not {n}")
    return result


def predict_timed(server, url, name, body, totals, want) -> dict:
    """``PREDICT_CALLS`` HTTP calls of one body through :func:`counted`:
    request wall p50, the in-process split's p50s and peak memory."""
    import torch

    raw = json.dumps(body).encode()
    loaded = server.repo.get(name)
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(PREDICT_CALLS):
        code, data, wall = counted(totals, lambda: _post_raw(url, raw),
                                   want=want)
        walls.append(wall)
        check(code == 200, f"{name} :predict answered {code}: "
                           f"{data[:300]!r}")
    last = json.loads(data)
    peak = torch.cuda.max_memory_allocated()
    splits = [predict_split(loaded, raw, server.max_batch_size)
              for _ in range(PREDICT_CALLS)]
    out = {"wall_ms": statistics.median(walls) * 1e3,
           "request_mb": len(raw) / 2 ** 20,
           "peak_gb": peak / 2 ** 30,
           "transient_gb": (peak - base_bytes) / 2 ** 30,
           "predictions": last["predictions"]}
    for key in splits[0]:
        out[key] = statistics.median(s[key] for s in splits)
    return out


def check_predict_kernels(device) -> dict:
    """The bnconv forward and the flash forward at the shapes ``:predict``
    gives them, under ``torch.inference_mode`` (no autograd): bnconv at
    the four ResNet-50 sites at batch 1 (M = 3136, 784, 196, 49: no
    multiple of the 128-row tile but the first), batch 8 and phase 24's
    ``run_batch_predict`` chunk (``BATCH_PREDICT_BATCH``), flash at
    BERT-base's (1, 128) and (8, 512), non-causal; bf16 against the plain
    versions at phase 2's limits, then timed beside bound and plain
    version; bnconv beside a bf16 ``torch.matmul`` of a precomputed y
    (``matmul_ms``, for scale: no PyTorch call computes the function),
    flash beside ``scaled_dot_product_attention`` (``library_ms``).
    Per-call figures sum the 16 bnconv sites; flash is one layer's
    call."""
    import torch

    from kubeflow_tpu_torch.ops import bnconv as bc
    from kubeflow_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    out = {}
    with torch.inference_mode():
        for batch in (1, 8, BATCH_PREDICT_BATCH):
            acc = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                       ops_ms=0.0, matmul_ms=0.0, max_abs_err=0.0)
            for seed, (M, K, N, blocks) in enumerate(RESNET50_SITES,
                                                     SEED + 80):
                M = M // RESNET_BATCH * batch
                x, a, b, w, _ = bnconv_inputs(M, K, N, bf, device, seed)
                got = bc.bnconv_fwd(x, a, b, w)
                want = bc.bnconv_fwd_plain(x, a, b, w)
                torch.cuda.synchronize()
                rel = norm_err(got, want)
                check(bool(torch.isfinite(got.float()).all())
                      and rel <= BNCONV_BF16_LIMIT,
                      f"bnconv_fwd inference ({M}, {K}, {N}): norm err "
                      f"{rel} > {BNCONV_BF16_LIMIT}")
                acc["max_abs_err"] = max(acc["max_abs_err"], (
                    got.float() - want.float()).abs().max().item())
                y = bc.activation(x, a, b)
                nbytes, flops = bnconv_bytes_ops(M, K, N, 2)["bnconv_fwd"]
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / BF16_FLOPS * 1e3
                ms = time_ms(lambda: bc.bnconv_fwd(x, a, b, w))
                plain_ms = time_ms(lambda: bc.bnconv_fwd_plain(x, a, b, w),
                                   iters=5)
                matmul_ms = time_ms(lambda: torch.matmul(y, w))
                print(f"bnconv_fwd inference bf16 ({M}, {K}, {N}), batch "
                      f"{batch}: norm err {rel:.2e} kernel_ms={ms:.4f} "
                      f"bound_ms={max(t_bytes, t_ops):.4f} ({nbytes} B) "
                      f"plain_ms={plain_ms:.4f} bf16 matmul of y alone "
                      f"{matmul_ms:.4f}", flush=True)
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", max(t_bytes, t_ops)),
                                 ("bytes_ms", t_bytes), ("ops_ms", t_ops),
                                 ("matmul_ms", matmul_ms)):
                    acc[key] += blocks * val
            acc["bound_by"] = ("bytes" if acc.pop("bytes_ms")
                               >= acc.pop("ops_ms") else "operations")
            out[f"bnconv_fwd_b{batch}"] = acc
            print(f"bnconv_fwd inference per call (16 sites), batch "
                  f"{batch}: kernel_ms={acc['ms']:.4f} bound_ms="
                  f"{acc['bound_ms']:.4f} plain_ms={acc['plain_ms']:.4f} "
                  f"matmul of y alone {acc['matmul_ms']:.4f}", flush=True)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for seed, (B, S) in enumerate(((1, 128), (8, 512)), SEED + 90):
            H, D = 12, 64
            q, k, v, _, _ = flash_inputs(B, S, H, D, bf, device, seed,
                                         masked=False)
            got, lse = fa.flash_fwd(q, k, v, causal=False)
            want, want_lse = fa.flash_fwd_plain(q, k, v, causal=False)
            torch.cuda.synchronize()
            rel = norm_err(got, want)
            lse_err = (lse - want_lse).abs().max().item()
            check(rel <= FLASH_BF16_NORM_LIMIT and lse_err <= 1e-5,
                  f"flash_fwd inference ({B}, {S}): norm err {rel}, lse "
                  f"err {lse_err}")
            nbytes, flops = flash_bytes_ops(B, S, H, D, 2,
                                            False)["flash_fwd"]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            rec = {"max_abs_err": (got.float() - want.float()).abs().max()
                   .item(),
                   "ms": time_ms(lambda: fa.flash_fwd(q, k, v,
                                                      causal=False)),
                   "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                       q, k, v, causal=False), iters=5),
                   "library_ms": time_ms(lambda: sdpa(qt, kt, vt,
                                                      is_causal=False)),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations"}
            out[f"flash_fwd_b{B}_s{S}"] = rec
            print(f"flash_fwd inference bf16 non-causal B={B} S={S} H=12 "
                  f"D=64: norm err {rel:.2e} kernel_ms={rec['ms']:.4f} "
                  f"(mma.sync design: {FLASH_FWD_MMA_MS[(B, S)]}; first "
                  f"wgmma design: {FLASH_FWD_WGMMA1_MS[(B, S)]}) "
                  f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
                  f"plain_ms={rec['plain_ms']:.4f} library_ms="
                  f"{rec['library_ms']:.4f} (scaled_dot_product_attention)",
                  flush=True)
    torch.cuda.empty_cache()
    return out


def predict_phase(device, base: str, *, image: int = 224,
                  bert_big=(8, 512)) -> dict:
    """Phase 17: one ``ModelServer`` (``warmup=True``) over
    :func:`write_predict_store`'s exports answers ``:predict`` for every
    kind, each call's launches checked (bnconv forward 16 a fused
    ResNet-50 call, flash forward 12 a BERT-base call, no backward
    kernel ever); the LM's last-position argmax equals the greedy first
    token of ``:generate``; a wrong shape answers 400 and an id past the
    vocabulary the reference's NaN row, the card serving on after it.
    ``image`` and ``bert_big`` (and the module's ``RESNET_SERVING`` and
    ``BERT_SERVING``) shrink for a rehearsal on the CPU."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.serving.model_store import build_model
    from kubeflow_tpu_torch.serving.server import ModelServer

    root = os.path.join(base, "predict-store")
    t0 = time.perf_counter()
    write_predict_store(root, base, image)
    export_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    server = ModelServer(root, port=0, warmup=True, poll_interval_s=3600,
                         device=device)
    load_s = time.perf_counter() - t0
    port = server.start()

    def url(name, verb="predict"):
        return f"http://127.0.0.1:{port}/v1/models/{name}:{verb}"

    totals = dict.fromkeys(ops.launch_counts(), 0)
    none = {k: 0 for k in totals}
    # off the card the wrappers take their plain versions: no launches
    on_card = torch.device(device).type == "cuda"
    fused_call = dict(none, bnconv_fwd=16 * on_card)
    bert_call = dict(none, flash_fwd=12 * on_card)
    res = {"export_s": export_s, "load_s": load_s, "kinds": {}}
    try:
        warmed = server.repo.warmed
        want_warm = {("mnist", 1): 4, ("resnet50", 1): 4,
                     ("resnet50u", 1): 4, ("bert", 1): 0, ("lm", 1): 0}
        check(server.repo.warmup_batches == PREDICT_BUCKETS
              and warmed == want_warm,
              f"warm-up: {warmed} != {want_warm} over "
              f"{server.repo.warmup_batches}")
        rng = np.random.default_rng(SEED + 74)

        # mnist at batch 1, 3 and 8 (3 pads to the 4 bucket), held
        # against the same weights on the CPU
        mnist_cpu = convert.load_servable(
            "mnist", build_model("mnist", {})[0],
            convert.flatten(convert.random_mnist_params(SEED + 72)),
            device="cpu")
        for n in (1, 3, 8):
            x = rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
            code, body = counted(totals, lambda: _post_status(
                url("mnist"), {"instances": x.tolist()}), want=none)
            check(code == 200, f"mnist batch {n}: {code} {body}")
            got = np.asarray(body["predictions"], np.float32)
            with torch.no_grad():
                want = mnist_cpu(torch.from_numpy(x)).numpy()
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            check(got.shape == (n, 10) and err <= 2e-3 * scale,
                  f"mnist batch {n}: shape {got.shape}, max err {err} "
                  f"(of {scale}; TF32 convolutions allowed)")
        res["kinds"]["mnist 8"] = predict_timed(
            server, url("mnist"), "mnist", {"instances": x.tolist()},
            totals, none)

        images = rng.standard_normal((8, image, image, 3)).astype(
            np.float32)
        body = {"instances": images.tolist()}
        fused = predict_timed(server, url("resnet50"), "resnet50", body,
                              totals, fused_call)
        unfused = predict_timed(server, url("resnet50u"), "resnet50u", body,
                                totals, none)
        lf = np.asarray(fused["predictions"], np.float32)
        lu = np.asarray(unfused["predictions"], np.float32)
        classes = RESNET_SERVING["num_classes"]
        check(lf.shape == lu.shape == (8, classes) and np.isfinite(lf).all()
              and np.isfinite(lu).all(), f"resnet logits {lf.shape}")
        res["resnet_bf16_rel"] = float(np.abs(lf - lu).max()
                                       / np.abs(lu).max())
        res["resnet_bf16_top1_same"] = int(
            (lf.argmax(1) == lu.argmax(1)).sum())
        res["kinds"]["resnet50 fused 8"] = fused
        res["kinds"]["resnet50 unfused 8"] = unfused
        code, body = counted(totals, lambda: _post_status(
            url("resnet50"), {"instances": images[:2, :image // 2].tolist()}),
            want=none)
        check(code == 400, f"wrong-shaped resnet request: {code} {body}")

        V = BERT_SERVING["vocab_size"]
        toks = rng.integers(0, V, (1, 128))
        bert = predict_timed(server, url("bert"), "bert",
                             {"instances": toks.tolist()}, totals,
                             bert_call)
        lb = np.asarray(bert["predictions"], np.float32)
        check(lb.shape == (1, 128, V) and np.isfinite(lb).all(),
              f"bert logits {lb.shape}")
        res["kinds"]["bert 1x128"] = bert
        loaded = server.repo.get("bert")
        big = rng.integers(0, V, bert_big)
        t0 = time.perf_counter()
        lbig = counted(totals, lambda: loaded.predict(big), want=bert_call)
        res["bert_8x512_predict_s"] = time.perf_counter() - t0
        check(lbig.shape == (*bert_big, V) and np.isfinite(lbig).all(),
              f"bert {bert_big} logits {lbig.shape}")
        del lbig
        # an id past the vocabulary: the reference's jnp.take reads a NaN
        # row, and every logit of that sequence is NaN (attention is
        # bidirectional); no device assert: the card serves on
        bad = toks.copy()
        bad[0, 5] = V
        code, body = counted(totals, lambda: _post_status(
            url("bert"), {"instances": np.concatenate(
                [bad, toks]).tolist()}), want=bert_call)
        check(code == 200, f"bert out-of-vocabulary id: {code} {body}")
        lnan = np.asarray(body["predictions"], np.float32)
        check(np.isnan(lnan[0]).all() and np.isfinite(lnan[1]).all(),
              "bert out-of-vocabulary id: not the reference's answer (a "
              "NaN sequence beside a finite one)")
        code, body = counted(totals, lambda: _post_status(
            url("bert"), {"instances": toks.tolist()}), want=bert_call)
        torch.cuda.synchronize()
        check(code == 200 and np.isfinite(
            np.asarray(body["predictions"], np.float32)).all(),
            f"bert after the out-of-vocabulary id: {code}")

        lm_vocab = server.repo.get("lm").vocab_size
        prompts = rng.integers(0, lm_vocab, (2, 64))
        lm = predict_timed(server, url("lm"), "lm",
                           {"instances": prompts.tolist()}, totals, none)
        ll = np.asarray(lm["predictions"], np.float32)
        check(ll.shape == (2, 64, lm_vocab) and np.isfinite(ll).all(),
              f"lm logits {ll.shape}")
        code, body = counted(totals, lambda: _post_status(
            url("lm", "generate"), {"prompt_tokens": prompts.tolist(),
                                    "max_new_tokens": 1}), want=none)
        check(code == 200, f"lm :generate {code} {body}")
        first = [row[0] for row in body["tokens"]]
        top = ll[:, -1].argmax(-1).tolist()
        gaps = [float(np.diff(np.sort(r)[-2:])[0]) for r in ll[:, -1]]
        check(first == top, f"lm: :predict argmax {top} != :generate's "
                            f"first tokens {first} (top-2 gaps {gaps})")
        res["lm_first_tokens"] = first
        res["lm_top2_gaps"] = gaps
        res["kinds"]["lm 2x64"] = lm
    finally:
        server.stop()
    for r in res["kinds"].values():
        r.pop("predictions")
    res["launches"] = totals
    return res


def predict_parity_phase(device, *, image: int = 224) -> dict:
    """Phase 18, f32 with TF32 off: ResNet-50 fused against unfused from
    the same weights (the same top-1 for 8 images, logits within 1e-4 of
    their max-abs) and BERT-base flash against dense from the same
    weights (logits within 1e-5), each through ``build_model`` and the
    store's loader, the kernels launching on the fused and flash runs
    only."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.serving.model_store import LoadedModel, \
        build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def serve(kind, cfg, flat):
        module, apply = build_model(kind, cfg)
        module = convert.load_servable(kind, module, flat, device=device)
        return LoadedModel(kind=kind, version=1, module=module, apply=apply)

    out = {}
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(SEED + 75)
    variables = resnet_serving_variables()
    f32 = dict(RESNET_SERVING, dtype="float32", bn_dtype="float32")
    images = rng.standard_normal((8, image, image, 3)).astype(np.float32)
    logits = {}
    for fused in (True, False):
        v = variables if fused else convert.unfuse_bn_conv(variables)
        model = serve("resnet", dict(f32, fused_bn_conv=fused),
                      convert.flatten(v))
        ops.reset_launches()
        logits[fused] = model.predict(images)
        n = ops.launch_counts()["bnconv_fwd"]
        check(n == (16 if fused and on_card else 0),
              f"f32 resnet fused={fused}: "
                                         f"bnconv_fwd launched {n}")
        del model
        torch.cuda.empty_cache()
    scale = float(np.abs(logits[False]).max())
    err = float(np.abs(logits[True] - logits[False]).max())
    same = (logits[True].argmax(1) == logits[False].argmax(1))
    check(bool(same.all()), f"f32 resnet fused/unfused top-1 differs: "
                            f"{same.tolist()}")
    check(err <= 1e-4 * scale, f"f32 resnet fused/unfused max err {err} > "
                               f"1e-4 x {scale}")
    out["resnet"] = {"max_err": err, "max_abs": scale}
    bcfg = dict(BERT_SERVING, dtype="float32")
    flat = convert.random_bert_params(BertConfig(**bcfg), SEED + 76)
    toks = rng.integers(0, bcfg["vocab_size"], (2, 128))
    for impl in ("flash", "dense"):
        model = serve("bert", dict(bcfg, attention_impl=impl), flat)
        ops.reset_launches()
        logits[impl] = model.predict(toks)
        n = ops.launch_counts()["flash_fwd"]
        check(n == (12 if impl == "flash" and on_card else 0),
              f"f32 bert {impl}: flash_fwd launched {n}")
        del model
        torch.cuda.empty_cache()
    err = float(np.abs(logits["flash"] - logits["dense"]).max())
    scale = float(np.abs(logits["dense"]).max())
    check(err <= 1e-5, f"f32 bert flash/dense max err {err} > 1e-5 (logits "
                       f"max-abs {scale})")
    out["bert"] = {"max_err": err, "max_abs": scale}
    return out


# -- phase 19: the image-classification entry points -------------------------


IMAGE_ENTRY_STEPS = 6
SHARD_RECORDS = 256
MNIST_ACCURACY_FLOOR = 0.9     # chance is 0.1; the CPU run reaches 1.0


def _image_run(device, module, argv, results, job, batch) -> dict:
    """One entry-point run: its result, every step's loss (warm-up steps
    included, read after the run from the step function's metrics),
    images/s and ms a step of the timed window, and peak device memory
    (and the peak less what was allocated before the run)."""
    import importlib

    import torch

    mod = importlib.import_module(f"kubeflow_tpu_torch.examples.{module}")
    make = mod.make_image_train_step
    seen = []

    def spied(*args):
        step = make(*args)

        def run(*a):
            state, m = step(*a)
            seen.append(m["loss"])
            return state, m
        return run

    _reset_peak(device)
    base_gb = (torch.cuda.memory_allocated() / 1e9
               if torch.device(device).type == "cuda" else 0.0)
    mod.make_image_train_step = spied
    t0 = time.perf_counter()
    try:
        result = _entry_main(module, [*argv, "--device", str(device)],
                             {"KFTPU_RESULTS_DIR": results,
                              "KFTPU_JOB_NAME": job})
    finally:
        mod.make_image_train_step = make
    wall = time.perf_counter() - t0
    recs = _records(results, job)
    losses = [float(x) for x in seen]
    check(losses and all(x == x and abs(x) != float("inf")
                         for x in losses),
          f"{job}: losses {losses}")
    out = {"result": result, "losses": losses, "wall_s": wall,
           "peak_gb": _peak_gb(device),
           "run_peak_gb": _peak_gb(device) - base_gb}
    final = [r for r in recs if r.get("final")]
    if final:
        out["images_per_s"] = final[-1]["images_per_sec"]
    else:   # mnist logs no rate: its log lines' clock between the first
        first, last = recs[0], recs[-1]      # and the last record
        out["images_per_s"] = ((last["step"] - first["step"]) * batch
                               / (last["ts"] - first["ts"]))
    out["step_ms"] = batch / out["images_per_s"] * 1e3
    return out


def write_image_shards(path: str, n: int, image: int,
                       classes: int) -> int:
    """``n`` records of ``[label, pixels...]`` (``image``² x 3 normal
    pixels, labels in [0, ``classes``)) from a numpy seed, in two shards;
    returns the bytes written."""
    import numpy as np

    from kubeflow_tpu_torch.data import write_shards

    rng = np.random.default_rng(SEED + 19)
    recs = np.empty((n, image * image * 3 + 1), np.float32)
    recs[:, 0] = rng.integers(0, classes, n)
    recs[:, 1:] = rng.standard_normal((n, image * image * 3),
                                      dtype=np.float32)
    write_shards(path, recs, shards=2)
    return recs.nbytes


def image_entry_phase(device, *, resnet=(), vit=(), mnist=(), image=224,
                      classes=1000, shards=SHARD_RECORDS,
                      batch=(128, 64, 128)) -> dict:
    """Phase 19: ``examples.resnet.main`` (ResNet-50, 224², batch 128;
    synthetic, then from shards through the native loader and the device
    feed), ``examples.vit.main`` (ViT-B/16 at its defaults) and
    ``examples.mnist.main`` (its defaults: 100 steps of 128) on
    ``device``. The synthetic runs' losses start near ln(classes) and
    fall (warm-up steps included); MNIST's accuracy
    clears :data:`MNIST_ACCURACY_FLOOR`; the shard run's loader is
    native. None of the seven kernels launches (the reference's default
    configurations: ResNet unfused, ViT's dense attention). ``resnet``,
    ``vit``, ``mnist``, ``image``, ``classes``, ``shards`` and ``batch``
    shrink for a rehearsal on the CPU."""
    import math

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.examples import resnet as resnet_example

    results = tempfile.mkdtemp(prefix="kftpu-images-")
    steps = ["--steps", str(IMAGE_ENTRY_STEPS), "--log-every", "1"]
    out = {}
    try:
        ops.reset_launches()
        r = _image_run(device, "resnet", [*steps, *resnet], results,
                       "resnet", batch[0])
        check(abs(r["losses"][0] - math.log(classes)) <= 1.5
              and r["losses"][-1] < r["losses"][0],
              f"resnet entry: loss did not fall from ln({classes}): "
              f"{r['losses']}")
        out["resnet"] = r
        data_dir = os.path.join(results, "shards")
        t0 = time.perf_counter()
        nbytes = write_image_shards(data_dir, shards, image, classes)
        write_s = time.perf_counter() - t0
        native = []
        real_loader = resnet_example.DataLoader

        def loader(*a, **kw):
            made = real_loader(*a, **kw)
            native.append(made.native)
            return made

        resnet_example.DataLoader = loader
        try:
            # the default --log-every (10): no loss read a step, so the
            # feed's host work for batch k+1 overlaps step k on the card
            r = _image_run(device, "resnet",
                           ["--steps", str(IMAGE_ENTRY_STEPS), *resnet,
                            "--data-dir", data_dir],
                           results, "resnet-shards", batch[0])
        finally:
            resnet_example.DataLoader = real_loader
        check(native == [True], f"resnet from shards: native loader "
                                f"{native} (the Python twin ran)")
        r.update(shard_mb=nbytes / 1e6, shard_write_s=write_s)
        out["resnet_shards"] = r
        r = _image_run(device, "vit", [*steps, *vit], results, "vit",
                       batch[1])
        check(abs(r["losses"][0] - math.log(classes)) <= 1.5
              and r["losses"][-1] < r["losses"][0],
              f"vit entry: loss did not fall from ln({classes}): "
              f"{r['losses']}")
        out["vit"] = r
        r = _image_run(device, "mnist", list(mnist), results, "mnist",
                       batch[2])
        check(r["result"] >= MNIST_ACCURACY_FLOOR,
              f"mnist entry: final accuracy {r['result']} < "
              f"{MNIST_ACCURACY_FLOOR}")
        out["mnist"] = r
        launches = ops.launch_counts()
        check(not any(launches.values()),
              f"image entry points launched kernels: {launches}")
        out["launches"] = launches
    finally:
        shutil.rmtree(results, ignore_errors=True)
    return out


# -- phase 20: the gRPC service's core on the card ----------------------------


GRPC_CALLS = 5


def _p50(fn, calls=GRPC_CALLS):
    """(p50 seconds, last result) of ``calls`` calls of ``fn``."""
    times, res = [], None
    for _ in range(calls):
        t0 = time.perf_counter()
        res = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), res


def grpc_split(model, arr, max_batch: int, totals: dict, want, *,
               tokens: bool = False) -> dict:
    """``Predict``'s core on one request, each part timed alone (p50):
    binary decode, the integer cast and padding, ``LoadedModel.predict``
    (host to device, forward, device to host; the forward also by CUDA
    events), binary encode; then the whole of ``predict_tensor``, its
    launches counted a call. Token ids (``tokens``) skip ``Predict``'s
    integer cast, which refuses them as the reference does: they are
    padded and run through the ``LoadedModel.predict`` REST runs.
    Returns the split and the decoded outputs."""
    import torch

    from kubeflow_tpu_torch.serving import grpc_server as gs
    from kubeflow_tpu_torch.serving.server import _pad_batch

    def prepare(a):
        return (_pad_batch(a, max_batch) if tokens
                else gs.predict_inputs(model, a, max_batch))

    def whole():
        if not tokens:
            return gs.predict_tensor(model, data, dtype, shape, max_batch)
        return gs.encode_array(gs.run_predict(model, *prepare(
            gs.decode_array(data, dtype, shape))))

    data, dtype, shape = gs.encode_array(arr)
    decode_s, got = _p50(lambda: gs.decode_array(data, dtype, shape))
    prep_s, (padded, n) = _p50(lambda: prepare(got))
    predict_s, out = _p50(lambda: counted(
        totals, lambda: gs.run_predict(model, padded, n), want=want))
    x = torch.as_tensor(padded).to(model.device)
    events = []
    for _ in range(GRPC_CALLS):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        counted(totals, lambda: model.forward(x), want=want)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    forward_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    encode_s, (odata, odtype, oshape) = _p50(lambda: gs.encode_array(out))
    wall_s, res = _p50(lambda: counted(totals, whole, want=want))
    check(res == (odata, odtype, oshape),
          "the core's response differs from its parts'")
    return {"request_mb": len(data) / 2 ** 20,
            "response_mb": len(odata) / 2 ** 20,
            "decode_ms": decode_s * 1e3, "prep_ms": prep_s * 1e3,
            "predict_ms": predict_s * 1e3, "forward_ms": forward_ms,
            "encode_ms": encode_s * 1e3, "wall_ms": wall_s * 1e3,
            "outputs": gs.decode_array(odata, odtype, oshape)}


def grpc_core_phase(device, root: str, *, image=224,
                    bert_shape=(1, 128)) -> dict:
    """Phase 20: the gRPC ``Predict`` core without the transport (this
    machine has no ``grpc``/``protobuf``) over phase 17's exports
    (``root``) on ``device``: ResNet-50 fused at batch 8 with f32 and
    with uint8 pixels, and a bf16 pixel batch, through
    ``predict_tensor``'s parts; BERT-base at (1, 128) through the binary
    codec and the ``LoadedModel.predict`` the REST path runs (its int32
    tokens through ``Predict`` itself are refused, INVALID_ARGUMENT, as
    the reference refuses them: the integer cast makes them floats); a
    bf16 tensor round trip bit for bit. Every output equals the REST
    ``:predict``'s on the same inputs (a ``ModelServer`` over the same
    exports); the bnconv forward launches 16 times a ResNet call and the
    flash forward 12 times a BERT call. Where ``grpc`` imports, the
    service also runs ``Predict`` and ``Generate`` through
    ``PredictClient``."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving import grpc_server as gs
    from kubeflow_tpu_torch.serving.server import ModelServer

    on_card = torch.device(device).type == "cuda"
    totals = dict.fromkeys(ops.launch_counts(), 0)
    none = dict(totals)
    calls = {"resnet50": dict(none, bnconv_fwd=16 * on_card),
             "bert": dict(none, flash_fwd=12 * on_card)}
    server = ModelServer(root, port=0, poll_interval_s=3600, device=device)
    port = server.start()
    res = {"cases": {}}

    def rest(name, arr):
        code, body = counted(totals, lambda: _post_status(
            f"http://127.0.0.1:{port}/v1/models/{name}:predict",
            {"instances": arr.tolist()}), want=calls[name])
        check(code == 200, f"REST {name}: {code} {body}")
        return np.asarray(body["predictions"], np.float32)

    try:
        rng = np.random.default_rng(SEED + 20)
        images = rng.standard_normal((8, image, image, 3)).astype(
            np.float32)
        pixels = rng.integers(0, 256, (8, image, image, 3)).astype(np.uint8)
        bf = torch.from_numpy(images).to(torch.bfloat16)
        bert = server.repo.get("bert")
        toks = rng.integers(0, bert.module.config.vocab_size,
                            bert_shape).astype(np.int32)
        data, dtype, shape = gs.encode_array(toks)
        try:
            gs.predict_tensor(bert, data, dtype, shape,
                              server.max_batch_size)
            refused = None
        except gs.RpcFault as e:
            refused = e.code
        check(refused == "INVALID_ARGUMENT",
              f"bert int32 tokens through Predict: {refused}, not the "
              f"reference's INVALID_ARGUMENT")
        res["bert_refused"] = refused
        # (label, model, wire tensor, the same values as REST sends them)
        for label, name, arr, plain in (
                ("resnet50 fused 8 f32", "resnet50", images, images),
                ("resnet50 fused 8 uint8", "resnet50", pixels, pixels),
                ("resnet50 fused 8 bf16", "resnet50", bf,
                 bf.float().numpy()),
                ("bert 1x128", "bert", toks, toks)):
            r = grpc_split(server.repo.get(name), arr,
                           server.max_batch_size, totals, calls[name],
                           tokens=name == "bert")
            got = r.pop("outputs")
            want = rest(name, plain)
            check(got.dtype == np.float32 and got.shape == want.shape
                  and np.array_equal(got, want),
                  f"{label}: binary outputs differ from REST's by "
                  f"{np.abs(got - want).max()}")
            res["cases"][label] = r
        # the last case's (BERT's) logits, 64 positions, as bf16
        logits = torch.from_numpy(got[0, :64]).to(device, torch.bfloat16)
        back = gs.decode_array(*gs.encode_array(logits))
        check(back.dtype == torch.bfloat16 and torch.equal(
            back.view(torch.int16), logits.cpu().view(torch.int16)),
            "bf16 round trip: bits changed")
        res["bf16_round_trip"] = tuple(back.shape)
        try:
            import grpc
        except ImportError as e:
            res["transport"] = (f"not run: grpc is not importable here "
                                f"({e})")
        else:
            res["transport"] = (f"grpc {grpc.__version__}: " +
                                grpc_transport(server, images, totals,
                                               calls["resnet50"]))
    finally:
        server.stop()
    res["launches"] = totals
    return res


def grpc_transport(server, images, totals, fused_call) -> str:
    """``serve_grpc`` over ``server``'s repository: ``Predict`` of the
    8 images equal to REST's and ``Generate`` of the LM equal to REST's
    ``:generate``."""
    import numpy as np

    from kubeflow_tpu_torch.serving import grpc_server as gs

    srv, port = gs.serve_grpc(server.repo, 0)
    client = gs.PredictClient(f"127.0.0.1:{port}")
    try:
        out, _ = counted(totals, lambda: client.predict("resnet50", images),
                         want=fused_call)
        code, body = _post_status(
            f"http://127.0.0.1:{server.port}/v1/models/resnet50:predict",
            {"instances": images.tolist()})
        check(code == 200 and np.array_equal(
            out, np.asarray(body["predictions"], np.float32)),
            "gRPC Predict differs from REST")
        prompts = np.arange(16, dtype=np.int32).reshape(2, 8) + 5
        toks, _ = client.generate("lm", prompts, max_new_tokens=8)
        code, body = _post_status(
            f"http://127.0.0.1:{server.port}/v1/models/lm:generate",
            {"prompt_tokens": prompts.tolist(), "max_new_tokens": 8})
        check(code == 200 and toks.tolist() == body["tokens"],
              f"gRPC Generate {toks.tolist()} != REST {body}")
    finally:
        client.close()
        srv.stop(grace=None)
    return "run: Predict and Generate through PredictClient equal REST's"


# -- phase 21: the mesh, the collectives and the dp x tp LM step ----------------

MESH_WARMUP, MESH_TIMED = 3, 6
MESH_BENCH_MB = 64.0
# the f32 parity and ring/ulysses model: two layers at phase 14's widths
MESH_PARITY = dict(vocab_size=32000, d_model=768, n_layers=2, n_heads=12,
                   n_kv_heads=12, d_ff=3072, max_seq_len=512,
                   dtype="float32", remat=False)
MESH_PARITY_BATCH = 2          # rows a data-parallel rank


def _lm_flops(cfg, batch: int, seq: int) -> float:
    """Analytic train FLOPs of one step over ``batch`` rows:
    6·N·T + 12·B·L·S²·D (``tests/test_torch_steps.py``'s count)."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    n_params = V * D + L * (4 * D * D + 3 * D * F + 2 * D) + D
    return 6.0 * n_params * batch * seq + 12.0 * batch * L * seq ** 2 * D


def _mesh_entry(device, out: str, name: str, argv) -> dict:
    """``examples.lm.main`` at its defaults with ``argv`` (the tp, the
    attention): every kernel count zeroed just before the run and read
    just after it; each step's wall timed around a device sync."""
    import math

    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.examples import lm as lm_example

    real = lm_example.make_lm_train_step
    walls = []

    def timed(*a, **kw):
        step = real(*a, **kw)

        def run(state, tokens):
            _sync(device)
            t0 = time.perf_counter()
            res = step(state, tokens)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            return res

        return run

    steps = MESH_WARMUP + MESH_TIMED
    results = os.path.join(out, f"results-{name}")
    lm_example.make_lm_train_step = timed
    try:
        _reset_peak(device)
        ops.reset_launches()
        _entry_main("lm", ["--device", device.type, *argv, "--steps",
                           str(steps), "--log-every", "1"],
                    {"KFTPU_RESULTS_DIR": results,
                     "KFTPU_JOB_NAME": name})
        launches = ops.launch_counts()
    finally:
        lm_example.make_lm_train_step = real
    peak = _peak_gb(device)
    # rank 0 alone logs
    recs = ([r for r in _records(results, name) if "loss" in r]
            if torch.distributed.get_rank() == 0 else [])
    return {"walls_s": walls, "launches": launches, "peak_gb": peak,
            "losses": [r["loss"] for r in recs],
            "finite": all(math.isfinite(r["loss"]) for r in recs)}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _moved_err(full, plain, p0) -> float:
    """The largest, over the parameters, of ||Δ - Δ_plain|| / ||Δ_plain||
    with Δ = p - p0: the step's movement held relative to its own size,
    which a skipped or doubled update misses by ~1 where an absolute
    limit on the parameters would miss it by ~2x."""
    worst = 0.0
    for name, p in plain:
        want = p.detach().float() - p0[name]
        got = full[name].to(want.device).float() - p0[name]
        worst = max(worst, float((got - want).norm() /
                                 want.norm().clamp_min(1e-30)))
    return worst


# the f32 mesh-vs-plain parameter movement limit: a skipped update
# reads ~0.5-1, a sound one only as finely as the parameters' own f32
# rounding allows (tests/test_torch_mesh_train.py's MOVED_LIMIT)
MESH_MOVED_LIMIT = 2e-3


def _mesh_parity(device, mesh, cfg, world: int) -> dict:
    """Three f32 steps of ``make_lm_train_step(mesh)`` on a model built
    over ``mesh`` against three of the mesh-less step on the same
    weights and global batches: the largest loss and parameter
    differences, the largest relative grad-norm difference, and the
    parameters' movement against the plain step's (:func:`_moved_err`)."""
    import numpy as np

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        create_train_state,
        make_lm_train_step,
        make_optimizer,
    )

    def tx():
        return make_optimizer(1e-5, warmup_steps=1, decay_steps=50)

    params = convert.random_params(cfg, 1)
    state, _ = create_sharded_state(cfg, params, tx(), mesh, device=device)
    plain = create_train_state(cfg, params, tx(), device=device)
    del params
    p0 = {n: p.detach().float().clone()
          for n, p in plain.module.named_parameters()}
    step, plain_step = make_lm_train_step(mesh), make_lm_train_step()
    rng = np.random.default_rng(21)
    errs = {"loss": 0.0, "grad_norm": 0.0}
    losses = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (MESH_PARITY_BATCH * world,
                                                cfg.max_seq_len)).astype(
                                                    np.int32)
        state, m = step(state, toks)
        plain, pm = plain_step(plain, toks)
        losses.append(float(m["loss"]))
        errs["loss"] = max(errs["loss"],
                           abs(float(m["loss"]) - float(pm["loss"])))
        errs["grad_norm"] = max(errs["grad_norm"], abs(
            float(m["grad_norm"]) / float(pm["grad_norm"]) - 1.0))
    full = convert.gather_params(state.module)
    errs["params"] = max(_max_err(full[n], p) for n, p in
                         plain.module.named_parameters())
    errs["moved"] = _moved_err(full, plain.module.named_parameters(), p0)
    errs["losses"] = losses
    return errs


def _seq_parallel_parity(device, mesh, cfg, world: int) -> dict:
    """Ring and Ulysses over ``tp`` (the sequence split over ``world``
    ranks) against flash on one rank, same weights, f32: each rank's
    block of the logits (its largest error, and that error over the
    flash logits' largest magnitude where it passes 1), and one train
    step's loss and grad norm."""
    import dataclasses

    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        create_train_state,
        make_lm_train_step,
        make_optimizer,
    )

    params = convert.random_params(cfg, 2)
    toks = np.random.default_rng(22).integers(
        0, cfg.vocab_size, (MESH_PARITY_BATCH, cfg.max_seq_len)).astype(
            np.int32)
    flash = create_train_state(cfg, params, make_optimizer(1e-5),
                               device=device)
    with torch.no_grad():
        want = flash.module(torch.from_numpy(toks).to(device))
    _, fm = make_lm_train_step()(flash, toks)
    del flash
    n = cfg.max_seq_len // world
    rank = torch.distributed.get_rank()
    out = {}
    for impl in ("ring", "ulysses"):
        rc = dataclasses.replace(cfg, attention_impl=impl)
        state, _ = create_sharded_state(rc, params, make_optimizer(1e-5),
                                        mesh, device=device)
        with torch.no_grad():
            got = state.module(torch.from_numpy(toks).to(device))
        _, m = make_lm_train_step(mesh)(state, toks)
        ref = want[:, rank * n:(rank + 1) * n]
        err = _max_err(got, ref)
        out[impl] = {
            "logits": err,
            "logits_scaled": err / max(1.0, float(ref.abs().max())),
            "loss": abs(float(m["loss"]) - float(fm["loss"])),
            "grad_norm": abs(float(m["grad_norm"]) /
                             float(fm["grad_norm"]) - 1.0)}
        del state, got
    return out


def _sync(device) -> None:
    import torch

    torch.cuda.synchronize(device)


def mesh_rank_main(argv) -> int:
    """One rank of phase 21, started by :func:`mesh_phase` through the
    port's ``run_multiprocess`` with the operator's env contract, on
    card ``rank % cards`` over NCCL: ``chip_smoke.py --mesh-rank OUT``.
    Writes ``OUT/rank<r>.json``."""
    import dataclasses

    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import collectives as col
    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from kubeflow_tpu_torch.testing.collective_check import (
        check_collectives,
    )

    (out,) = argv
    penv = dist.from_env()
    world = penv.num_processes
    device = torch.device("cuda", penv.process_id % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize(penv, backend="nccl")
    mesh_dp = create_mesh(MeshConfig(dp=world), device_type="cuda")
    res = {"rank": penv.process_id, "world": world,
           "backend": tdist.get_backend(),
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    res["collectives"] = check_collectives(mesh_dp, device)
    res["bench"] = [dataclasses.asdict(r) for r in col.bench_all(
        mesh_dp, "dp", size_mb=MESH_BENCH_MB, iters=10, device=device)]
    runs = [("tp1", 1)]
    if world >= 2:
        runs.append(("tp2", 2))
    res["entry"], res["flash"] = {}, {}
    for name, tp in runs:
        # the flash kernels at this run's local heads, on this rank's
        # card, before the run (these launches are not the run's)
        B, S, H, D = LM_FLASH_SHAPE
        res["flash"][name], _ = compare_flash(
            B, S, H // tp, D, torch.bfloat16, device, SEED + 40 + tp,
            causal=True, masked=False)
        res["entry"][name] = _mesh_entry(
            device, out, name, ["--tp", str(tp), "--attention-impl",
                                "flash"])
    cfg = TransformerConfig(**MESH_PARITY, attention_impl="flash")
    res["parity"] = _mesh_parity(device, mesh_dp, cfg, world)
    mesh_sp = create_mesh(MeshConfig(tp=world), device_type="cuda")
    res["seq_parallel"] = _seq_parallel_parity(device, mesh_sp, cfg, world)
    with open(os.path.join(out, f"rank{penv.process_id}.json"), "w") as f:
        json.dump(res, f)
    _sync(device)
    tdist.destroy_process_group()
    return 0


def mesh_phase(device) -> dict:
    """Phase 21: one rank a card started through the port's harness with
    the env contract, over NCCL, each on its own card
    (:func:`mesh_rank_main`). Each rank checks the five collectives on
    ``dp`` and times them at 64 MB; holds the flash kernels at the
    run's local heads; runs ``examples.lm.main`` at its defaults with
    flash attention through ``launcher_init``'s mesh at dp = world, tp
    = 1 (and tp = 2 where world >= 2), 3 warm-up and 6 timed steps;
    holds three f32 mesh steps against three mesh-less ones (loss, grad
    norm, parameters within 1e-5, their movement within
    ``MESH_MOVED_LIMIT``); and holds ring and Ulysses logits (scaled by
    their magnitude), loss and grad norm against flash (1e-5)."""
    import torch

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.testing import run_multiprocess

    world = torch.cuda.device_count()
    out = tempfile.mkdtemp(prefix="kftpu-mesh-")
    try:
        procs = run_multiprocess(
            [os.path.abspath(__file__), "--mesh-rank", out], world,
            timeout_s=600.0, job_name="mesh-smoke")
        for r in procs:
            check(r.returncode == 0,
                  f"mesh rank {r.process_id} ended {r.returncode}:\n"
                  f"{r.stderr[-4000:]}")
        ranks = []
        for i in range(world):
            with open(os.path.join(out, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    # the entry point's defaults
    lm_cfg = TransformerConfig(**dict(MESH_PARITY, n_layers=12))
    seq = lm_cfg.max_seq_len
    batch = LM_FLASH_SHAPE[0]
    summary = {"world": world, "nccl": ranks[0]["nccl"],
               "backend": ranks[0]["backend"], "bench": ranks[0]["bench"],
               "entry": {}, "launches": {}, "flash": ranks[0]["flash"]}
    for r in ranks:
        check(all(r["collectives"].values()),
              f"mesh rank {r['rank']}: collectives {r['collectives']}")
        par = r["parity"]
        check(par["loss"] <= 1e-5 and par["grad_norm"] <= 1e-5
              and par["params"] <= 1e-5
              and par["moved"] <= MESH_MOVED_LIMIT,
              f"mesh rank {r['rank']}: f32 mesh vs plain {par}")
        for impl, e in r["seq_parallel"].items():
            check(max(e["logits_scaled"], e["loss"], e["grad_norm"])
                  <= 1e-5, f"mesh rank {r['rank']}: {impl} vs flash {e}")
    for name in ranks[0]["entry"]:
        runs = [r["entry"][name] for r in ranks]
        check(runs[0]["finite"] and len(runs[0]["losses"]) == MESH_WARMUP +
              MESH_TIMED and all(len(e["walls_s"]) == MESH_WARMUP +
                                 MESH_TIMED for e in runs),
              f"mesh {name}: rank 0's losses {runs[0]['losses']}")
        timed = sorted(max(e["walls_s"][i] for e in runs)
                       for i in range(MESH_WARMUP, MESH_WARMUP + MESH_TIMED))
        p50 = statistics.median(timed)
        rows = batch * world // (2 if name == "tp2" else 1)  # global batch
        flops = _lm_flops(lm_cfg, rows, seq)
        summary["entry"][name] = {
            "step_ms": [round(t * 1e3, 3) for t in timed],
            "p50_ms": p50 * 1e3,
            "tokens_per_s_per_card": rows * seq / p50 / world,
            "mfu": flops / p50 / (BF16_FLOPS * world),
            "peak_gb": max(e["peak_gb"] for e in runs),
            "losses": runs[0]["losses"]}
        for e in runs:
            for k, n in e["launches"].items():
                summary["launches"][k] = summary["launches"].get(k, 0) + n
    summary["parity"] = ranks[0]["parity"]
    summary["seq_parallel"] = ranks[0]["seq_parallel"]
    return summary


# -- phase 22: the pipeline, MoE over the mesh, the image step over dp ------

PIPE_WARMUP, PIPE_TIMED, PIPE_MICRO, PIPE_BATCH = 3, 6, 4, 8
# examples/lm.py's defaults with flash attention (remat on, bf16 over f32)
PIPE_LM = dict(vocab_size=32000, d_model=768, n_layers=12, n_heads=12,
               n_kv_heads=12, d_ff=3072, max_seq_len=512,
               attention_impl="flash")
PIPE_IMAGE_BATCH, PIPE_IMAGE_WARMUP, PIPE_IMAGE_TIMED = 128, 2, 5
PIPE_MOE_STEPS = 4
# the runs whose launches are the pipe_moe_image path's: the f32 parity
# runs between them are not the path
PIPE_MAIN_PARTS = ("pipe_lm", "moe_entry", "resnet")


def moe_exchange_bytes(dp: int, *, experts=8, k=2, capacity_factor=1.25,
                       rows=8, seq=512, d_model=768, d_ff=3072,
                       el=2) -> dict:
    """Bytes a rank sends for one MoE layer's forward at
    ``examples/lm.py``'s widths (``rows`` a rank, bf16 activations) over
    ``dp`` ranks, from the shapes alone: the capacity dispatch's dense
    exchange (reduce-scatter of the ``(E, C, D)`` buffer, all-gather of
    the outputs: ``(dp - 1) / dp`` of it each way, ``C`` from the global
    token count), an all-to-all of the filled slots alone (each token's
    ``k`` choices out and back, less this rank's own share; drops
    ignored), and the dense dispatch's all-gather of the f32 expert
    weights (``E / dp`` a rank, three matrices). The backward moves as
    much again."""
    from kubeflow_tpu_torch.ops.moe import expert_capacity

    tokens = rows * seq
    C = expert_capacity(tokens * dp, experts, k, capacity_factor)
    share = (dp - 1) / dp
    return {"capacity": C,
            "dense_buffers": 2 * share * experts * C * d_model * el,
            "filled_slots": 2 * share * tokens * k * d_model * el,
            "weights": share * experts * 3 * d_model * d_ff * 4}


def pipe_kernel_checks(device) -> dict:
    """The kernels of phase 22's paths against their plain versions at
    the shapes those paths give them (before the path's counts are
    zeroed: these launches are not the path's): flash at one pipelined
    microbatch, (8 / 4, 512, 12, 64) bf16 causal, and the bnconv forward
    and dW at the four ResNet-50 sites at the rank's batch of 128 (bf16),
    at phase 2's limits."""
    import torch

    bf = torch.bfloat16
    mb = PIPE_BATCH // PIPE_MICRO
    errs, _ = compare_flash(mb, PIPE_LM["max_seq_len"], PIPE_LM["n_heads"],
                            PIPE_LM["d_model"] // PIPE_LM["n_heads"], bf,
                            device, SEED + 70, causal=True, masked=False)
    flash = {"flash_fwd": max(errs["out"], errs["lse"]),
             "flash_bwd": max(errs["dq"], errs["dk"], errs["dv"])}
    bnconv = {"bnconv_fwd": 0.0, "bnconv_dw": 0.0}
    for i, (M, K, N, _) in enumerate(RESNET50_SITES):
        errs, _ = compare_bnconv(M * PIPE_IMAGE_BATCH // RESNET_BATCH, K, N,
                                 bf, device, SEED + 71 + i)
        for name, err in errs.items():
            bnconv[name] = max(bnconv[name], err)
        torch.cuda.empty_cache()
    return {"flash": flash, "bnconv": bnconv}


def _timed_steps(device, step, state, batches, warmup):
    """Run ``step`` over ``batches`` (tuples of its inputs), each step's
    wall timed around a device sync; returns (state, walls, metrics)."""
    walls, metrics = [], []
    for args in batches:
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, *args)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, walls[warmup:], metrics


def _step_parity(device, make, steps, batch) -> dict:
    """``steps`` f32 steps of two train states on the same weights and
    global batches: ``make()`` returns ``(state, step, plain, plain_step,
    vocab)``. The largest loss and parameter differences, the largest
    relative grad-norm difference, and the movement against the plain
    step's (:func:`_moved_err`)."""
    import numpy as np

    from kubeflow_tpu_torch.models import convert

    state, step, plain, plain_step, vocab = make()
    p0 = {n: p.detach().float().clone()
          for n, p in plain.module.named_parameters()}
    rng = np.random.default_rng(SEED + 73)
    errs = {"loss": 0.0, "grad_norm": 0.0}
    for _ in range(steps):
        toks = rng.integers(0, vocab, batch).astype(np.int32)
        state, m = step(state, toks)
        plain, pm = plain_step(plain, toks)
        errs["loss"] = max(errs["loss"],
                           abs(float(m["loss"]) - float(pm["loss"])))
        errs["grad_norm"] = max(errs["grad_norm"], abs(
            float(m["grad_norm"]) / float(pm["grad_norm"]) - 1.0))
    full = convert.gather_params(state.module)
    errs["params"] = max(_max_err(full[n], p.detach()) for n, p in
                         plain.module.named_parameters())
    errs["moved"] = _moved_err(full, plain.module.named_parameters(), p0)
    return errs


def _pipe_lm_parity(device, mesh) -> dict:
    """Three f32 steps (TF32 off) of the pipelined step (2 microbatches)
    against three of ``make_lm_train_step`` over the same mesh: 2 layers
    at the entry point's widths, 4 rows."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_lm_train_step,
        make_optimizer,
        make_pipelined_lm_train_step,
    )

    cfg = TransformerConfig(**MESH_PARITY, attention_impl="flash")

    def make():
        params = convert.random_params(cfg, 3)
        tx = (lambda: make_optimizer(1e-5, warmup_steps=1, decay_steps=50))
        state, _ = create_sharded_state(cfg, params, tx(), mesh,
                                        device=device, pipelined=True)
        plain, _ = create_sharded_state(cfg, params, tx(), mesh,
                                        device=device)
        return (state, make_pipelined_lm_train_step(mesh, n_microbatches=2),
                plain, make_lm_train_step(mesh), cfg.vocab_size)

    return _step_parity(device, make, 3, (4, cfg.max_seq_len))


def _moe_mesh_parity(device, mesh, capacity: float) -> dict:
    """Three f32 steps (TF32 off) of a MoE model built over the mesh
    (8 experts, top-2; dense dispatch, or capacity at ``capacity``)
    against three of the same model with no mesh: 2 layers at the entry
    point's widths, 4 rows."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        create_train_state,
        make_lm_train_step,
        make_optimizer,
    )

    cfg = TransformerConfig(**MESH_PARITY, attention_impl="flash",
                            n_experts=8, moe_capacity_factor=capacity)

    def make():
        params = convert.random_params(cfg, 4)
        tx = (lambda: make_optimizer(1e-5, warmup_steps=1, decay_steps=50))
        state, _ = create_sharded_state(cfg, params, tx(), mesh,
                                        device=device)
        plain = create_train_state(cfg, params, tx(), device=device)
        return (state, make_lm_train_step(mesh), plain, make_lm_train_step(),
                cfg.vocab_size)

    return _step_parity(device, make, 3, (4, cfg.max_seq_len))


def _image_mesh_parity(device, mesh) -> dict:
    """Two f32 steps (TF32 off) of phase 8's small fused ResNet through
    ``make_image_train_step(mesh)`` (BatchNorm over the global batch)
    against two without a mesh, from the same weights and batch: the
    largest loss, running-statistic and parameter differences."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.train import (
        create_image_train_state,
        make_image_train_step,
        make_sgd,
    )

    cfg = ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=100, width=64,
                       dtype="float32", bn_dtype="float32",
                       fused_bn_conv=True)
    variables = randomized_bn(convert.random_resnet_params(cfg, SEED + 74),
                              SEED + 75)
    rng = np.random.default_rng(SEED + 76)
    images = torch.from_numpy(rng.standard_normal(
        (8, 128, 128, 3), dtype=np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 100, 8)).to(device)
    runs = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        state = create_image_train_state(cfg, variables, make_sgd(
            0.1, momentum=0.9), device=device)
        step = make_image_train_step(m)
        losses = []
        for _ in range(2):
            state, met = step(state, images, labels)
            losses.append(float(met["loss"]))
        runs[name] = (losses, {k: t.detach().float().clone() for k, t in
                               state.module.state_dict().items()})
    (lm, sm), (lp, sp) = runs["mesh"], runs["plain"]
    stats = [k for k in sp if k.endswith((".mean", ".var"))]
    return {"loss": max(abs(a - b) for a, b in zip(lm, lp)),
            "stats": max(_max_err(sm[k], sp[k]) for k in stats),
            "params": max(_max_err(sm[k], sp[k]) for k in sp
                          if k not in stats),
            "losses": lm}


def pipe_moe_image_phase(device) -> dict:
    """Phase 22 on one card at world 1 (NCCL), through the mesh of
    ``launcher_init(pp=1)``; every kernel count zeroed just before each
    run and read just after it. The path's launches are the sum of its
    three main runs' (``PIPE_MAIN_PARTS``); the f32 parity runs' are
    kept apart, for the print alone:

    - ``make_pipelined_lm_train_step`` (4 microbatches) at
      ``examples/lm.py``'s widths with flash, 3 warm-up and 6 timed
      steps: step p50, tokens/s, peak GB; the flash launches must be the
      prediction, 12 layers x 4 ticks a step (forward doubled by remat);
      then three f32 pipelined steps against ``make_lm_train_step`` over
      the same mesh (:func:`_pipe_lm_parity`);
    - ``examples.lm.main --n-experts 8 --attention-impl flash`` for 4
      steps through the mesh (step p50, peak GB), and the f32 MoE mesh
      step against the mesh-less one, dense and capacity 1.25;
    - ResNet-50 fused at batch 128 through ``make_image_train_step(
      mesh)`` with BatchNorm over the global batch, 2 warm-up and 5
      timed steps (images/s; bnconv forward and dW 16 a step), and the
      f32 mesh step against the mesh-less one.

    The parity limits: loss, grad norm and parameters 1e-5 and the
    movement ``MESH_MOVED_LIMIT`` for the LM steps; loss 1e-5 and running
    statistics 1e-6 for the image step."""
    import math

    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.examples.common import launcher_init
    from kubeflow_tpu_torch.examples.lm import batch_for_step
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import (
        create_sharded_state,
        make_image_train_step,
        make_optimizer,
        make_pipelined_lm_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"checks": pipe_kernel_checks(device)}
    _, mesh, _ = launcher_init(pp=1, device=device.type)
    parts = {}

    def part(name):
        """The launches of the part just run: the counts were zeroed just
        before it."""
        parts[name] = ops.launch_counts()

    # the pipelined LM step at the entry point's widths
    t0 = time.perf_counter()
    cfg = TransformerConfig(**PIPE_LM)
    state, _ = create_sharded_state(
        cfg, convert.random_params(cfg, 0), make_optimizer(
            3e-4, warmup_steps=20, decay_steps=100), mesh, device=device,
        pipelined=True)
    setup_s = time.perf_counter() - t0
    step = make_pipelined_lm_train_step(mesh, n_microbatches=PIPE_MICRO)
    n = PIPE_WARMUP + PIPE_TIMED
    _reset_peak(device)
    batches = [(batch_for_step(i, PIPE_BATCH, cfg.max_seq_len,
                               cfg.vocab_size),) for i in range(1, n + 1)]
    ops.reset_launches()
    state, walls, mets = _timed_steps(device, step, state, batches,
                                      PIPE_WARMUP)
    part("pipe_lm")
    losses = [m["loss"] for m in mets]
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) <= 1.0,
          f"pipe: losses {losses}")
    ticks = PIPE_MICRO * n          # M + S - 1 ticks a step, S = 1
    want = {"flash_fwd": 2 * cfg.n_layers * ticks,
            "flash_bwd": cfg.n_layers * ticks,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    got = {k: parts["pipe_lm"].get(k, 0) for k in want}
    check(got == want, f"pipe: flash launches {got}, predicted {want}")
    p50 = statistics.median(walls)
    res["pipe"] = {"setup_s": setup_s, "step_ms": [w * 1e3 for w in walls],
                   "p50_ms": p50 * 1e3,
                   "tokens_per_s": PIPE_BATCH * cfg.max_seq_len / p50,
                   "mfu": _lm_flops(cfg, PIPE_BATCH, cfg.max_seq_len) / p50
                   / BF16_FLOPS,
                   "peak_gb": _peak_gb(device), "losses": losses,
                   "launches": parts["pipe_lm"], "predicted": want}
    del state, step, batches
    torch.cuda.empty_cache()
    ops.reset_launches()
    res["pipe_parity"] = par = _pipe_lm_parity(device, mesh)
    part("pipe_parity")
    check(par["loss"] <= 1e-5 and par["grad_norm"] <= 1e-5
          and par["params"] <= 1e-5 and par["moved"] <= MESH_MOVED_LIMIT,
          f"pipe: f32 pipelined vs mesh step {par}")
    torch.cuda.empty_cache()

    # MoE through the mesh: the entry point, then the f32 parity
    work = tempfile.mkdtemp(prefix="kftpu-pipe-moe-")
    try:
        _reset_peak(device)
        ops.reset_launches()
        _entry_main("lm", ["--device", device.type, "--n-experts", "8",
                           "--attention-impl", "flash", "--steps",
                           str(PIPE_MOE_STEPS), "--log-every", "1"],
                    {"KFTPU_RESULTS_DIR": work, "KFTPU_JOB_NAME": "moe"})
        recs = [r for r in _records(work, "moe") if "loss" in r]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    part("moe_entry")
    moe_losses = [r["loss"] for r in recs]
    check(len(moe_losses) == PIPE_MOE_STEPS
          and all(math.isfinite(x) for x in moe_losses),
          f"pipe moe: losses {moe_losses}")
    res["moe"] = {"losses": moe_losses,
                  "p50_step_s": recs[-1]["step_p50_step_s"],
                  "tokens_per_s": recs[-1]["tokens_per_sec"],
                  "peak_gb": _peak_gb(device),
                  "launches": parts["moe_entry"]}
    torch.cuda.empty_cache()
    res["moe_parity"] = {}
    ops.reset_launches()
    for label, cf in (("dense", 0.0), ("capacity", 1.25)):
        par = _moe_mesh_parity(device, mesh, cf)
        res["moe_parity"][label] = par
        check(par["loss"] <= 1e-5 and par["grad_norm"] <= 1e-5
              and par["params"] <= 1e-5
              and par["moved"] <= MESH_MOVED_LIMIT,
              f"pipe moe {label}: f32 mesh vs mesh-less {par}")
        torch.cuda.empty_cache()
    part("moe_parity")

    # ResNet-50 fused at the rank's batch through the mesh
    _, state, images, labels = resnet_setup(device, fused=True)
    images, labels = (images[:PIPE_IMAGE_BATCH].contiguous(),
                      labels[:PIPE_IMAGE_BATCH].contiguous())
    stats0 = {k: t.clone() for k, t in state.batch_stats.items()}
    n = PIPE_IMAGE_WARMUP + PIPE_IMAGE_TIMED
    _reset_peak(device)
    step = make_image_train_step(mesh)
    ops.reset_launches()
    state, walls, mets = _timed_steps(
        device, step, state, [(images, labels)] * n, PIPE_IMAGE_WARMUP)
    part("resnet")
    img_losses = [m["loss"] for m in mets]
    check(all(math.isfinite(x) for x in img_losses)
          and img_losses[-1] < img_losses[0],
          f"pipe resnet: losses {img_losses}")
    check(all(not torch.equal(t, stats0[k])
              for k, t in state.batch_stats.items()),
          "pipe resnet: running statistics not moved")
    sites = sum(state.module.config.stage_sizes)
    for name in ("bnconv_fwd", "bnconv_dw"):
        check(parts["resnet"].get(name, 0) == sites * n,
              f"pipe resnet: {name} launched {parts['resnet'].get(name)} "
              f"times, expected {sites * n}")
    mean = sum(walls) / len(walls)
    res["resnet"] = {"step_ms": [w * 1e3 for w in walls],
                     "mean_step_ms": mean * 1e3,
                     "images_per_s": PIPE_IMAGE_BATCH / mean,
                     "peak_gb": _peak_gb(device), "losses": img_losses,
                     "launches": parts["resnet"]}
    del state, images, labels
    torch.cuda.empty_cache()
    ops.reset_launches()
    res["image_parity"] = par = _image_mesh_parity(device, mesh)
    part("image_parity")
    check(par["loss"] <= 1e-5 and par["stats"] <= 1e-6,
          f"pipe resnet: f32 mesh vs mesh-less step {par}")
    # the path's launches are its main runs' alone; the f32 parity runs'
    # are printed beside them, and counted nowhere
    res["parts"] = parts
    res["launches"] = {k: sum(parts[p].get(k, 0) for p in PIPE_MAIN_PARTS)
                       for k in parts["pipe_lm"]}
    torch.cuda.empty_cache()
    return res


# -- phase 23: serving over a mesh, and the encoders over tp ----------------

# BERT-base and ViT-B/16 widths with 2 layers, f32: the encoder steps at
# tp = 2 held against their unsplit twins
ENC_BERT = dict(vocab_size=30522, d_model=768, n_layers=2, n_heads=12,
                d_ff=3072, max_seq_len=128, attention_impl="flash",
                remat=False, scan_layers=False)
ENC_VIT = dict(image_size=224, patch_size=16, num_classes=1000,
               d_model=768, n_layers=2, n_heads=12, d_ff=3072, remat=False,
               scan_layers=False)
ENC_BATCH, ENC_STEPS, ENC_LR = 4, 3, 1e-5
GLOO_OPS = ("all_reduce", "all_gather", "broadcast")


def gloo_on_cuda(device) -> dict:
    """Each collective the tp path issues, over gloo on CUDA tensors:
    ``{op: "ok", "wrong values" or the error}`` (every rank calls each)."""
    import torch
    import torch.distributed as tdist

    r, n = tdist.get_rank(), tdist.get_world_size()
    x = torch.full((4,), float(r + 1), device=device)

    def run(op):
        y = x.clone()
        if op == "all_reduce":
            tdist.all_reduce(y)
            return bool((y == n * (n + 1) / 2).all())
        if op == "all_gather":
            y = x.new_empty(4 * n)
            tdist.all_gather_into_tensor(y, x)
            return y.view(n, 4)[:, 0].tolist() == [float(i + 1)
                                                   for i in range(n)]
        tdist.broadcast(y, src=0)
        return bool((y == 1).all())

    out = {}
    for op in GLOO_OPS:
        try:
            out[op] = "ok" if run(op) else "wrong values"
        except Exception as e:  # noqa: BLE001 — the phase prints which
            out[op] = f"{type(e).__name__}: {e}"
    return out


# phase 4's f32 prompts again, sampled: (temperature, top-k, top-p) and a
# seed a request, so ``fused_sample`` runs on the gathered row at tp = 2
MESH_SAMPLED = [(0.8, 0, 0.9), (0.8, 50, 1.0), (0.8, 40, 0.95), (0.8, 0, 1.0)]


def mesh_requests(vocab: int) -> dict:
    """Phase 23's requests as ``:generate`` bodies, one prompt each:
    ``greedy`` (phase 4's) and ``sampled`` (:data:`MESH_SAMPLED`)."""
    max_new = PARITY_PROMPTS["max_new"]
    prompts = parity_prompts(vocab)
    return {"greedy": [{"prompt_tokens": [p], "max_new_tokens": max_new}
                       for p in prompts],
            "sampled": [{"prompt_tokens": [p], "max_new_tokens": max_new,
                         "temperature": t, "top_k": k, "top_p": tp,
                         "seed": 100 + i}
                        for i, (p, (t, k, tp)) in enumerate(
                            zip(prompts, MESH_SAMPLED))]}


def engine_streams(eng, bodies) -> list:
    """``bodies`` submitted to ``eng`` as the server submits them, run
    to the end: each request's tokens."""
    reqs = [eng.submit(b["prompt_tokens"][0], max_new=b["max_new_tokens"],
                       temperature=b.get("temperature", 0.0),
                       top_k=b.get("top_k", 0), top_p=b.get("top_p", 1.0),
                       seed=b.get("seed", 0)) for b in bodies]
    drain(eng)
    return [r.result() for r in reqs]


def _round(url: str, bodies: list) -> dict:
    """``bodies`` posted to ``url`` at once, one thread each: the
    streams and the round's wall."""
    results, errors = [None] * len(bodies), []

    def run(i):
        try:
            results[i] = _post(url, bodies[i], False)[0]
        except Exception as e:  # noqa: BLE001 — checked below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, "; ".join(errors))
    return {"streams": [r["tokens"][0] for r in results],
            "wall_s": time.perf_counter() - t0}


def _serve_leader(device, base: str, mesh) -> dict:
    """Rank 0: ``ModelServer(decode_mesh=)`` over ``base`` (the f32
    export ``lm32`` alone); :func:`mesh_requests`' greedy, then sampled
    requests through REST, each round's requests at once. Its streams,
    walls, engine cache, the tokens its engine sampled, its blocks of
    the model and the plans it sent."""
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer(base, port=0, decode_slots=8,
                         decode_steps_per_sync=4, poll_interval_s=3600,
                         device=device, decode_mesh=mesh)
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/lm32:generate"
    try:
        lm = server.repo.get("lm32")
        eng = server.repo.engine_for("lm32", lm)
        eng.token_log = []
        # warm-up: the first programs' cuBLAS handles on both ranks
        _post(url, {"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 2},
              False)
        res = {"shapes": {n: list(p.shape) for n, p in
                          lm.module.named_parameters()
                          if n in ("token_embed", "blocks.0.attn.q_proj",
                                   "blocks.0.mlp.down_proj")}}
        for name, bodies in mesh_requests(lm.lm_config.vocab_size).items():
            res[name] = _round(url, bodies)
        k = eng._cache.k
        res.update(cache=list(k.shape),
                   kv_bytes=2 * k.numel() * k.element_size(),
                   log=[(op, t.tolist()) for op, t in eng.token_log])
    finally:
        server.stop()
    res["plans"] = server.repo.lockstep.plans_sent
    return res


def _split_serving(device, base: str, mesh) -> dict:
    """Phase 23's tp = 2 serving, paged (through the kernel) and dense:
    rank 0 serves (:func:`_serve_leader`), rank 1 follows its plans
    (``serve_follower``). Each rank's counts run from its server's or
    follower's start to its end."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving.server import serve_follower

    out = {}
    for mode in ("paged", "dense"):
        os.environ["KFTPU_PAGED"] = "1" if mode == "paged" else "0"
        os.environ["KFTPU_SAMPLER_IMPL"] = "fused"
        _sync(device)
        ops.reset_launches()
        if tdist.get_rank() == 0:
            res = _serve_leader(device, base, mesh)
        else:
            f = serve_follower(base, mesh, device=device, record=True)
            res = {"log": [(op, t.tolist())
                           for op, t in f.token_logs[("lm32", 1)]],
                   "kv_heads": f.models[("lm32", 1)].module.cache_kv_heads}
        _sync(device)
        res["launches"] = ops.launch_counts()
        out[mode] = res
    return out


def _encoder_steps(device, mesh) -> dict:
    """``ENC_STEPS`` f32 steps of the BERT MLM step (flash on the rank's
    6 heads) and of the ViT image step, each built over the tp = 2 mesh;
    rank 0 also runs the unsplit twins and returns the largest
    differences. Launches counted over the split runs alone."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.models.vit import ViTConfig
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        create_vit_train_state,
        make_image_train_step,
        make_mlm_train_step,
        make_optimizer,
    )

    rng = np.random.default_rng(11)
    bcfg = BertConfig(**ENC_BERT, dtype="float32")
    labels = rng.integers(0, bcfg.vocab_size,
                          (ENC_BATCH, bcfg.max_seq_len)).astype(np.int32)
    weights = (rng.random(labels.shape) < 0.15).astype(np.float32)
    tokens = np.where(weights > 0, 103, labels).astype(np.int32)
    vcfg = ViTConfig(**ENC_VIT, dtype="float32")
    size = vcfg.image_size
    images = rng.standard_normal((ENC_BATCH, size, size, 3)).astype(
        np.float32)
    classes = rng.integers(0, vcfg.num_classes, ENC_BATCH).astype(np.int32)
    models = {
        "bert": (lambda m: create_bert_train_state(
            bcfg, convert.random_bert_params(bcfg, 0),
            make_optimizer(ENC_LR, warmup_steps=1, decay_steps=50),
            device=device, mesh=m), make_mlm_train_step,
            (tokens, labels, weights)),
        "vit": (lambda m: create_vit_train_state(
            vcfg, convert.random_vit_params(vcfg, 0),
            make_optimizer(ENC_LR, warmup_steps=1, decay_steps=50),
            device=device, mesh=m), make_image_train_step,
            (images, classes))}

    def run(name, m):
        make_state, make_step, batch = models[name]
        state = make_state(m)
        p0 = {k: v.clone()
              for k, v in convert.gather_params(state.module).items()}
        step = make_step(m)
        losses, norms = [], []
        for _ in range(ENC_STEPS):
            state, met = step(state, *batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        return losses, norms, p0, convert.gather_params(state.module)

    out = {"launches": {}}
    for name in models:
        _sync(device)
        ops.reset_launches()
        t0 = time.perf_counter()
        split = run(name, mesh)
        _sync(device)
        wall = time.perf_counter() - t0
        for k, n in ops.launch_counts().items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        res = {"losses": split[0], "norms": split[1], "wall_s": wall}
        if tdist.get_rank() == 0:
            whole = run(name, None)
            res["loss"] = max(abs(a - b) for a, b in zip(split[0],
                                                         whole[0]))
            res["grad_norm"] = max(abs(a - b) / max(abs(b), 1e-30)
                                   for a, b in zip(split[1], whole[1]))
            res["params"] = max(_max_err(split[3][k], whole[3][k])
                                for k in whole[3])
            res["moved"] = _moved_err(split[3], list(whole[3].items()),
                                      whole[2])
            res["unsplit_losses"] = whole[0]
            del whole
        del split
        torch.cuda.empty_cache()
        out[name] = res
    return out


def serve_rank_main(argv) -> int:
    """One rank of phase 23's tp = 2 half: two ranks on the one card,
    over gloo on CUDA tensors (NCCL refuses two ranks on one card),
    started by :func:`mesh_serving_phase` through ``run_multiprocess``
    with the env contract: ``chip_smoke.py --serve-rank OUT BASE``,
    ``BASE`` holding the f32 export ``lm32`` alone. Checks that gloo
    carries the path's collectives on CUDA tensors; where it does,
    serves over the mesh (:func:`_split_serving`) and runs the encoder
    steps. Writes ``OUT/rank<r>.json``."""
    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    out, base, *where = argv
    penv = dist.from_env()
    device = torch.device(where[0] if where else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize(penv, backend="gloo")
    res = {"rank": penv.process_id, "gloo": gloo_on_cuda(device)}
    if all(v == "ok" for v in res["gloo"].values()):
        mesh = create_mesh(MeshConfig(tp=penv.num_processes),
                           device_type=device.type)
        res["serving"] = _split_serving(device, base, mesh)
        res["encoders"] = _encoder_steps(device, mesh)
    with open(os.path.join(out, f"rank{penv.process_id}.json"), "w") as f:
        json.dump(res, f)
    _sync(device)
    tdist.destroy_process_group()
    return 0


def mesh_kernel_checks(device) -> dict:
    """The kernels at phase 23's tp = 2 shapes against their plain
    versions: the paged kernel on a rank's 8 q heads over its 8 kv heads
    (f32, as phase 23 serves, and bf16), flash f32 non-causal on BERT's
    6 heads a rank at seq 128. ``{name: max abs err}``."""
    import torch

    from kubeflow_tpu_torch.ops import paged_attention as pa

    out = {"paged_decode_attention": 0.0}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        q, k, v, pages, pos, _ = paged_inputs(8, 8, 8, 64, 64, 32, dtype,
                                              device, seed=SEED + 23)
        got = pa.paged_decode_attention(q, k, v, pages, pos)
        want = pa.paged_decode_attention_plain(q, k, v, pages, pos)
        _sync(device)
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got.float()).all()) and err <= atol,
              f"paged QH=KH=8 {dtype}: max abs err {err} > {atol}")
        out["paged_decode_attention"] = max(out["paged_decode_attention"],
                                            err)
    errs, _ = compare_flash(ENC_BATCH, 128, 6, 64, torch.float32, device,
                            SEED + 23, causal=False, masked=False)
    out["flash_fwd"] = max(errs["out"], errs["lse"])
    # f32: the dQ and the dK/dV kernels
    out["flash_bwd_dq"] = errs["dq"]
    out["flash_bwd_dkv"] = max(errs["dk"], errs["dv"])
    return out


# replicated kv heads (tp does not divide KH): (H, KH, tp, rank), a
# rank whose q heads are in one kv head's group, and one whose span two
REPLICATED_KV = ((16, 2, 4, 1), (12, 3, 2, 0))


def replicated_kv_times(device) -> list:
    """The paged kernel where tp does not divide the kv heads, at phase
    3's serving rows (B 8, Dh 64, pages of 64, positions 251-363, bf16):
    one rank's q heads over the slice of the pool's kv heads they read,
    in place, as ``models/transformer.py:_paged_decode_attend`` hands
    them over (``kv_window``), against the plain version on the same
    heads; timed beside the form it replaced (every q head, the rank's
    among zeros, over the whole pool, then cut), with the bound of the
    rank's own work."""
    import torch

    from kubeflow_tpu_torch.models.transformer import kv_window
    from kubeflow_tpu_torch.ops import paged_attention as pa

    out = []
    for H, KH, tp, rank in REPLICATED_KV:
        q, k, v, pages, pos, P = paged_serving_inputs(
            8, H, KH, 64, 64, 32, torch.bfloat16, device, seed=SEED + 24)
        n = H // tp
        mine = slice(rank * n, (rank + 1) * n)
        qr = q[:, mine].contiguous()
        kv, off, width = kv_window(rank * n, n, H // KH)
        ks, vs = k[:, :, kv], v[:, :, kv]

        def windowed():
            if kv.stop - kv.start > 1 and width > n:
                wide = qr.new_zeros((qr.shape[0], width, qr.shape[2]))
                wide[:, off:off + n] = qr
                return pa.paged_decode_attention(
                    wide, ks, vs, pages, pos)[:, off:off + n]
            return pa.paged_decode_attention(qr, ks, vs, pages, pos)

        def padded():
            wide = torch.zeros_like(q)
            wide[:, mine] = qr
            return pa.paged_decode_attention(wide, k, v, pages, pos)[:, mine]

        want = pa.paged_decode_attention_plain(q, k, v, pages, pos)[:, mine]
        err = (windowed().float() - want.float()).abs().max().item()
        check(err <= 8e-3, f"paged over a kv window (H {H}, KH {KH}, tp "
                           f"{tp}): max abs err {err} > 8e-3")
        nbytes, flops = paged_bytes_ops(qr, ks, pages, pos, P, 64)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        out.append({"H": H, "KH": KH, "tp": tp, "rank": rank,
                    "kv_heads": kv.stop - kv.start,
                    "q_heads": (width if kv.stop - kv.start > 1
                                and width > n else n),
                    "max_abs_err": err, "ms": time_ms(windowed),
                    "padded_ms": time_ms(padded),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations"})
    return out


def mesh_serving_phase(device, base: str, cfg, want) -> dict:
    """Phase 23 (``mesh_serving``, ``encoder_tp``). In this process, at
    world 1 over NCCL: phase 3's export and traffic through
    ``ModelServer(decode_mesh=parse_serving_mesh("tp=1"))``, and phase
    4's f32 greedy requests through an engine over that mesh, whose
    streams must be ``want`` (phase 4's unsplit engine's); then the
    unsplit engine's streams of :func:`mesh_requests`' sampled requests
    and its KV bytes, paged and dense. Then two ranks on the one card at
    tp = 2 over gloo (:func:`serve_rank_main`): ``ModelServer(
    decode_mesh=)`` on rank 0 and ``serve_follower`` on rank 1 answer
    the greedy and the sampled requests through REST, paged and dense
    (streams the unsplit engine's, every rank the same tokens, each
    rank's KV half the unsplit one's), and three f32 BERT MLM and ViT
    steps run against the unsplit ones (loss, grad norm, parameters
    within 1e-5, their movement within ``MESH_MOVED_LIMIT``). Where gloo
    cannot carry a collective on CUDA tensors, the phase says which, and
    the tp = 2 numerics rest on the CPU gangs
    (``tests/test_torch_mesh_serving.py``,
    ``tests/test_torch_encoder_tp.py``)."""
    import torch

    from kubeflow_tpu_torch.parallel.mesh import parse_serving_mesh
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.testing import run_multiprocess

    t0 = time.perf_counter()
    mesh = parse_serving_mesh("tp=1", device_type=device.type)
    lm_only = tempfile.mkdtemp(prefix="kftpu-mesh-serve-")
    try:
        os.symlink(os.path.join(base, "lm"), os.path.join(lm_only, "lm"))
        serve = serve_phase(lm_only, cfg, device, decode_mesh=mesh)
    finally:
        shutil.rmtree(lm_only, ignore_errors=True)
    reqs = mesh_requests(cfg.vocab_size)
    unsplit = {}
    for m in (mesh, None):
        cfg32, model = load_f32(base, cfg, device, mesh=m)
        for mode in ("paged", "dense") if m is None else ("paged",):
            eng = DecodeEngine(cfg32, model, slots=8, paged=mode == "paged",
                               paged_attention_impl="kernel",
                               sampler_impl="fused", steps_per_sync=4,
                               autostart=False, device=device, mesh=m)
            if m is not None:
                world1 = engine_streams(eng, reqs["greedy"])
                check(world1 == want, f"f32 greedy over the tp=1 mesh "
                                      f"differs from phase 4's unsplit "
                                      f"engine: {world1} vs {want}")
            else:
                k = eng._cache.k
                unsplit[mode] = {
                    "sampled": engine_streams(eng, reqs["sampled"]),
                    "kv_bytes": 2 * k.numel() * k.element_size()}
            eng.close()
            del eng
        del model
        torch.cuda.empty_cache()
    checks = mesh_kernel_checks(device)
    replicated = replicated_kv_times(device)
    t_world1 = time.perf_counter() - t0
    out_dir = tempfile.mkdtemp(prefix="kftpu-serve-ranks-")
    lm32 = os.path.join(out_dir, "models")
    os.makedirs(lm32)
    os.symlink(os.path.join(base, "lm32"), os.path.join(lm32, "lm32"))
    try:
        procs = run_multiprocess(
            [os.path.abspath(__file__), "--serve-rank", out_dir, lm32,
             str(device)], 2, timeout_s=300.0, job_name="serve-smoke")
        for r in procs:
            check(r.returncode == 0,
                  f"serve rank {r.process_id} ended {r.returncode}:\n"
                  f"{r.stderr[-4000:]}")
        ranks = []
        for i in range(2):
            with open(os.path.join(out_dir, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"serve": serve, "world1_streams": world1, "checks": checks,
           "replicated": replicated, "gloo": ranks[0]["gloo"],
           "world1_s": t_world1, "mesh_serving": dict(serve["launches"]),
           "encoder_tp": {}}
    if "serving" not in ranks[0]:
        return res
    tp = 2
    for mode in ("paged", "dense"):
        r0, r1 = (r["serving"][mode] for r in ranks)
        check(r0["greedy"]["streams"] == want,
              f"tp=2 {mode} f32 greedy streams differ from the unsplit "
              f"engine's: {r0['greedy']['streams']} vs {want}")
        check(r0["sampled"]["streams"] == unsplit[mode]["sampled"],
              f"tp=2 {mode} f32 sampled streams differ from the unsplit "
              f"engine's: {r0['sampled']['streams']} vs "
              f"{unsplit[mode]['sampled']}")
        check(r0["log"] == r1["log"] and r0["log"],
              f"tp=2 {mode}: the ranks sampled different tokens")
        heads = r0["cache"][3]
        check(heads * tp == cfg.n_kv_heads and r1["kv_heads"] == heads,
              f"tp=2 {mode}: the ranks' caches hold {heads} and "
              f"{r1['kv_heads']} of {cfg.n_kv_heads} kv heads")
        check(r0["kv_bytes"] * tp == unsplit[mode]["kv_bytes"],
              f"tp=2 {mode}: a rank's KV {r0['kv_bytes']} B is not half "
              f"the unsplit {unsplit[mode]['kv_bytes']} B")
        launched = {k: r0["launches"][k] + r1["launches"][k]
                    for k in r0["launches"]}
        check(launched["fused_sample"] > 0 and (
            launched["paged_decode_attention"] > 0) == (mode == "paged"),
            f"tp=2 {mode}: launches {launched}")
        for k, n in launched.items():
            res["mesh_serving"][k] = res["mesh_serving"].get(k, 0) + n
        res[mode] = {"kv_bytes": r0["kv_bytes"], "plans": r0["plans"],
                     "unsplit_kv_bytes": unsplit[mode]["kv_bytes"],
                     "launches": launched}
        for name in ("greedy", "sampled"):
            w = r0[name]["wall_s"]
            res[mode][name] = {"wall_s": w, "tokens_per_s": len(want)
                               * len(want[0]) / w}
    res["shapes"] = ranks[0]["serving"]["paged"]["shapes"]
    for name in ("bert", "vit"):
        e = ranks[0]["encoders"][name]
        check(e["loss"] <= 1e-5 and e["grad_norm"] <= 1e-5
              and e["params"] <= 1e-5 and e["moved"] <= MESH_MOVED_LIMIT,
              f"tp=2 {name} vs unsplit: {e}")
        res[name] = e
    for r in ranks:
        for k, n in r["encoders"]["launches"].items():
            res["encoder_tp"][k] = res["encoder_tp"].get(k, 0) + n
    return res


def print_mesh_serving(ms: dict, cfg, kind: str, ident: str,
                       phase3: dict) -> None:
    """Phase 23's lines."""
    s = ms["serve"]
    print(f"phase 23 phase 3's traffic through ModelServer(decode_mesh="
          f"parse_serving_mesh('tp=1')), world 1 over NCCL ({kind} | "
          f"{ident}): tokens_per_s={s['tokens_per_s']:.1f} (phase 3, no "
          f"mesh: {phase3['tokens_per_s']:.1f}) wall_s={s['wall_s']:.3f} "
          f"ttft_ms_stream={[round(t * 1e3, 1) for t in s['ttft_s']]} "
          f"(phase 3: {[round(t * 1e3, 1) for t in phase3['ttft_s']]}) "
          f"launches={s['launches']}", flush=True)
    print(f"phase 23 f32 greedy over the tp=1 mesh == phase 4's unsplit "
          f"engine ({len(ms['world1_streams'])} x "
          f"{len(ms['world1_streams'][0])} tokens); kernels at the tp=2 "
          f"shapes vs plain: {ms['checks']}; world-1 part "
          f"{ms['world1_s']:.1f}s", flush=True)
    for r in ms["replicated"]:
        print(f"phase 23 paged kernel, kv heads replicated (H {r['H']}, KH "
              f"{r['KH']}, tp {r['tp']}, rank {r['rank']}: {r['q_heads']} q "
              f"heads over {r['kv_heads']} kv head(s)), serving rows, bf16 "
              f"({kind} | {ident}): kernel_ms="
              f"{r['ms']:.4f} (every q head over the whole pool, as "
              f"before: {r['padded_ms']:.4f}) bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.2e}",
              flush=True)
    print(f"phase 23 gloo on CUDA tensors, two ranks on one card: "
          f"{ms['gloo']}", flush=True)
    if "bert" not in ms:
        print("phase 23 tp=2 on the card: skipped, gloo cannot carry "
              "the collectives above; the tp=2 numerics rest on the CPU "
              "gangs", flush=True)
        return
    for mode in ("paged", "dense"):
        r = ms[mode]
        print(f"phase 23 tp=2 ModelServer(decode_mesh=) on rank 0, "
              f"serve_follower on rank 1, {mode}, f32, two ranks on one "
              f"card over gloo ({kind} | {ident}): greedy streams == the "
              f"unsplit engine's (tokens_per_s="
              f"{r['greedy']['tokens_per_s']:.1f} wall_s="
              f"{r['greedy']['wall_s']:.3f}), sampled streams == the "
              f"unsplit engine's (tokens_per_s="
              f"{r['sampled']['tokens_per_s']:.1f} wall_s="
              f"{r['sampled']['wall_s']:.3f}), both ranks sampled the same "
              f"tokens; {r['plans']} plans; a rank's KV cache "
              f"{r['kv_bytes']} B of the unsplit {r['unsplit_kv_bytes']} B;"
              f" launches {r['launches']}", flush=True)
    print(f"phase 23 load_version(mesh=) on a rank: {ms['shapes']}",
          flush=True)
    for name in ("bert", "vit"):
        e = ms[name]
        print(f"phase 23 f32 {name} step over tp=2 vs unsplit, "
              f"{ENC_STEPS} steps, 2 layers at base widths, TF32 off: max "
              f"loss err {e['loss']:.2e}, grad_norm rel err "
              f"{e['grad_norm']:.2e}, param err {e['params']:.2e} (limits "
              f"1e-5), movement err {e['moved']:.2e} (limit "
              f"{MESH_MOVED_LIMIT}); losses {e['losses']}; grad norms "
              f"{e['norms']}; split run {e['wall_s']:.1f}s", flush=True)
    print(f"phase 23 launches: mesh_serving={ms['mesh_serving']} "
          f"encoder_tp={ms['encoder_tp']}", flush=True)


# phase 24: the elastic plane at examples/lm.py's widths (bf16, flash;
# its depth cut from 12 layers to 6 to hold the script's time); its f32
# check at MESH_PARITY's; batch prediction over phase 17's ResNet-50
# export; the multislice check; Podracer
ELASTIC_LM = dict(vocab_size=32000, d_model=768, n_layers=6, n_heads=12,
                  n_kv_heads=12, d_ff=3072, max_seq_len=512,
                  attention_impl="flash")
ELASTIC_ROWS = 8               # examples/lm.py's per-device batch
ELASTIC_JOB = dict(job="smoke-elastic", namespace="default", uid="phase-24")
ELASTIC_LIMIT = 1e-5           # phase 21's f32 limits
BATCH_PREDICT_N, BATCH_PREDICT_BATCH = 40, 16
# what phase 24's gang and resume run: this file (a CPU rehearsal at
# small widths points it at a wrapper that shrinks the constants above)
SCRIPT = os.path.abspath(__file__)


def _elastic_tokens(step: int, rows: int, cfg):
    """The elastic runs' global batch of ``step``: step-keyed, the same
    on every topology."""
    import numpy as np

    return np.random.default_rng([24, step]).integers(
        0, cfg.vocab_size, (rows, cfg.max_seq_len)).astype(np.int32)


def _regang(n_slices: int) -> None:
    """The operator's refreshed env contract for the new world (one rank
    a slice; a new coordinator address agreed over the old group), then
    the production re-init (``elastic/coordinator.py:_default_reinit``:
    every rank leaves the group; a new world of one gets its one-rank
    NCCL group from the next mesh)."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch.elastic.coordinator import _default_reinit
    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.testing.multiprocess import _free_port

    port = [_free_port() if tdist.get_rank() == 0 else None]
    tdist.broadcast_object_list(port, src=0)
    os.environ.update({dist.ENV_COORDINATOR: f"127.0.0.1:{port[0]}",
                       dist.ENV_NUM_PROCESSES: str(n_slices),
                       dist.ENV_NUM_SLICES: str(n_slices)})
    _default_reinit(n_slices)


def _elastic_coordinator(device, ckpt_dir: str, init_fn, signal=None,
                         collector=None):
    from kubeflow_tpu_torch.elastic import ElasticCoordinator, mesh_for_slices
    from kubeflow_tpu_torch.obs.trace import Tracer
    from kubeflow_tpu_torch.train import make_lm_train_step
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    return ElasticCoordinator(
        manager=CheckpointManager(ckpt_dir), init_fn=init_fn,
        make_step=make_lm_train_step,
        mesh_factory=lambda n: mesh_for_slices(n, device_type=device.type),
        signal=signal, reinit=_regang,
        tracer=Tracer(collector) if collector is not None else None,
        device=device,
        **ELASTIC_JOB)


def _elastic_lm(seed: int, *, weights: bool = True):
    """The bf16 run's config and ``init_fn`` (random weights from a numpy
    seed, ``examples/lm.py``'s optimizer). Without ``weights`` the
    ``init_fn`` builds on the meta device only: a process that restores
    needs no fresh weights."""
    from kubeflow_tpu_torch.elastic import lm_init_fn
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import make_optimizer

    cfg = TransformerConfig(**ELASTIC_LM)
    return cfg, lm_init_fn(
        cfg, convert.random_params(cfg, seed) if weights else None,
        make_optimizer(3e-4, warmup_steps=20, decay_steps=101))


def _state_is(state, saved) -> bool:
    """Whether a train state holds the saved tree bit for bit (module,
    both moments, the update count and the step)."""
    import torch

    module = state.module.state_dict()
    if set(module) != set(saved["module"]) or state.step != saved["step"]:
        return False
    if not all(torch.equal(t.cpu(), saved["module"][n])
               for n, t in module.items()):
        return False
    opt = state.opt_state
    return opt["count"] == saved["opt_state"]["count"] and all(
        torch.equal(a.cpu(), b) for key in ("mu", "nu")
        for a, b in zip(opt[key], saved["opt_state"][key]))


def _elastic_main(device, out: str) -> dict:
    """One rank of the bf16 run: 3 steps at 2 slices (one rank each, over
    gloo), the resize to 1 (rank 1 snapshots and leaves; rank 0 re-enters
    at world 1 over NCCL, restores and takes steps 4-6), then the
    ``SHUTDOWN`` snapshot at step 6. Kernel launches counted over it
    all."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.elastic import ResizeSignal
    from kubeflow_tpu_torch.elastic.coordinator import SHUTDOWN
    from kubeflow_tpu_torch.obs.goodput import checkpoint_save_seconds
    from kubeflow_tpu_torch.obs.trace import SpanCollector

    t0 = time.perf_counter()
    cfg, init_fn = _elastic_lm(SEED + 80)
    collector, signal = SpanCollector(), ResizeSignal()
    ckpt_dir = os.path.join(out, "ckpt-bf16")
    coord = _elastic_coordinator(device, ckpt_dir, init_fn, signal,
                                 collector)
    rows = ELASTIC_ROWS * 2                # the global batch at 2 slices
    res = {"setup_s": time.perf_counter() - t0, "losses": [],
           "step_ms": []}

    ops.reset_launches()
    state, start = coord.start(2)
    check(start == 0, f"the first start resumed at {start}")

    def step(n):
        nonlocal state
        _sync(device)
        t = time.perf_counter()
        state, m = coord.step_fn(state, _elastic_tokens(n, rows, cfg))
        coord.step = n
        res["losses"].append(float(m["loss"]))
        res["step_ms"].append((time.perf_counter() - t) * 1e3)

    for n in (1, 2, 3):
        step(n)
    res["world"] = tdist.get_world_size()
    signal.request(1)
    old = state
    try:
        state, resized = coord.maybe_resize(state)
    except SystemExit:
        res.update(left=True, saves=coord.snapshotter.saves,
                   launches=ops.launch_counts())
        return res
    res["left"] = False
    res["new_world"] = tdist.get_world_size()
    res["backend"] = tdist.get_backend()
    _, saved = coord.manager.read(3)
    res["restored_is_snapshot"] = _state_is(state, saved)
    res["snapshot_is_state"] = _state_is(old, saved)
    del old, saved
    step(4)
    res["step_after_resize"] = state.step
    for n in (5, 6):
        step(n)
    res["snapshot_bytes"] = os.path.getsize(
        os.path.join(ckpt_dir, "3", "state.pt"))
    signal.request(SHUTDOWN)
    try:
        coord.maybe_resize(state)
        res["shutdown"] = False
    except SystemExit:
        res["shutdown"] = True
    res["launches"] = ops.launch_counts()
    res["saves"] = coord.snapshotter.saves
    res["save_s"] = checkpoint_save_seconds(ELASTIC_JOB["namespace"],
                                            ELASTIC_JOB["job"])
    res["spans"] = [{"name": s.name, "trace_id": s.trace_id,
                     "parent_id": s.parent_id, "s": s.end - s.start}
                    for s in collector.spans()]
    res["trace"] = [coord.trace_id, coord.root_span_id]
    res["wall_s"] = time.perf_counter() - t0
    return res


def _elastic_f32(device, out: str) -> dict:
    """One rank of the f32 run (TF32 off) at MESH_PARITY's widths with
    flash: 2 steps at 2 slices, the resize, 1 step at 1 slice; rank 0
    then holds it against 3 unbroken mesh-less steps on the same weights
    and batches."""
    from kubeflow_tpu_torch.elastic import ResizeSignal, lm_init_fn
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import (
        create_train_state,
        make_lm_train_step,
        make_optimizer,
    )

    def tx():
        return make_optimizer(1e-5, warmup_steps=1, decay_steps=50)

    cfg = TransformerConfig(**MESH_PARITY, attention_impl="flash")
    params = convert.random_params(cfg, SEED + 81)
    signal = ResizeSignal()
    coord = _elastic_coordinator(device, os.path.join(out, "ckpt-f32"),
                                 lm_init_fn(cfg, params, tx()), signal)
    rows = MESH_PARITY_BATCH * 2
    state, _ = coord.start(2)
    metrics = []
    for n in (1, 2, 3):
        if n == 3:
            signal.request(1)
            try:
                state, _ = coord.maybe_resize(state)
            except SystemExit:
                return {"left": True}
        state, m = coord.step_fn(state, _elastic_tokens(n, rows, cfg))
        coord.step = n
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    plain = create_train_state(cfg, params, tx(), device=device)
    p0 = {n: p.detach().float().clone()
          for n, p in plain.module.named_parameters()}
    plain_step = make_lm_train_step()
    errs = {"left": False, "loss": 0.0, "grad_norm": 0.0, "losses": []}
    for n, (loss, gnorm) in enumerate(metrics, 1):
        plain, pm = plain_step(plain, _elastic_tokens(n, rows, cfg))
        errs["loss"] = max(errs["loss"], abs(loss - float(pm["loss"])))
        errs["grad_norm"] = max(errs["grad_norm"],
                                abs(gnorm / float(pm["grad_norm"]) - 1.0))
        errs["losses"].append(loss)
    full = convert.gather_params(state.module)
    errs["params"] = max(_max_err(full[n], p) for n, p in
                         plain.module.named_parameters())
    errs["moved"] = _moved_err(full, plain.module.named_parameters(), p0)
    errs["step"] = state.step
    return errs


def _rejoin(port: int) -> None:
    """Both ranks back into one gloo group of 2 after the f32 shrink (rank
    1 left it; rank 0 holds a one-rank group), on a fresh store at
    ``port``: the two runs share one gang's start-up."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import distributed as dist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    os.environ.update({dist.ENV_COORDINATOR: f"127.0.0.1:{port}",
                       dist.ENV_NUM_PROCESSES: "2",
                       dist.ENV_NUM_SLICES: "2"})
    dist.initialize(dist.from_env(), backend="gloo")


def elastic_rank_main(argv) -> int:
    """One rank of phase 24's elastic runs, two ranks on one card over
    gloo on CUDA tensors (NCCL refuses two ranks on one card), started
    by :func:`elastic_phase` through ``run_multiprocess`` with the env
    contract: ``chip_smoke.py --elastic-rank OUT PORT [DEVICE]``. The
    f32 run (:func:`_elastic_f32`), both ranks back into a group of 2 at
    ``PORT``, then the bf16 run (:func:`_elastic_main`). Writes
    ``OUT/rank<r>.json``."""
    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import distributed as dist

    out, port, *where = argv
    penv = dist.from_env()
    device = torch.device(where[0] if where else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize(penv, backend="gloo")
    res = {"rank": penv.process_id}
    t0 = time.perf_counter()
    res["f32"] = _elastic_f32(device, out)
    res["f32_s"] = time.perf_counter() - t0
    _rejoin(int(port))
    res["bf16"] = _elastic_main(device, out)
    with open(os.path.join(out, f"rank{penv.process_id}.json"), "w") as f:
        json.dump(res, f)
    _sync(device)
    if tdist.is_initialized():
        tdist.destroy_process_group()
    return 0


def elastic_resume_main(argv) -> int:
    """The fresh process after the ``SHUTDOWN`` snapshot, started once
    the gang has ended: ``start(1)`` over the bf16 run's checkpoint must
    resume at step 6, and step 7 must follow (``chip_smoke.py
    --elastic-resume OUT [DEVICE]``). Writes ``OUT/resume.json``."""
    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.obs.trace import SpanCollector

    out, *where = argv
    device = torch.device(where[0] if where else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg, init_fn = _elastic_lm(SEED + 80, weights=False)
    collector = SpanCollector()
    coord = _elastic_coordinator(device, os.path.join(out, "ckpt-bf16"),
                                 init_fn, collector=collector)
    t0 = time.perf_counter()
    ops.reset_launches()
    state, start = coord.start(1)
    state, m = coord.step_fn(state, _elastic_tokens(
        start + 1, ELASTIC_ROWS * 2, cfg))
    res = {"start": start, "step": state.step, "loss": float(m["loss"]),
           "launches": ops.launch_counts(),
           "spans": [(s.name, s.end - s.start) for s in collector.spans()],
           "wall_s": time.perf_counter() - t0}
    with open(os.path.join(out, "resume.json"), "w") as f:
        json.dump(res, f)
    _sync(device)
    if tdist.is_initialized():
        tdist.destroy_process_group()
    return 0


def elastic_phase(device) -> dict:
    """Phase 24 (a): one gang of two ranks runs the f32 elastic run and
    its checks against the unbroken steps, then the bf16 run at
    ``examples/lm.py``'s widths; once the gang has ended, a fresh
    process resumes the bf16 run's ``SHUTDOWN`` snapshot. The
    ``elastic`` launches are the bf16 run's and the resume's."""
    import math

    from kubeflow_tpu_torch.testing import run_multiprocess
    from kubeflow_tpu_torch.testing.multiprocess import _free_port

    out = tempfile.mkdtemp(prefix="kftpu-elastic-")
    try:
        t0 = time.perf_counter()
        procs = run_multiprocess(
            [SCRIPT, "--elastic-rank", out, str(_free_port()), str(device)],
            2, timeout_s=600.0, job_name="elastic")
        for r in procs:
            check(r.returncode == 0, f"elastic rank {r.process_id} of "
                                     f"{len(procs)} ended {r.returncode}:"
                                     f"\n{r.stderr[-4000:]}")
        t1 = time.perf_counter()
        (r,) = run_multiprocess([SCRIPT, "--elastic-resume", out,
                                 str(device)], 1, timeout_s=600.0,
                                job_name="elastic-resume")
        check(r.returncode == 0, f"the resuming process ended "
                                 f"{r.returncode}:\n{r.stderr[-4000:]}")
        res = {"gang_s": t1 - t0, "resume_s": time.perf_counter() - t1}
        ranks = []
        for i in range(2):
            with open(os.path.join(out, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
        with open(os.path.join(out, "resume.json")) as f:
            res["resume"] = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    res["f32"] = [r["f32"] for r in ranks]
    res["bf16"] = [r["bf16"] for r in ranks]
    res["f32_s"] = ranks[0]["f32_s"]
    f0, f1 = res["f32"]
    check(not f0["left"] and f1["left"],
          f"f32 run: rank 0 left {f0['left']}, rank 1 left {f1['left']}")
    check(f0["loss"] <= ELASTIC_LIMIT and f0["grad_norm"] <= ELASTIC_LIMIT
          and f0["params"] <= ELASTIC_LIMIT
          and f0["moved"] <= MESH_MOVED_LIMIT and f0["step"] == 3,
          f"f32 elastic run vs 3 unbroken steps: {f0}")
    b0, b1 = res["bf16"]
    check(not b0["left"] and b1["left"] and b1["saves"] == 1,
          f"bf16 run: rank 0 left {b0['left']}, rank 1 left {b1['left']} "
          f"after {b1['saves']} snapshot(s)")
    check(b0["world"] == 2 and b0["new_world"] == 1,
          f"worlds {b0['world']} -> {b0['new_world']}")
    check(b0["restored_is_snapshot"] and b0["snapshot_is_state"],
          "the restored state is not the snapshot bit for bit")
    check(b0["step_after_resize"] == 4,
          f"state.step {b0['step_after_resize']} after the first step on "
          f"the new mesh")
    check(b0["shutdown"] and b0["saves"] == 2,
          f"SHUTDOWN: exited {b0['shutdown']}, {b0['saves']} snapshots")
    check(all(math.isfinite(x) for x in b0["losses"]) and len(
        b0["losses"]) == 6, f"bf16 losses {b0['losses']}")
    names = [s["name"] for s in b0["spans"]]
    check(names == ["elastic.snapshot", "elastic.reshard", "elastic.resume",
                    "elastic.snapshot"]
          and all([s["trace_id"], s["parent_id"]] == b0["trace"]
                  for s in b0["spans"]),
          f"spans {b0['spans']} under {b0['trace']}")
    r = res["resume"]
    check(r["start"] == 6 and r["step"] == 7 and math.isfinite(r["loss"]),
          f"the fresh process resumed at {r['start']} to step {r['step']}")
    res["launches"] = {k: b0["launches"][k] + b1["launches"][k]
                       + r["launches"][k] for k in b0["launches"]}
    return res


def _write_instances(path: str, pixels) -> int:
    with open(path, "w") as f:
        for img in pixels:
            f.write(json.dumps(img.tolist()) + "\n")
    return os.path.getsize(path)


def batch_predict_phase(device, root: str) -> dict:
    """Phase 24 (b): ``run_batch_predict`` over phase 17's fused
    ResNet-50 export, 40 instances (raw uint8 pixels) at batch 16, so
    the last chunk is padded: every prediction equal to
    ``LoadedModel.predict`` on the same padded chunk, bit for bit, and
    the bnconv forward launched 16 times a chunk (the ``batch_predict``
    path)."""
    import numpy as np

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving import batch_predict
    from kubeflow_tpu_torch.serving import model_store as store

    base = os.path.join(root, "resnet50")
    tmp = tempfile.mkdtemp(prefix="kftpu-batch-predict-")
    try:
        model = store.load_latest(base, device=device)
        shape = model.input_shape
        pixels = np.random.default_rng(SEED + 90).integers(
            0, 256, (BATCH_PREDICT_N, *shape), dtype=np.uint8)
        inp, outp = os.path.join(tmp, "in.jsonl"), os.path.join(tmp,
                                                                "out.jsonl")
        t0 = time.perf_counter()
        in_bytes = _write_instances(inp, pixels)
        write_s = time.perf_counter() - t0
        ops.reset_launches()
        summary = batch_predict.run_batch_predict(
            base, inp, outp, batch_size=BATCH_PREDICT_BATCH, device=device)
        launches = ops.launch_counts()
        with open(outp) as f:
            preds = np.asarray([json.loads(line)["prediction"]
                                for line in f], np.float32)
        want = []
        B = BATCH_PREDICT_BATCH
        for i in range(0, BATCH_PREDICT_N, B):
            chunk = pixels[i:i + B].astype(np.float32)
            n = chunk.shape[0]
            pad = np.zeros((B - n, *shape), np.float32)
            want.append(model.predict(np.concatenate([chunk, pad]))[:n])
        want = np.concatenate(want)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    chunks = -(-BATCH_PREDICT_N // B)
    check(summary["instances"] == BATCH_PREDICT_N and preds.shape ==
          want.shape and np.isfinite(preds).all(),
          f"batch predict: {summary}, predictions {preds.shape}")
    check(np.array_equal(preds, want),
          f"batch predictions differ from LoadedModel.predict by "
          f"{float(np.abs(preds - want).max())}")
    check(launches["bnconv_fwd"] == 16 * chunks and all(
        n == 0 for k, n in launches.items() if k != "bnconv_fwd"),
        f"batch predict launched {launches}, not bnconv_fwd {16 * chunks}")
    return {"summary": summary, "launches": launches, "chunks": chunks,
            "in_mb": in_bytes / 1e6, "write_s": write_s,
            "classes": preds.shape[1]}


def multislice_phase(device) -> dict:
    """Phase 24 (c): ``testing/multislice_check`` with one rank a card
    (one slice each, tp 1) over NCCL through ``run_multiprocess``: every
    rank prints ``ok`` and the same losses, and those are held against
    plain ``make_lm_train_step`` steps in this process on the same
    weights and tokens (f32, TF32 off), within ``ELASTIC_LIMIT``."""
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.testing import multislice_check as msc
    from kubeflow_tpu_torch.testing import run_multiprocess
    from kubeflow_tpu_torch.train import (
        create_train_state,
        make_lm_train_step,
        make_optimizer,
    )

    n = torch.cuda.device_count() if device.type == "cuda" else 2
    t0 = time.perf_counter()
    procs = run_multiprocess(
        ["-m", "kubeflow_tpu_torch.testing.multislice_check", "--tp", "1",
         "--device", device.type], n,
        env_per_process=[{"MEGASCALE_SLICE_ID": str(i),
                          "MEGASCALE_NUM_SLICES": str(n)} for i in range(n)],
        timeout_s=300.0, job_name="multislice-smoke")
    outs = []
    for r in procs:
        check(r.returncode == 0, f"multislice rank {r.process_id} ended "
                                 f"{r.returncode}:\n{r.stderr[-4000:]}")
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    check(all(o["ok"] and o["losses"] == outs[0]["losses"] for o in outs),
          f"multislice ranks: {outs}")
    wall_s = time.perf_counter() - t0
    cfg = TransformerConfig(**msc.CONFIG)
    state = create_train_state(cfg, convert.random_params(
        cfg, msc.WEIGHT_SEED), make_optimizer(**msc.OPT), device=device)
    step, batch, plain = make_lm_train_step(), msc.tokens(cfg.vocab_size), []
    for _ in range(msc.STEPS):
        state, metrics = step(state, batch)
        plain.append(float(metrics["loss"]))
    err = max(abs(a - b) for a, b in zip(outs[0]["losses"], plain))
    check(len(outs[0]["losses"]) == len(plain) and err <= ELASTIC_LIMIT,
          f"multislice losses {outs[0]['losses']} vs plain steps {plain}: "
          f"max err {err:.2e} > {ELASTIC_LIMIT:.0e}")
    return {"ranks": outs, "wall_s": wall_s, "plain": plain, "err": err}


def podracer_phase(device) -> dict:
    """Phase 24 (d): ``examples.podracer.main`` at its defaults: the
    learner's clock monotone over 2 → 1 → 2 actor slices."""
    from kubeflow_tpu_torch.examples import podracer

    t0 = time.perf_counter()
    out = podracer.main(["--device", str(device)])
    out["wall_s"] = time.perf_counter() - t0
    check(out["learner_monotone"] and out["actor_resizes"] == 2
          and out["actor_slices"] == 2 and out["learner_steps"] == 9,
          f"podracer: {out}")
    return out


def phase24(device, base: str, kernels: list, kind: str, ident: str) -> None:
    """Phase 24's four parts, each fatal, their lines, and the
    ``elastic`` and ``batch_predict`` paths of the kernel record."""
    el = elastic_phase(device)
    bp = batch_predict_phase(device, os.path.join(base, "predict-store"))
    ms = multislice_phase(device)
    pod = podracer_phase(device)
    for kern in kernels:
        for path, launched in (("elastic", el["launches"]),
                               ("batch_predict", bp["launches"])):
            n = launched.get(kern["name"], 0)
            kern["launches_by_path"][path] = n
            kern["launches"] += n
    for kern in kernels[FLASH_RECORDS]:
        check(kern["launches_by_path"]["elastic"] > 0,
              f"{kern['name']} never launched on the elastic path")
    for kern in kernels[SERVING_RECORDS] + kernels[BNCONV_RECORDS]:
        check(kern["launches_by_path"]["elastic"] == 0,
              f"{kern['name']} launched on the elastic path")
    b0, f0, r = el["bf16"][0], el["f32"][0], el["resume"]
    span = {}
    for sp in b0["spans"]:
        span.setdefault(sp["name"], []).append(sp["s"])
    print(f"phase 24 elastic shrink ({kind} | {ident}): examples/lm.py's "
          f"widths (d_model 768, {ELASTIC_LM['n_layers']} layers, 12 "
          f"heads, d_ff 3072, vocab 32000, seq 512), bf16/f32, flash, "
          f"remat; 2 ranks on one card "
          f"over gloo (2 slices x dp 1, global batch "
          f"{ELASTIC_ROWS * 2}) for steps 1-3, then rank 1 leaves and "
          f"rank 0 re-enters at world 1 over {b0['backend']} for steps "
          f"4-6: losses={[round(x, 4) for x in b0['losses']]} "
          f"step_ms={[round(x, 1) for x in b0['step_ms']]}; snapshot "
          f"span {span['elastic.snapshot'][0]:.3f}s (the save alone "
          f"{b0['save_s']:.3f}s over both snapshots), reshard span "
          f"{span['elastic.reshard'][0]:.3f}s (re-init, mesh, restore), "
          f"resume span {span['elastic.resume'][0]:.6f}s; checkpoint "
          f"{b0['snapshot_bytes']} bytes; restored state == snapshot == "
          f"the live state, bit for bit; state.step "
          f"{b0['step_after_resize']} after the first step on the new "
          f"mesh; SHUTDOWN snapshot {span['elastic.snapshot'][1]:.3f}s; "
          f"a fresh process resumed at step {r['start'] + 1} "
          f"(start(1) restore span {r['spans'][0][1]:.3f}s, start and "
          f"step 7 {r['wall_s']:.1f}s, the process "
          f"{el['resume_s']:.1f}s); bf16 run "
          f"{b0['wall_s']:.1f}s in the gang of {el['gang_s']:.1f}s; "
          f"launches={el['launches']}", flush=True)
    print(f"phase 24 f32 elastic run (TF32 off, 2 layers at the widths "
          f"above, flash): 2 steps at 2 slices, resize, 1 at 1 slice vs 3 "
          f"unbroken make_lm_train_step steps: max loss err "
          f"{f0['loss']:.2e}, grad_norm rel err {f0['grad_norm']:.2e}, "
          f"param err {f0['params']:.2e} (limits {ELASTIC_LIMIT:.0e}), "
          f"movement err {f0['moved']:.2e} (limit "
          f"{MESH_MOVED_LIMIT:.0e}); losses {f0['losses']}; "
          f"{el['f32_s']:.1f}s", flush=True)
    sm = bp["summary"]
    print(f"phase 24 run_batch_predict ({kind} | {ident}): phase 17's "
          f"resnet50 (fused, bf16/f32), {BATCH_PREDICT_N} instances of "
          f"uint8 pixels as JSON ({bp['in_mb']:.1f} MB, written in "
          f"{bp['write_s']:.2f}s) at batch {BATCH_PREDICT_BATCH} "
          f"({bp['chunks']} chunks, the last padded): "
          f"instances_per_s={sm['instances_per_sec']} "
          f"wall_s={sm['wall_time_s']} (JSON decode included); "
          f"predictions == LoadedModel.predict bit for bit; "
          f"launches={bp['launches']}", flush=True)
    print(f"phase 24 multislice_check ({kind} | {ident}): "
          f"{len(ms['ranks'])} rank(s), one slice each, mesh "
          f"{ms['ranks'][0]['mesh']}: ok on every rank, losses "
          f"{ms['ranks'][0]['losses']} ({ms['wall_s']:.1f}s); plain "
          f"make_lm_train_step in this process {ms['plain']}: max err "
          f"{ms['err']:.2e} (limit {ELASTIC_LIMIT:.0e})", flush=True)
    print(f"phase 24 examples.podracer.main at its defaults ({kind} | "
          f"{ident}): learner_steps={pod['learner_steps']} "
          f"learner_monotone={pod['learner_monotone']} "
          f"actor_resizes={pod['actor_resizes']} "
          f"actor_slices={pod['actor_slices']} "
          f"last_reward={pod['last_reward']:.4f} ({pod['wall_s']:.1f}s)",
          flush=True)


# -- phase 25: every mesh composition the reference accepts -----------------

# the model ``examples/lm.py --n-experts 8`` trains (its defaults: kv
# heads = heads, max_seq_len = seq_len, dense top-2 dispatch), served;
# its depth cut from 12 layers to 6 with phase 26 added, then to 4 to
# hold the script's time (PERF.md §4)
COMPOSE_MOE = dict(vocab_size=32000, d_model=768, n_layers=4, n_heads=12,
                   n_kv_heads=12, d_ff=3072, max_seq_len=512, n_experts=8,
                   experts_per_token=2)
# (b): examples/bert.py's and examples/resnet.py's per-device batches,
# BERT at its seq 128; warm-up and timed steps each
COMPOSE_BERT_BATCH, COMPOSE_BERT_SEQ = 8, 128
COMPOSE_BERT = dict(max_seq_len=COMPOSE_BERT_SEQ)   # BERT-base otherwise
COMPOSE_RESNET_BATCH = 128
COMPOSE_WARMUP, COMPOSE_TIMED = 1, 3
# bf16 at tp = 2 against the unsplit model, teacher-forced over (a)'s
# prompts. A free-running greedy stream of random weights leaves the
# unsplit one at its first near tie, and bf16 itself moves the unsplit
# model's logits far from its f32 ones (the router's top-2 flips on near
# ties). So the split may move the logits (norm-relative) and flip the
# argmax of the unsplit bf16 model no more than this many times as far
# and as often as bf16 does to the f32 model
COMPOSE_BF16_NOISE = 2.0
# the parts of the mesh_compose path, each zeroed just before it
COMPOSE_PARTS = ("serve_world1", "serve_tp2", "bert_pp2", "resnet_pp2",
                 "encoders_pp2", "resnet_pp2_f32", "cp_moe")
CP_IMPLS = ("ring", "ulysses")


# (a)'s rounds at tp = 2: (export, requests of mesh_requests)
COMPOSE_ROUNDS = (("lm32", "greedy"), ("lm32", "sampled"), ("lm", "greedy"))


def _compose_leader(device, base: str, mesh) -> dict:
    """Rank 0 of (a): ``ModelServer(decode_mesh=)`` over ``base`` (the
    MoE LM's f32 export ``lm32`` and bf16 ``lm``), each round of
    :data:`COMPOSE_ROUNDS` through REST at once, after a warm-up request
    a model: streams and walls, the tokens each engine sampled, a rank's
    block of the experts."""
    from kubeflow_tpu_torch.serving.server import ModelServer

    server = ModelServer(base, port=0, decode_slots=8,
                         decode_steps_per_sync=4, poll_interval_s=3600,
                         device=device, decode_mesh=mesh)
    port = server.start()
    res = {}
    try:
        for name in ("lm32", "lm"):
            url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
            lm = server.repo.get(name)
            eng = server.repo.engine_for(name, lm)
            eng.token_log = []
            _post(url, {"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 2},
                  False)
            reqs = mesh_requests(lm.lm_config.vocab_size)
            for model, kind in COMPOSE_ROUNDS:
                if model == name:
                    res[f"{name}/{kind}"] = _round(url, reqs[kind])
            res[name] = {"log": [(op, t.tolist())
                                 for op, t in eng.token_log]}
        res["experts"] = list(server.repo.get("lm").module.blocks[0]
                              .moe.gate_proj.shape)
    finally:
        server.stop()
    return res


def _forced_bf16(device, base: str, mesh) -> dict:
    """The bf16 export's logits at every position of (a)'s greedy
    prompts, teacher-forced through one decode forward on a dense cache
    (MoE's serving path): the model split over ``mesh`` on every rank,
    and on rank 0 the unsplit one at bf16 and at f32; there, the share
    of positions whose argmax agree, the split's norm-relative error
    against the unsplit bf16 logits, and the unsplit bf16 logits' own
    against the f32 ones (bf16's rounding)."""
    import dataclasses

    import torch
    import torch.distributed as tdist
    import yaml

    from kubeflow_tpu_torch.models import convert, decode
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serving.model_store import MODEL_FILE, read_params

    cfg = TransformerConfig(**COMPOSE_MOE)
    vdir = os.path.join(base, "lm", "1")
    with open(os.path.join(vdir, MODEL_FILE)) as f:
        params = read_params(vdir, yaml.safe_load(f))
    prompts = parity_prompts(cfg.vocab_size)
    n = min(len(p) for p in prompts)       # every prompt cut to the shortest
    toks = torch.tensor([p[:n] for p in prompts], dtype=torch.int32,
                        device=device)

    def forced(model):
        cache = decode.init_cache(cfg, toks.shape[0], device=device,
                                  kv_heads=model.cache_kv_heads)
        with torch.no_grad():
            return model(toks, cache).float()

    split = forced(convert.to_module(cfg, params, device=device, mesh=mesh))
    if tdist.get_rank() != 0:
        return {}
    whole = forced(convert.to_module(cfg, params, device=device))
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    f32 = forced(convert.to_module(cfg, params, device=device))
    return {"agree": float((split.argmax(-1) == whole.argmax(-1))
                           .float().mean()),
            "bf16_agree": float((whole.argmax(-1) == f32.argmax(-1))
                                .float().mean()),
            "norm_err": norm_err(split, whole),
            "bf16_err": norm_err(whole, f32)}


def _compose_serving(device, base: str, mesh) -> dict:
    """(a) at tp = 2, paged (through the kernel) and dense, the fused
    sampler: rank 0 serves (:func:`_compose_leader`), rank 1 follows
    (``serve_follower``). Each rank's launches from its server's or
    follower's start to its end."""
    import torch.distributed as tdist

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving.server import serve_follower

    out = {"launches": {}}
    for mode in ("paged", "dense"):
        os.environ["KFTPU_PAGED"] = "1" if mode == "paged" else "0"
        os.environ["KFTPU_SAMPLER_IMPL"] = "fused"
        _sync(device)
        ops.reset_launches()
        if tdist.get_rank() == 0:
            res = _compose_leader(device, base, mesh)
        else:
            f = serve_follower(base, mesh, device=device, record=True)
            res = {name: {"log": [(op, t.tolist()) for op, t in
                                  f.token_logs[(name, 1)]]}
                   for name in ("lm32", "lm")}
        _sync(device)
        for k, n in ops.launch_counts().items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        out[mode] = res
    out["forced"] = _forced_bf16(device, base, mesh)
    return out


def _pp_steps(device, mesh) -> dict:
    """(b) on one rank of pp = 2, every layer on each: BERT-base through
    ``make_mlm_train_step(mesh)`` at ``examples/bert.py``'s widths and
    batch, and ResNet-50 fused through ``make_image_train_step(mesh)``
    at ``examples/resnet.py``'s batch, bf16, each step timed; then the
    f32 twins against the unsplit steps (phase 23's 2-layer BERT and ViT
    at the entry widths, phase 22's small fused ResNet). Launches by
    part."""
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.examples.bert import batch_for_step
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.bert import BertConfig
    from kubeflow_tpu_torch.train import (
        create_bert_train_state,
        make_image_train_step,
        make_mlm_train_step,
        make_optimizer,
    )

    out = {"launches": {}}
    n = COMPOSE_WARMUP + COMPOSE_TIMED
    cfg = BertConfig(**COMPOSE_BERT)
    state = create_bert_train_state(
        cfg, convert.random_bert_params(cfg, SEED + 6),
        make_optimizer(1e-4, warmup_steps=20, decay_steps=101),
        device=device)
    batches = [tuple(t.to(device) for t in batch_for_step(
        i, COMPOSE_BERT_BATCH, COMPOSE_BERT_SEQ, cfg.vocab_size))
        for i in range(n)]
    _sync(device)
    ops.reset_launches()
    state, walls, mets = _timed_steps(device, make_mlm_train_step(mesh),
                                      state, batches, COMPOSE_WARMUP)
    out["launches"]["bert_pp2"] = ops.launch_counts()
    out["bert"] = {"step_ms": [w * 1e3 for w in walls],
                   "losses": [m["loss"] for m in mets],
                   "blocks": len(state.module.blocks)}
    del state, batches
    torch.cuda.empty_cache()
    _, state, images, labels = resnet_setup(device, fused=True)
    images, labels = (images[:COMPOSE_RESNET_BATCH].contiguous(),
                      labels[:COMPOSE_RESNET_BATCH].contiguous())
    _sync(device)
    ops.reset_launches()
    state, walls, mets = _timed_steps(
        device, make_image_train_step(mesh), state,
        [(images, labels)] * n, COMPOSE_WARMUP)
    out["launches"]["resnet_pp2"] = ops.launch_counts()
    out["resnet"] = {"step_ms": [w * 1e3 for w in walls],
                     "losses": [m["loss"] for m in mets]}
    del state, images, labels
    torch.cuda.empty_cache()
    ops.reset_launches()
    out["encoders"] = _encoder_steps(device, mesh)
    out["launches"]["encoders_pp2"] = out["encoders"].pop("launches")
    ops.reset_launches()
    out["resnet_f32"] = _image_mesh_parity(device, mesh)
    out["launches"]["resnet_pp2_f32"] = ops.launch_counts()
    torch.cuda.empty_cache()
    return out


def _cp_moe(device, mesh) -> dict:
    """(c): ring and Ulysses over tp = 2 with ``n_experts=8`` (2 layers at
    ``examples/lm.py``'s widths, f32, TF32 off): three
    ``make_lm_train_step(mesh)`` steps against three mesh-less ones
    (:func:`_mesh_parity`). Launches of both."""
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    out = {}
    ops.reset_launches()
    for impl in CP_IMPLS:
        cfg = TransformerConfig(**MESH_PARITY, n_experts=8,
                                attention_impl=impl)
        t0 = time.perf_counter()
        out[impl] = _mesh_parity(device, mesh, cfg, 1)
        out[impl]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    return out


def compose_rank_main(argv) -> int:
    """One rank of phase 25's gang: two ranks on the one card over gloo
    (NCCL refuses two ranks on one card), started by
    :func:`mesh_compose_phase` through ``run_multiprocess``:
    ``chip_smoke.py --compose-rank OUT BASE [DEVICE]``, ``BASE`` holding
    the MoE LM's exports ``lm32`` and ``lm``. (a) serving at tp = 2,
    (b) the MLM and image steps at pp = 2, (c) ring and Ulysses with MoE
    at tp = 2. Writes ``OUT/rank<r>.json``."""
    import torch
    import torch.distributed as tdist

    from kubeflow_tpu_torch.parallel import distributed as dist
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    out, base, *where = argv
    penv = dist.from_env()
    device = torch.device(where[0] if where else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize(penv, backend="gloo")
    tp2 = create_mesh(MeshConfig(tp=penv.num_processes),
                      device_type=device.type)
    pp2 = create_mesh(MeshConfig(pp=penv.num_processes),
                      device_type=device.type)
    res = {"rank": penv.process_id}
    t0 = time.perf_counter()
    res["serving"] = _compose_serving(device, base, tp2)
    res["serving_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["pp"] = _pp_steps(device, pp2)
    res["pp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["cp_moe"] = _cp_moe(device, tp2)
    res["cp_s"] = time.perf_counter() - t0
    with open(os.path.join(out, f"rank{penv.process_id}.json"), "w") as f:
        json.dump(res, f)
    _sync(device)
    tdist.destroy_process_group()
    return 0


def _agree(got: list, want: list) -> float:
    """The share of positions where two sets of streams hold the same
    token."""
    pairs = [(a, b) for g, w in zip(got, want) for a, b in zip(g, w)]
    return sum(a == b for a, b in pairs) / max(1, len(pairs))


def mesh_compose_phase(device, base: str) -> dict:
    """Phase 25 (``mesh_compose``), each part fatal. (a) The MoE LM of
    ``examples/lm.py --n-experts 8`` (:data:`COMPOSE_MOE`, random weights
    from a numpy seed, exported bf16 and, over the same weights file,
    f32): at world 1 over NCCL phase 3's traffic through
    ``ModelServer(decode_mesh=tp=1)``; the unsplit engine's greedy f32
    and bf16 streams, paged and dense. Then a gang of two ranks on the
    card over gloo (:func:`compose_rank_main`): at tp = 2 rank 0 serves
    both exports, rank 1 follows, paged and dense; f32 greedy and
    sampled streams equal to the unsplit engine's, the ranks sampling
    the same tokens; the bf16 model's teacher-forced logits within
    :data:`COMPOSE_BF16_NOISE` times bf16's own effect
    (:func:`_forced_bf16`). (b) At pp = 2 BERT-base and ResNet-50 fused, timed, and
    their f32 twins against the unsplit steps. (c) Ring and Ulysses
    with 8 experts at tp = 2 against the unsplit step."""
    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.parallel.mesh import parse_serving_mesh
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.model_store import MODEL_FILE, read_params
    from kubeflow_tpu_torch.testing import run_multiprocess

    import math

    import yaml

    cfg = TransformerConfig(**COMPOSE_MOE)         # bf16 over f32 params
    store = os.path.join(base, "compose")
    t0 = time.perf_counter()
    write_export(store, cfg)
    f32_export(store)
    res = {"export_s": time.perf_counter() - t0, "parts": {}}
    mesh = parse_serving_mesh("tp=1", device_type=device.type)
    lm_only = tempfile.mkdtemp(prefix="kftpu-compose-serve-")
    try:
        os.symlink(os.path.join(store, "lm"), os.path.join(lm_only, "lm"))
        res["world1"] = serve_phase(lm_only, cfg, device, decode_mesh=mesh)
    finally:
        shutil.rmtree(lm_only, ignore_errors=True)
    res["parts"]["serve_world1"] = res["world1"]["launches"]
    reqs = mesh_requests(cfg.vocab_size)
    vdir = os.path.join(store, "lm", "1")
    with open(os.path.join(vdir, MODEL_FILE)) as f:
        meta = yaml.safe_load(f)
    unsplit = {}
    t0 = time.perf_counter()
    for dtype in ("f32", "bf16"):
        if dtype == "f32":
            c, model = load_f32(store, cfg, device)
        else:
            c, model = cfg, convert.to_module(cfg, read_params(vdir, meta),
                                              device=device)
        for mode in ("paged", "dense"):
            eng = DecodeEngine(c, model, slots=8, paged=mode == "paged",
                               paged_attention_impl="kernel",
                               sampler_impl="fused", steps_per_sync=4,
                               autostart=False, device=device)
            for kind in ("greedy", "sampled") if dtype == "f32" else (
                    "greedy",):
                unsplit[(dtype, kind, mode)] = engine_streams(eng,
                                                              reqs[kind])
            eng.close()
            del eng
        del model
        torch.cuda.empty_cache()
    res["unsplit_s"] = time.perf_counter() - t0
    check(unsplit[("f32", "greedy", "paged")]
          == unsplit[("f32", "greedy", "dense")],
          "unsplit f32 MoE engine: paged and dense greedy streams differ")
    out_dir = tempfile.mkdtemp(prefix="kftpu-compose-ranks-")
    models = os.path.join(out_dir, "models")
    os.makedirs(models)
    for name in ("lm", "lm32"):
        os.symlink(os.path.join(store, name), os.path.join(models, name))
    t0 = time.perf_counter()
    try:
        procs = run_multiprocess(
            [SCRIPT, "--compose-rank", out_dir, models, str(device)], 2,
            timeout_s=600.0, job_name="compose-smoke")
        for r in procs:
            check(r.returncode == 0,
                  f"compose rank {r.process_id} ended {r.returncode}:\n"
                  f"{r.stderr[-4000:]}")
        ranks = []
        for i in range(2):
            with open(os.path.join(out_dir, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res["gang_s"] = time.perf_counter() - t0
    res["ranks"] = ranks
    r0 = ranks[0]

    def summed(get) -> dict:
        total = {}
        for r in ranks:
            for k, n in get(r).items():
                total[k] = total.get(k, 0) + n
        return total

    # (a) tp = 2 serving
    res["parts"]["serve_tp2"] = summed(lambda r: r["serving"]["launches"])
    res["tp2"] = {}
    for mode in ("paged", "dense"):
        lead = r0["serving"][mode]
        for kind in ("greedy", "sampled"):
            got = lead[f"lm32/{kind}"]["streams"]
            want = unsplit[("f32", kind, mode)]
            check(got == want, f"tp=2 {mode} f32 MoE {kind} streams differ "
                               f"from the unsplit engine's: {got} vs {want}")
        got32 = lead["lm32/greedy"]
        agree = _agree(lead["lm/greedy"]["streams"],
                       unsplit[("bf16", "greedy", mode)])
        for name in ("lm32", "lm"):
            logs = [r["serving"][mode][name]["log"] for r in ranks]
            check(logs[0] == logs[1] and logs[0],
                  f"tp=2 {mode} {name}: the ranks sampled different tokens")
        tokens = sum(len(t) for t in lead["lm/greedy"]["streams"])
        res["tp2"][mode] = {
            "agree": agree,
            "f32_tokens_per_s": sum(len(t) for t in got32["streams"])
            / got32["wall_s"],
            "bf16_tokens_per_s": tokens / lead["lm/greedy"]["wall_s"]}
    forced = r0["serving"]["forced"]
    check(1 - forced["agree"] <= COMPOSE_BF16_NOISE * (
        1 - forced["bf16_agree"]) and forced["norm_err"]
        <= COMPOSE_BF16_NOISE * forced["bf16_err"],
          f"tp=2 bf16 MoE logits vs unsplit, teacher-forced: {forced}")
    res["forced"] = forced
    check(r0["serving"]["paged"]["experts"] == [
        cfg.n_experts, cfg.d_model, cfg.d_ff // 2],
        f"tp=2: a rank's experts {r0['serving']['paged']['experts']}")
    # (b) pp = 2
    for part in ("bert_pp2", "resnet_pp2", "encoders_pp2",
                 "resnet_pp2_f32"):
        res["parts"][part] = summed(lambda r: r["pp"]["launches"][part])
    for r in ranks:
        for name in ("bert", "resnet"):
            losses = r["pp"][name]["losses"]
            check(all(math.isfinite(x) for x in losses),
                  f"pp=2 {name} bf16 losses {losses}")
        check(r["pp"]["bert"]["blocks"] == 12 or COMPOSE_BERT.get("n_layers"),
              f"pp=2 BERT holds {r['pp']['bert']['blocks']} blocks")
    check(ranks[0]["pp"]["bert"]["losses"] == ranks[1]["pp"]["bert"][
        "losses"], "pp=2: the BERT ranks' losses differ")
    for name in ("bert", "vit"):
        e = r0["pp"]["encoders"][name]
        check(e["loss"] <= 1e-5 and e["grad_norm"] <= 1e-5
              and e["params"] <= 1e-5 and e["moved"] <= MESH_MOVED_LIMIT,
              f"pp=2 f32 {name} vs unsplit: {e}")
    par = r0["pp"]["resnet_f32"]
    check(par["loss"] <= 1e-5 and par["stats"] <= 1e-6,
          f"pp=2 f32 fused resnet vs unsplit: {par}")
    # (c) ring and Ulysses with MoE at tp = 2
    for impl in CP_IMPLS:
        e = r0["cp_moe"][impl]
        check(e["loss"] <= 1e-5 and e["grad_norm"] <= 1e-5
              and e["params"] <= 1e-5 and e["moved"] <= MESH_MOVED_LIMIT,
              f"{impl} with MoE at tp=2 vs unsplit: {e}")
    res["parts"]["cp_moe"] = summed(lambda r: r["cp_moe"]["launches"])
    res["launches"] = {}
    for counts in res["parts"].values():
        for k, n in counts.items():
            res["launches"][k] = res["launches"].get(k, 0) + n
    res["unsplit"] = {"/".join(k): v for k, v in unsplit.items()}
    return res


def phase25(device, base: str, kernels: list, kind: str, ident: str) -> None:
    """Phase 25's parts, their lines, and the ``mesh_compose`` path of
    the kernel record: > 0 on rows 1-2 from (a)'s serving, on rows 3-4
    from (b)'s BERT, on rows 5-6 from (b)'s ResNet."""
    mc = mesh_compose_phase(device, base)
    parts = mc["parts"]
    for kern in kernels:
        n = mc["launches"].get(kern["name"], 0)
        kern["launches_by_path"]["mesh_compose"] = n
        kern["launches"] += n
    tma = kernels[0].setdefault("tma_launches_by_path", {})
    tma["mesh_compose"] = mc["launches"].get("paged_decode_tma", 0)
    check(tma["mesh_compose"] > 0,
          "paged_decode_tma_kernel never launched on the mesh_compose path")
    flash_end = FLASH_RECORDS.stop
    for i, kern in enumerate(kernels):
        if i < FLASH_RECORDS.start:
            got = (parts["serve_world1"].get(kern["name"], 0),
                   parts["serve_tp2"].get(kern["name"], 0))
            where = "(a)'s serving at world 1 and tp = 2"
        else:
            got = (parts["bert_pp2" if i < flash_end else "resnet_pp2"].get(
                kern["name"], 0),)
            where = "(b)'s BERT" if i < flash_end else "(b)'s ResNet"
        check(all(n > 0 for n in got),
              f"{kern['name']} never launched on {where}: {got}")
    w1 = mc["world1"]
    r0 = mc["ranks"][0]
    print(f"phase 25 (a) MoE LM of examples/lm.py --n-experts 8 (d_model "
          f"768, {COMPOSE_MOE['n_layers']} layers (depth cut from 12), 12 "
          f"heads, d_ff 3072, vocab 32000, 8 experts, "
          f"top-2, dense dispatch; random weights, export "
          f"{mc['export_s']:.1f}s) served at world 1 over NCCL through "
          f"ModelServer(decode_mesh=tp=1) ({kind} | {ident}): phase 3's "
          f"traffic, paged + fused sampler: tokens_per_s="
          f"{w1['tokens_per_s']:.1f} wall_s={w1['wall_s']:.3f} "
          f"ttft_ms_stream={[round(t * 1e3, 1) for t in w1['ttft_s']]} "
          f"launches={w1['launches']}; unsplit engine streams "
          f"({mc['unsplit_s']:.1f}s)", flush=True)
    for mode, t in mc["tp2"].items():
        print(f"phase 25 (a) tp=2 {mode} (2 ranks on one card over gloo, "
              f"ModelServer + serve_follower, 4 requests of 200 + 24 "
              f"tokens at once, warmed): f32 greedy and sampled streams == "
              f"unsplit engine's, every rank the same tokens, f32 greedy "
              f"tokens_per_s="
              f"{t['f32_tokens_per_s']:.1f}; bf16 tokens_per_s="
              f"{t['bf16_tokens_per_s']:.1f}, its free-running greedy "
              f"streams agreeing with the unsplit bf16 engine's on "
              f"{t['agree']:.3f} of the positions; a rank's experts "
              f"{r0['serving']['paged']['experts']}", flush=True)
    f = mc["forced"]
    print(f"phase 25 (a) tp=2 bf16 logits at every position of the 4 "
          f"prompts (cut to the shortest), teacher-forced through one decode forward (dense "
          f"cache) vs the unsplit bf16 model: argmax agree "
          f"{f['agree']:.4f}, norm-relative error {f['norm_err']:.2e}; the "
          f"unsplit bf16 model vs its f32 twin: argmax agree "
          f"{f['bf16_agree']:.4f}, error {f['bf16_err']:.2e} (limits: "
          f"{COMPOSE_BF16_NOISE}x its disagreement and error)", flush=True)
    for r in mc["ranks"]:
        pp = r["pp"]
        print(f"phase 25 (b) pp=2 rank {r['rank']} (2 ranks on one card "
              f"over gloo, every layer on each): BERT-base MLM at batch "
              f"{COMPOSE_BERT_BATCH} x {COMPOSE_BERT_SEQ}, bf16, flash, "
              f"remat: step_ms={[round(x, 1) for x in pp['bert']['step_ms']]}"
              f" losses={[round(x, 4) for x in pp['bert']['losses']]}; "
              f"ResNet-50 fused at batch {COMPOSE_RESNET_BATCH}, bf16: "
              f"step_ms={[round(x, 1) for x in pp['resnet']['step_ms']]} "
              f"losses={[round(x, 4) for x in pp['resnet']['losses']]} "
              f"({r['pp_s']:.1f}s)", flush=True)
    enc, par = r0["pp"]["encoders"], r0["pp"]["resnet_f32"]
    print(f"phase 25 (b) pp=2 f32 vs unsplit, TF32 off: BERT (2 layers at "
          f"BERT-base widths) loss {enc['bert']['loss']:.2e} grad_norm rel "
          f"{enc['bert']['grad_norm']:.2e} params "
          f"{enc['bert']['params']:.2e} movement {enc['bert']['moved']:.2e};"
          f" ViT (2 layers, ViT-B widths) loss {enc['vit']['loss']:.2e} "
          f"params {enc['vit']['params']:.2e}; fused ResNet loss "
          f"{par['loss']:.2e} running statistics {par['stats']:.2e} params "
          f"{par['params']:.2e} (limits 1e-5, 1e-6 on the statistics)",
          flush=True)
    for impl in CP_IMPLS:
        e = r0["cp_moe"][impl]
        print(f"phase 25 (c) {impl} over tp=2 with 8 experts (2 layers at "
              f"examples/lm.py's widths, seq 512, f32, TF32 off) vs the "
              f"unsplit step, 3 steps: loss {e['loss']:.2e} grad_norm rel "
              f"{e['grad_norm']:.2e} params {e['params']:.2e} movement "
              f"{e['moved']:.2e}; losses {e['losses']} "
              f"({e['wall_s']:.1f}s)", flush=True)
    print(f"phase 25 launches={mc['launches']} by part {parts}; gang "
          f"{mc['gang_s']:.1f}s (serving {r0['serving_s']:.1f}s, pp "
          f"{r0['pp_s']:.1f}s, cp {r0['cp_s']:.1f}s)", flush=True)


# -- phase 26: the last modules ----------------------------------------------

# the job identity phase 26 (a) runs under: the operator's env contract
LAST_JOB = {"KFTPU_JOB_NAME": "smoke-last-modules",
            "KFTPU_NAMESPACE": "default", "KFTPU_JOB_UID": "phase-26",
            "KFTPU_PROCESS_ID": "0"}
BUILD_WALL_LIMIT = 0.10     # (a) a source's seconds against the phase's wall
TILE_TIME_LIMIT = 0.03      # (b) the table's split against phase 2's split
BUDGET_PEAK_LIMIT = 0.10    # (c) argument + temp + output against the peak
EVICT_MEM_LIMIT = 0.05      # (d) allocated after an eviction against before
MUX_THREADS = 8             # (d) threads faulting one cold model
ACT_TIMED = 3               # (e) timed steps each way, after one warm-up
# (e) the f32 gate of tests/test_act_compress.py: a thin ResNet, 6 steps
# of SGD 0.05 (momentum 0.9) on 8 images, compressed within 8% of plain
ACT_THIN = dict(stage_sizes=(1, 1), num_classes=10, width=16,
                dtype="float32", bn_dtype="float32", stem="conv")
ACT_THIN_STEPS, ACT_GATE = 6, 0.08


def compile_ledger_part(first_build: dict) -> dict:
    """Phase 26 (a): a ``make_compile_ledger()`` ledger (job identity
    from :data:`LAST_JOB`) installed before the quickest source of phase
    1 builds into a fresh directory: one ``kftpu_compile_seconds``
    observation, its seconds within :data:`BUILD_WALL_LIMIT` of the
    build call's wall, its fingerprint the library's digest, its span in
    the job's trace under the job's root; a second build finds the
    library on disk and records nothing."""
    from kubeflow_tpu_torch.examples.common import make_compile_ledger
    from kubeflow_tpu_torch.obs import xprof
    from kubeflow_tpu_torch.obs.steps import tpujob_trace_ids
    from kubeflow_tpu_torch.obs.trace import SpanCollector, Tracer
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    name = (min(first_build, key=first_build.get)[:-len(".cu")]
            if first_build else "fused_sample")
    ns, job, uid = (LAST_JOB["KFTPU_NAMESPACE"], LAST_JOB["KFTPU_JOB_NAME"],
                    LAST_JOB["KFTPU_JOB_UID"])
    hist = DEFAULT_REGISTRY.histogram("kftpu_compile_seconds")
    saved = {k: os.environ.get(k) for k in LAST_JOB}
    os.environ.update(LAST_JOB)
    fresh = tempfile.mkdtemp(prefix="kftpu-build-")
    collector = SpanCollector()
    try:
        ledger = make_compile_ledger()
        labels = dict(module=f"{name}.cu", shape_class="all",
                      generation=ledger.generation, namespace=ns, job=job)
        n_before = hist.get(**labels)
        ledger.tracer = Tracer(collector, clock=time.time)
        try:
            t0 = time.perf_counter()
            _build.build([name], build_dir=fresh)
            wall = time.perf_counter() - t0
            events = list(ledger.events)
            _build.build([name], build_dir=fresh)
            from_disk = len(ledger.events) - len(events)
        finally:
            ledger.uninstall()
        digest = _build._target(name, fresh)[2]
    finally:
        shutil.rmtree(fresh, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(len(events) == 1 and from_disk == 0,
          f"compile ledger: {len(events)} events for one build, "
          f"{from_disk} for a load from disk")
    ev = events[0]
    n_obs = hist.get(**labels) - n_before
    check(n_obs == 1 and labels["shape_class"] == ev.shape_class,
          f"kftpu_compile_seconds: {n_obs} new observations of "
          f"{ev.module}")
    check(abs(ev.seconds - wall) <= BUILD_WALL_LIMIT * wall,
          f"compile ledger: {ev.seconds:.3f}s against the build's wall "
          f"{wall:.3f}s")
    check(ev.fingerprint == digest,
          f"compile ledger fingerprint {ev.fingerprint} != digest {digest}")
    trace_id, root = tpujob_trace_ids(ns, job, uid)
    spans = [sp for sp in collector.spans()
             if sp.name == f"compile/{ev.module}"]
    check(len(spans) == 1 and spans[0].trace_id == trace_id
          and spans[0].parent_id == root,
          f"compile span {spans} not under the job's trace {trace_id}")
    return {"module": ev.module, "seconds": ev.seconds, "wall_s": wall,
            "fingerprint": ev.fingerprint, "generation": ev.generation,
            "trace_id": trace_id,
            "job_seconds": xprof.job_compile_seconds(ns, job)}


def tile_table_part(device, base: str, cfg, phase2_split: int) -> dict:
    """Phase 26 (b): every committed ``sm_90`` ``paged_attn`` row's
    Python shared-memory formula (the route's at the row's shape) against
    the library's ``kftpu_paged_decode_smem_bytes`` at the row's legality
    point; the kernel at each row's shape against its plain version (bf16
    8e-3, f32 1e-5, phase 2's limits), resolved from the table; at
    phase 2's timed shape the kernel at the table row's split and at the
    split phase 2 ran (``phase2_split``), each pinned by a table override
    as ``scripts/port_paged_sweep.py`` pins it, on one set of inputs and
    timed in turns in one loop (:func:`time_turns`), within
    ``TILE_TIME_LIMIT`` of each other; then a phase-3-shaped serving run
    (4 requests of ~300 + 16) under ``record_resolutions``: every paged
    resolution from the table, none from the fallback."""
    import collections

    import torch

    from kubeflow_tpu_torch.ops import autotune as at
    from kubeflow_tpu_torch.ops import paged_attention as pa

    lib = pa._lib()
    rows = [e for e in at.active_table().entries
            if e["kernel"] == "paged_attn" and e.get("generation") == "sm_90"]
    check(rows, "the tile table has no sm_90 paged_attn row")
    held, timed = [], None
    for e in rows:
        group, Dh, el, pps = at.paged_legality_point(e)
        py = at.paged_smem_bytes(group, Dh, el, pps)
        lib_b = lib.kftpu_paged_decode_smem_bytes(group, Dh, el, pps)
        check(py == lib_b, f"{at.entry_key(e)}: Python smem {py} != "
                           f"library {lib_b}")
        KH = e.get("n_kv_heads") or 16
        QH = e.get("n_heads") or KH * group
        ps = e.get("page_size") or 64
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            e["dtype"]]
        atol = 8e-3 if dtype == torch.bfloat16 else 1e-5
        q, k, v, pages, pos, P = paged_inputs(8, QH, KH, Dh, ps, 32, dtype,
                                              device, seed=SEED + QH + KH)
        with at.record_resolutions() as rec:
            got = pa.paged_decode_attention(q, k, v, pages, pos)
        want = pa.paged_decode_attention_plain(q, k, v, pages, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= atol, f"{at.entry_key(e)}: max abs err {err} > {atol}")
        check([(d["source"], d["split_tokens"]) for d in rec]
              == [("table", e["split_tokens"])],
              f"{at.entry_key(e)}: resolved {rec}")
        held.append({"row": at.entry_key(e), "smem_bytes": py,
                     "split_tokens": e["split_tokens"], "max_abs_err": err})
        if (dtype, QH, KH, Dh, ps) == (torch.bfloat16, 16, 16, 64, 64):
            def at_split(split, q=q, k=k, v=v, pages=pages, pos=pos):
                row = {"kernel": "paged_attn", "generation": "*",
                       "dtype": "*", "split_tokens": split}

                def fn():
                    with at.table_override(at.TileTable([row], [])):
                        pa.paged_decode_attention(q, k, v, pages, pos)
                return fn

            timed = time_turns([at_split(e["split_tokens"]),
                                at_split(phase2_split)])
    check(timed is not None, "no committed row at phase 2's timed shape")
    check(abs(timed[0] - timed[1]) <= TILE_TIME_LIMIT * timed[1],
          f"the table's split takes {timed[0]:.4f} ms, phase 2's "
          f"({phase2_split} keys) {timed[1]:.4f} ms, timed in turns")
    with at.record_resolutions() as rec:
        serve = serve_phase(base, cfg, device, n_requests=4, max_new=16)
    by_source = collections.Counter(f"{d['kernel']}/{d['source']}"
                                    for d in rec)
    paged = by_source["paged_attn/table"]
    check(paged >= serve["launches"]["paged_decode_attention"] > 0,
          f"serving: {paged} table resolutions for "
          f"{serve['launches']['paged_decode_attention']} launches")
    check(not any(k.endswith("/fallback") for k in by_source),
          f"serving resolutions by source: {dict(by_source)}")
    return {"rows": held, "ms": timed[0], "phase2_ms": timed[1],
            "phase2_split": phase2_split,
            "serving": serve, "by_source": dict(by_source),
            "launches": serve["launches"]}


def memory_budget_part(device) -> dict:
    """Phase 26 (c), in a process of its own (:func:`budget_rank_main`:
    nothing of the earlier phases is allocated at the call's entry):
    ``record_memory_budget`` of the first call of the BERT-base MLM step
    at phase 11's shape (16 x 512, bf16 over f32, flash, remat): argument
    + temp + output within :data:`BUDGET_PEAK_LIMIT` of an
    ``HbmSampler``'s peak over the call."""
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.obs.xprof import HbmSampler, record_memory_budget
    from kubeflow_tpu_torch.train import make_mlm_train_step

    cfg, state, batch = bert_setup(device)
    step = make_mlm_train_step()
    torch.cuda.synchronize()
    entry = torch.cuda.memory_allocated(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    budget = record_memory_budget(step, state, *batch,
                                  module="mlm_train_step")
    call_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    sample = HbmSampler(device_index=device.index or 0).sample()
    check(sample is not None, "HbmSampler read nothing on the card")
    check(set(budget) == {"argument", "temp", "output"},
          f"memory budget kinds {sorted(budget)}")
    total = sum(budget.values())
    peak = sample["peak"]
    check(abs(total - peak) <= BUDGET_PEAK_LIMIT * peak,
          f"budget {budget} sums to {total}, the sampler's peak {peak}")
    del state, batch, step
    return {"budget": budget, "total": total, "peak": peak,
            "entry": entry, "call_s": call_s, "launches": launches}


def budget_rank_main(argv) -> int:
    """``chip_smoke.py --budget-rank OUT``: :func:`memory_budget_part` on
    cuda:0, its result written to ``OUT`` as JSON."""
    import torch

    (out,) = argv
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(out, "w") as f:
        json.dump(memory_budget_part(device), f)
    return 0


def memory_budget_process() -> dict:
    """Run :func:`budget_rank_main` in a child process; its result."""
    tmp = tempfile.mkdtemp(prefix="kftpu-budget-")
    out = os.path.join(tmp, "budget.json")
    try:
        proc = subprocess.run([sys.executable, SCRIPT, "--budget-rank", out],
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"the memory-budget process failed ({proc.returncode}): "
              f"{proc.stderr[-3000:]}")
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def multiplex_part(device, base: str) -> dict:
    """Phase 26 (d): a ``ModelMultiplexer(max_resident=1)`` on the card
    over phase 17's ResNet-50 (fused) and BERT-base exports: A, B (A
    paged out), A again (a cold re-fault from disk), each ``predict`` bit
    for bit a directly loaded ``LoadedModel.predict``'s; the allocator's
    bytes at each fault after an eviction within :data:`EVICT_MEM_LIMIT`
    of the bytes before the first model loaded; then
    :data:`MUX_THREADS` threads faulting the cold model add one load."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving import model_store as store
    from kubeflow_tpu_torch.serving.multiplex import ModelMultiplexer

    src = os.path.join(base, "predict-store")
    root = tempfile.mkdtemp(prefix="kftpu-mux-")
    names = ("resnet50", "bert")
    try:
        for name in names:
            os.symlink(os.path.join(src, name), os.path.join(root, name))
        rng = np.random.default_rng(SEED + 260)
        want, inputs = {}, {}
        for name in names:
            direct = store.load_latest(os.path.join(root, name),
                                       device=device)
            inputs[name] = (rng.standard_normal(
                (8, *direct.input_shape)).astype(np.float32)
                if direct.input_shape else
                rng.integers(0, 30522, (1, 128)).astype(np.int32))
            want[name] = direct.predict(inputs[name])
            del direct
        # the direct models (and earlier phases' cycles) are collected
        # before the first sample: the collector's timing would otherwise
        # decide whether they sit in it; what the multiplexer still
        # references stays counted
        gc.collect()
        torch.cuda.synchronize()
        mux = ModelMultiplexer(root, max_resident=1, device=device)
        store_loader = mux.loader
        at_fault = []

        def loader(name):
            torch.cuda.synchronize()
            at_fault.append((name, torch.cuda.memory_allocated(device)))
            return store_loader(name)

        mux.loader = loader
        cold, same = [], []
        ops.reset_launches()
        for name in ("resnet50", "bert", "resnet50"):
            with mux.lease(name) as handle:
                out = handle.predict(inputs[name])
                cold.append((name, mux.snapshot()["models"][name][
                    "cold_start_ms"]))
            del handle
            same.append(bool(np.array_equal(out, want[name])))
        launches = ops.launch_counts()
        loads = mux.snapshot()["multiplex_loads"]
        got = []
        threads = [threading.Thread(target=lambda: got.append(
            mux.get("bert") is not None)) for _ in range(MUX_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120.0)
        check(not any(th.is_alive() for th in threads),
              "a multiplexer fault hung")
        snap = mux.snapshot()
        herd_loads = snap["multiplex_loads"] - loads
        del mux, got
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(all(same), f"multiplexed predictions equal the direct ones: "
                     f"{dict(zip(('A', 'B', 'A again'), same))}")
    base_b = at_fault[0][1]
    after = [b for _, b in at_fault[1:]]
    check(all(abs(b - base_b) <= EVICT_MEM_LIMIT * base_b for b in after),
          f"allocated bytes at each fault {at_fault}: an evicted model "
          f"kept device memory")
    check(herd_loads == 1, f"{MUX_THREADS} threads faulting one cold model "
                           f"added {herd_loads} loads")
    return {"cold_start_ms": cold, "at_fault": at_fault,
            "evictions": snap["multiplex_evictions"],
            "loads": snap["multiplex_loads"], "launches": launches}


def act_compress_part(device) -> dict:
    """Phase 26 (e): ResNet-50 unfused at phase 7's batch 256 (bf16 over
    f32, same weights) for one warm-up and :data:`ACT_TIMED` timed steps
    with ``act_compress`` off and on: images/s and the peak GB of the
    timed steps (peak statistics reset between); then the f32 gate on a
    thin ResNet (:data:`ACT_THIN`): both runs' losses fall and stay
    within :data:`ACT_GATE` of each other."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.resnet import ResNetConfig
    from kubeflow_tpu_torch.train import (
        create_image_train_state,
        make_image_train_step,
        make_sgd,
    )

    runs, launches = {}, None
    for act in (False, True):
        torch.cuda.empty_cache()
        cfg, state, images, labels = resnet_setup(device, fused=False,
                                                  act_compress=act)
        step = make_image_train_step()
        state, m = step(state, images, labels)
        float(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launches()
        losses, times = [], []
        for _ in range(ACT_TIMED):
            t0 = time.perf_counter()
            state, m = step(state, images, labels)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        step_s = sum(times) / len(times)
        runs["on" if act else "off"] = {
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "images_per_s": RESNET_BATCH / step_s,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        check(all(np.isfinite(losses)), f"act_compress={act}: {losses}")
        del state, images, labels, step
    gate = {}
    rng = np.random.default_rng(SEED + 262)
    images = torch.from_numpy(rng.standard_normal(
        (8, 32, 32, 3)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 10, 8)).to(device)
    for act in (False, True):
        cfg = ResNetConfig(**ACT_THIN, act_compress=act)
        state = create_image_train_state(
            cfg, convert.random_resnet_params(ResNetConfig(**ACT_THIN),
                                              SEED + 263),
            make_sgd(0.05, momentum=0.9), device=device)
        step = make_image_train_step()
        losses = []
        for _ in range(ACT_THIN_STEPS):
            state, m = step(state, images, labels)
            losses.append(float(m["loss"]))
        gate["on" if act else "off"] = losses
    exact, comp = gate["off"], gate["on"]
    check(exact[-1] < exact[0] and comp[-1] < comp[0],
          f"thin ResNet losses did not fall: {exact} / {comp}")
    check(all(abs(e - c) < ACT_GATE * max(abs(e), 1.0)
              for e, c in zip(exact, comp)),
          f"act_compress losses {comp} off the plain {exact}")
    return {"runs": runs, "gate": gate, "launches": launches}


def last_modules_phase(device, base: str, cfg, kernels: list,
                       first_build: dict) -> dict:
    """Phase 26: (a)-(e) above. The ``last_modules`` path's launches sum
    (b)'s serving run, (c)'s step (in its own process), (d)'s
    multiplexed calls and (e)'s steps, each zeroed just before it; the
    row checks of (b) and the direct loads of (d) are comparisons and
    are not counted."""
    import torch

    res = {"compile": compile_ledger_part(first_build)}
    torch.cuda.empty_cache()
    res["tiles"] = tile_table_part(device, base, cfg,
                                   kernels[0]["phase2_split_tokens"])
    torch.cuda.empty_cache()
    res["budget"] = memory_budget_process()
    torch.cuda.empty_cache()
    res["mux"] = multiplex_part(device, base)
    torch.cuda.empty_cache()
    res["act"] = act_compress_part(device)
    res["launches"] = {}
    for part in ("tiles", "budget", "mux", "act"):
        for k, n in res[part]["launches"].items():
            res["launches"][k] = res["launches"].get(k, 0) + n
    return res


def phase26(device, base: str, cfg, kernels: list, kind: str, ident: str,
            first_build: dict) -> None:
    """Phase 26's parts, their lines, and the ``last_modules`` path of
    the kernel record: > 0 on rows 1 ((b)'s serving), 3 ((c) and (d)'s
    BERT) and 5 ((d)'s ResNet-50)."""
    lm = last_modules_phase(device, base, cfg, kernels, first_build)
    for i, kern in enumerate(kernels):
        n = lm["launches"].get(kern["name"], 0)
        kern["launches_by_path"]["last_modules"] = n
        kern["launches"] += n
        if kern["name"] in ("paged_decode_attention", "flash_fwd",
                            "bnconv_fwd"):
            check(n > 0, f"{kern['name']} never launched on the "
                         f"last_modules path")
    kernels[0].setdefault("tma_launches_by_path", {})["last_modules"] = (
        lm["launches"].get("paged_decode_tma", 0))
    kernels[0]["max_abs_err"] = max(
        [kernels[0]["max_abs_err"]]
        + [r["max_abs_err"] for r in lm["tiles"]["rows"]])
    c = lm["compile"]
    print(f"phase 26 (a) compile ledger ({kind} | {ident}): "
          f"make_compile_ledger() under job {LAST_JOB['KFTPU_NAMESPACE']}/"
          f"{LAST_JOB['KFTPU_JOB_NAME']}, {c['module']} built into a fresh "
          f"directory: one kftpu_compile_seconds observation of "
          f"{c['seconds']:.3f}s (the build call's wall {c['wall_s']:.3f}s), "
          f"generation {c['generation']}, fingerprint {c['fingerprint']} "
          f"== the library's digest, its span in trace {c['trace_id']}; "
          f"job total {c['job_seconds']:.3f}s; a load from disk recorded "
          f"nothing; phase 1's nvcc seconds by source {first_build}",
          flush=True)
    t = lm["tiles"]
    s = t["serving"]
    print(f"phase 26 (b) tile table ({kind} | {ident}): sm_90 paged rows "
          f"{[(r['row'], r['split_tokens'], r['smem_bytes']) for r in t['rows']]}"
          f" (Python smem == kftpu_paged_decode_smem_bytes), max abs err "
          f"{[round(r['max_abs_err'], 6) for r in t['rows']]}; row 1 at "
          f"phase 2's shape {t['ms']:.4f} ms against {t['phase2_ms']:.4f} "
          f"ms at phase 2's split ({t['phase2_split']} keys), in turns "
          f"(limit {TILE_TIME_LIMIT:.0%}); a phase-3-shaped serving run "
          f"(4 requests of ~300 + 16, paged + fused sampler, "
          f"tokens_per_s={s['tokens_per_s']:.1f}) resolved by source "
          f"{t['by_source']}; launches={s['launches']}", flush=True)
    b = lm["budget"]
    print(f"phase 26 (c) memory budget ({kind} | {ident}): "
          f"record_memory_budget of the BERT-base MLM step's first call, "
          f"{BERT_BATCH} x {BERT_SEQ}, bf16/f32, flash, remat "
          f"({b['call_s']:.2f}s): argument {b['budget']['argument'] / 1e9:.3f}"
          f" GB, temp {b['budget']['temp'] / 1e9:.3f} GB, output "
          f"{b['budget']['output'] / 1e9:.6f} GB, sum {b['total'] / 1e9:.3f}"
          f" GB against the HbmSampler's peak {b['peak'] / 1e9:.3f} GB "
          f"(allocated at entry {b['entry'] / 1e9:.3f} GB; limit "
          f"{BUDGET_PEAK_LIMIT:.0%}); launches={b['launches']}", flush=True)
    m = lm["mux"]
    print(f"phase 26 (d) ModelMultiplexer(max_resident=1) on the card "
          f"({kind} | {ident}): phase 17's resnet50 (fused, 8 images) and "
          f"bert (1 x 128); A, B, A again, each predict == the directly "
          f"loaded model's bit for bit; cold_start_ms "
          f"{[(n, round(ms, 1)) for n, ms in m['cold_start_ms']]}; "
          f"allocated GB at each fault "
          f"{[(n, round(x / 1e9, 4)) for n, x in m['at_fault']]} (limit "
          f"{EVICT_MEM_LIMIT:.0%} of the first); {MUX_THREADS} threads "
          f"faulting bert added 1 load; loads={m['loads']} "
          f"evictions={m['evictions']}; launches={m['launches']}",
          flush=True)
    for label, r in lm["act"]["runs"].items():
        print(f"phase 26 (e) resnet50 unfused act_compress {label} "
              f"({kind} | {ident}): batch {RESNET_BATCH}, bf16/f32, "
              f"space_to_depth stem, sgd 0.1 m 0.9, 1 warm-up + "
              f"{ACT_TIMED} timed: step_ms={[round(x, 1) for x in r['step_ms']]}"
              f" images_per_s={r['images_per_s']:.1f} peak_gb="
              f"{r['peak_gb']:.2f} losses={r['losses']}", flush=True)
    g = lm["act"]["gate"]
    print(f"phase 26 (e) f32 thin ResNet (TF32 off), {ACT_THIN_STEPS} "
          f"steps: losses off {[round(x, 5) for x in g['off']]} on "
          f"{[round(x, 5) for x in g['on']]} (gate {ACT_GATE} of "
          f"max(|off|, 1)); on/off images/s "
          f"{lm['act']['runs']['on']['images_per_s'] / lm['act']['runs']['off']['images_per_s']:.4f}"
          f", peak GB {lm['act']['runs']['on']['peak_gb']:.2f} / "
          f"{lm['act']['runs']['off']['peak_gb']:.2f}", flush=True)
    print(f"phase 26 launches={lm['launches']}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.examples.common import make_compile_ledger
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    ident = gpu_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | {ident}", flush=True)

    t0 = time.perf_counter()
    ledger = make_compile_ledger()
    try:
        logs = _build.build(["paged_attention", "fused_sample",
                             "flash_attention", "bnconv"])
    finally:
        ledger.uninstall()
    first_build = {e.module: round(e.seconds, 3) for e in ledger.events}
    print(f"phase 1 build: {time.perf_counter() - t0:.1f}s; nvcc seconds "
          f"by source (compile ledger, in parallel): {first_build}, "
          f"charged once {ledger.total_seconds():.3f}s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  [{name}] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    kernels = [check_paged_kernel(device,
                                  build_log=logs["paged_attention"]),
               check_sampler_kernel(device, build_log=logs["fused_sample"]),
               *check_flash_kernels(device,
                                    build_log=logs["flash_attention"]),
               *check_bnconv_kernels(device, build_log=logs["bnconv"])]
    bert_shape = check_flash_bert_shape(device)
    for kern in kernels[FLASH_RECORDS]:
        kern["bert_shape"] = bert_shape[kern["name"]]
        kern["max_abs_err"] = max(kern["max_abs_err"],
                                  bert_shape[kern["name"]]["max_abs_err"])
    print(f"phase 2 kernels vs plain: ok ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    torch.cuda.empty_cache()

    cfg = TransformerConfig(**BENCH, dtype="bfloat16")
    # the phase-3 export, read again by phase 10
    base = tempfile.mkdtemp(prefix="kftpu-smoke-")
    try:
        return run_phases(device, kind, ident, cfg, base, kernels, t_start,
                          first_build)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def run_phases(device, kind, ident, cfg, base, kernels, t_start,
               first_build) -> int:
    import torch

    laps = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Print the seconds since the last lap: one phase's time."""
        laps.append(time.perf_counter())
        print(f"phase {phase} seconds: {laps[-1] - laps[-2]:.1f}",
              flush=True)

    t0 = time.perf_counter()
    write_export(base, cfg)
    print(f"export written: {time.perf_counter() - t0:.1f}s", flush=True)
    serve = serve_phase(base, cfg, device)
    for kern in kernels[SERVING_RECORDS]:
        kern["launches"] = serve["launches"][kern["name"]]
        kern["launches_by_path"] = {"paged_serving": kern["launches"]}
        check(kern["launches"] > 0,
              f"{kern['name']} never launched on the serving path")
    # row 1's launches on its TMA route (bf16, Dh 64, groups <= 8), by path
    tma = kernels[0]["tma_launches_by_path"] = {
        "paged_serving": serve["launches"]["paged_decode_tma"]}
    check(tma["paged_serving"] > 0,
          "paged_decode_tma_kernel never launched on the serving path")
    ttft = serve["ttft_s"]
    print(f"phase 3 serving ({kind} | {ident}): 8 concurrent "
          f":generate x 64 tokens, prompts ~300: "
          f"tokens_per_s={serve['tokens_per_s']:.1f} "
          f"wall_s={serve['wall_s']:.3f} "
          f"ttft_ms_stream={[round(t * 1e3, 1) for t in ttft]} "
          f"launches={serve['launches']}", flush=True)
    print(f"phase 3 request ledger: 8 records tile, each with prefill and "
          f"decode and 64 tokens, each engine.* span under its "
          f"serving.generate; p50 seconds by phase "
          f"{serve['ledger_p50_s']} ttft_ms {serve['ledger_ttft_ms']}",
          flush=True)
    lap("3")
    streams = streams4 = parity_phase(base, cfg, device)
    print(f"phase 4 f32 kernel == gather greedy streams "
          f"({len(streams)} x {len(streams[0])} tokens)", flush=True)
    lap("4")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    train = train_phase(device)
    for kern in kernels[FLASH_RECORDS]:
        kern["launches"] = train["launches"][kern["name"]]
        kern["launches_by_path"] = {"lm_train": kern["launches"]}
    print(f"phase 5 train ({kind} | {ident}): vocab 32000, d_model 1024, "
          f"8 layers, 16 heads, seq 8192, batch 2, bf16/f32, flash+remat: "
          f"losses={train['losses']} step_ms={train['step_ms']} "
          f"mean_step_ms={train['mean_step_ms']:.1f} "
          f"tokens_per_s={train['tokens_per_s']:.1f} "
          f"mfu={train['mfu']:.4f} peak_gb={train['peak_gb']:.2f} "
          f"grad_norm={train['grad_norm']:.4f} "
          f"launches={train['launches']}", flush=True)
    tel = train["telemetry"]
    print(f"phase 5 step telemetry ({kind} | {ident}): "
          f"tokens_per_s={tel['tokens_per_s']:.1f} (rolling, the "
          f"FLOP-probe step included; "
          f"{TRAIN_BATCH * TRAIN['max_seq_len'] / tel['p50_step_s']:.1f} "
          f"at the p50 step) "
          f"p50_step_s={tel['p50_step_s']} p99_step_s={tel['p99_step_s']} "
          f"median of steps 2-4 {tel['median_step_s']:.6f} s (the "
          f"phase's own {tel['own_median_step_s']:.6f}; steps "
          f"{tel['step_s']} against {tel['own_step_s']}) "
          f"mfu={tel.get('mfu')} from {tel['flops_per_step']:.4e} "
          f"FLOP/step counted by FlopCounterMode (flash attention excluded:"
          f" its autograd function registers no flop formula) "
          f"recompiles={tel['recompiles']} "
          f"hbm_peak_gb={tel['hbm_peak_gb']:.2f}", flush=True)
    for k, r in enumerate(tel["split"], 1):
        print(f"phase 5 step {k}: own wall {r['own_ms']:.1f} ms = "
              f"telemetry window {r['window_ms']:.1f} (the call and its "
              f"sync) + after it {r['probe_read_ms']:.1f} (FLOP counter "
              f"read) + {r['bookkeeping_ms']:.1f} (_on_step: histogram, "
              f"HBM sample, span, beacon) + {r['rest_ms']:.1f} (outside "
              f"both: before the window, where step 1 builds the FLOP "
              f"counter, and the loop's loss read)", flush=True)
    lap("5")
    torch.cuda.empty_cache()
    par = train_parity_phase(device)
    print(f"phase 6 f32 flash vs dense train step: loss {par['loss']} "
          f"grad_norm {par['grad_norm']} max grad err "
          f"{par['grad_err']:.2e} max param err {par['param_err']:.2e}",
          flush=True)
    lap("6")
    torch.cuda.empty_cache()
    res = resnet_phase(device)
    for kern in kernels[BNCONV_RECORDS]:
        kern["launches"] = res["launches"][kern["name"]]
        kern["launches_by_path"] = {"resnet_train": kern["launches"]}
    print(f"phase 7 resnet50 train ({kind} | {ident}): batch 256, bf16/f32, "
          f"space_to_depth stem, fused_bn_conv=True, sgd 0.1 m 0.9: "
          f"losses={res['losses']} accuracy={res['accuracy']} "
          f"step_ms={res['step_ms']} mean_step_ms={res['mean_step_ms']:.1f} "
          f"images_per_s={res['images_per_s']:.1f} mfu={res['mfu']:.4f} "
          f"peak_gb={res['peak_gb']:.2f} launches={res['launches']}; "
          f"updates rounded away in f32 (largest lr*|trace|): "
          f"{res['rounded_away']}", flush=True)
    torch.cuda.empty_cache()
    unf = resnet_phase(device, fused=False)
    print(f"phase 7 resnet50 unfused, same weights ({kind} | {ident}): "
          f"losses={unf['losses']} step_ms={unf['step_ms']} "
          f"mean_step_ms={unf['mean_step_ms']:.1f} images_per_s="
          f"{unf['images_per_s']:.1f} mfu={unf['mfu']:.4f} peak_gb="
          f"{unf['peak_gb']:.2f}; fused/unfused images/s "
          f"{res['images_per_s'] / unf['images_per_s']:.4f}", flush=True)
    lap("7")
    torch.cuda.empty_cache()
    rpar = resnet_parity_phase(device)
    print(f"phase 8 f32 fused vs unfused resnet train step: loss "
          f"{rpar['loss']} max grad err {rpar['grad_err']:.2e} (of each "
          f"gradient's norm; limit {RESNET_PARITY_GRAD:.0e}) max "
          f"param err {rpar['param_err']:.2e} (limit "
          f"{RESNET_PARITY_PARAM:.0e})", flush=True)
    lap("8")
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    dense = dense_phase(device)
    # "launches" sums the serving paths; each path's own count beside it
    for kern in kernels[SERVING_RECORDS]:
        n = dense["fused"]["launches"][kern["name"]]
        kern["launches_by_path"]["dense_serving"] = n
        kern["launches"] += n
    for run, r in dense.items():
        print(f"phase 9 dense engine, {run} ({kind} | {ident}): vocab "
              f"32000, d_model 1024, 8 layers, max_seq_len 256, bf16/f32; "
              f"48 requests x 128 prompt + 128 new, 32 slots, "
              f"steps_per_sync 64, bursts of 8, sampler {r['sampler']}: "
              f"tokens_per_s={r['tokens_per_s']:.1f} "
              f"wall_s={r['wall_s']:.3f} first_wave_ttft_ms="
              f"{r['ttft_ms']:.1f} (median {r['ttft_ms_median']:.1f}) "
              f"steps={r['steps']} batch_prefills={r['batch_prefills']} "
              f"peak_gb={r['peak_gb']:.3f} launches={r['launches']}"
              + (f"; a second burst's sampler calls token-identical to "
                 f"plain, by shape: {r['held']}" if "held" in r else ""),
              flush=True)
        print(f"phase 9 request ledger, {run}: 48 records tile, each with "
              f"prefill, decode and 128 tokens; first-wave TTFT off the "
              f"ledger {r['ledger_ttft_ms']:.2f} ms (queues "
              f"{r['ttft_ms']:.2f} ms); p50 seconds by phase "
              f"{r['ledger_p50_s']}", flush=True)
    lap("9")
    streams = dense_parity_phase(base, cfg, device)
    print(f"phase 10 f32 greedy streams: dense (burst) == paged kernel == "
          f"unary generate == default ModelServer :generate "
          f"({len(streams)} x {len(streams[0])} tokens)", flush=True)
    lap("10")
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    bert = bert_phase(device)
    for kern in kernels[FLASH_RECORDS]:
        n = bert["launches"][kern["name"]]
        kern["launches_by_path"]["bert_train"] = n
        kern["launches"] += n
    print(f"phase 11 bert-base MLM train ({kind} | {ident}): vocab 30522, "
          f"d_model 768, 12 layers, 12 heads, d_ff 3072, batch "
          f"{BERT_BATCH}, seq {BERT_SEQ}, bf16/f32, remat, "
          f"attention_impl=auto (flash): losses={bert['losses']} "
          f"step_ms={bert['step_ms']} "
          f"mean_step_ms={bert['mean_step_ms']:.1f} "
          f"tokens_per_s={bert['tokens_per_s']:.1f} "
          f"mfu={bert['mfu']:.4f} peak_gb={bert['peak_gb']:.2f} (of "
          f"which {bert['base_gb']:.2f} allocated before the steps) "
          f"grad_norm={bert['grad_norm']:.4f} "
          f"launches={bert['launches']}", flush=True)
    lap("11")
    torch.cuda.empty_cache()
    bpar = bert_parity_phase(device)
    print(f"phase 12 f32 bert MLM step, flash vs dense, seq_lengths "
          f"[512, 377, 64, 1]: loss {bpar['loss']} grad_norm "
          f"{bpar['grad_norm']} max grad err {bpar['grad_err']:.2e} max "
          f"param err {bpar['param_err']:.2e}", flush=True)
    lap("12")
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = bert_entry_phase(device)
    for kern in kernels[FLASH_RECORDS]:
        n = entry["launches"][kern["name"]]
        kern["launches_by_path"]["bert_entry"] = n
        kern["launches"] += n
    print(f"phase 13 examples.bert.main ({kind} | {ident}): BERT-base, "
          f"batch 8, seq 128; 4 steps (checkpoints 2, 4; profiler steps "
          f"1-2; {entry['first_run_s']:.1f}s), restart to 6, unbroken 6: "
          f"losses first={entry['first_losses']} "
          f"restart={entry['restart_losses']} "
          f"unbroken={entry['unbroken_losses']} rel_err="
          f"{entry['rel_err']}; restored {entry['restored']} tensors bit "
          f"for bit; resumed vs unbroken step-6 params max diff "
          f"{entry['param_diff']:.2e}; trace {entry['trace_mb']:.1f} MB "
          f"names {entry['trace_kernels']}; launches={entry['launches']}",
          flush=True)
    lap("13")
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    store = os.path.join(base, "lm-store")
    lm = lm_entry_phase(device, store)
    print(f"phase 14 examples.lm.main ({kind} | {ident}): d_model 768, 12 "
          f"layers, 12 heads, d_ff 3072, vocab 32000, seq 512, batch 8, "
          f"dense attention, bf16/f32, remat; 6 steps (checkpoints 3, 6; "
          f"sample, export, 2-layer draft distilled 20 steps; "
          f"{lm['full_run_s']:.1f}s), done-restart, 3 + restart to 6: "
          f"losses={lm['losses']} resumed={lm['resumed']} "
          f"rel_err={lm['rel_err']} tokens_per_s={lm['tokens_per_s']:.1f} "
          f"(the log line's, from the first step on: the FLOP probe and "
          f"a checkpoint included; {8 * 512 / lm['p50_step_s']:.1f} at "
          f"the p50 step) "
          f"mfu={lm['mfu']} p50_step_s={lm['p50_step_s']} "
          f"p99_step_s={lm['p99_step_s']} recompiles={lm['recompiles']} "
          f"probe_step_s={lm['probe_step_s']} (the restart's first step, "
          f"under the FLOP counter) "
          f"peak_gb={lm['peak_gb']:.2f} draft_distill_loss="
          f"{lm['draft_loss']} sample={lm['sample']} "
          f"launches={lm['launches']}", flush=True)
    lap("14")
    torch.cuda.empty_cache()
    moe = lm_moe_phase(device)
    print(f"phase 15 examples.lm.main --n-experts 8 ({kind} | {ident}): "
          f"k=2, dense dispatch, the phase-14 widths, 4 steps: "
          f"losses={moe['losses']} aux={moe['aux']:.6f} (router and every "
          f"expert of every layer with a gradient) "
          f"p50_step_s={moe['p50_step_s']} "
          f"tokens_per_s={moe['tokens_per_s']:.1f} "
          f"peak_gb={moe['peak_gb']:.2f} launches={moe['launches']}",
          flush=True)
    lap("15")
    torch.cuda.empty_cache()
    spec = spec_serving_phase(device, store)
    for label in ("f32", "bf16"):
        r = spec[label]
        print(f"phase 16 speculative :generate, {label} ({kind} | "
              f"{ident}): 4 prompts x 32 tokens, 64 new, greedy, "
              f"draft_len 4, draft lm-draft@1 (2 layers): "
              f"plain_tokens_per_s={r['plain_tokens_per_s']:.1f} "
              f"spec_tokens_per_s={r['spec_tokens_per_s']:.1f} "
              f"rounds={r['rounds']} accepted={r['accepted']}/"
              f"{r['draft_tokens']} acceptance_rate="
              f"{r['acceptance_rate']} (the reference's accepted over one "
              f"row's proposals; per proposal "
              f"{r['accepted_per_proposal']:.4f}) "
              f"same_tokens={r['same_tokens']}",
              flush=True)
    print(f"phase 16 f32, the target as its own draft: "
          f"{spec['perfect_draft']} (every proposal accepted, tokens "
          f"equal the plain request's)", flush=True)
    lap("16")
    torch.cuda.empty_cache()
    inference = check_predict_kernels(device)
    for kern in kernels:
        if kern["name"] == "flash_fwd":
            kern["predict_shapes"] = {k: v for k, v in inference.items()
                                      if k.startswith("flash_fwd")}
        elif kern["name"] == "bnconv_fwd":
            kern["predict_shapes"] = {k: v for k, v in inference.items()
                                      if k.startswith("bnconv_fwd")}
    pred = predict_phase(device, base)
    print(f"phase 17 :predict ({kind} | {ident}): one ModelServer, "
          f"warmup=True (buckets {PREDICT_BUCKETS} warmed for mnist, "
          f"resnet50, resnet50u), exports {pred['export_s']:.1f}s, load "
          f"and warm-up {pred['load_s']:.1f}s; mnist 1/3/8 held to the "
          f"CPU; a wrong-shaped resnet request 400; an id past BERT's "
          f"vocabulary the NaN sequence, the card serving on; bert (8, "
          f"512) in process {pred['bert_8x512_predict_s']:.3f}s; lm "
          f"argmax == :generate's first tokens {pred['lm_first_tokens']} "
          f"(top-2 gaps {pred['lm_top2_gaps']}); resnet fused vs unfused "
          f"bf16 logits: max err {pred['resnet_bf16_rel']:.3e} of "
          f"max-abs, top-1 same for {pred['resnet_bf16_top1_same']}/8; "
          f"launches={pred['launches']}", flush=True)
    for label, r in pred["kinds"].items():
        print(f"phase 17 {label} ({kind} | {ident}): request "
              f"{r['request_mb']:.2f} MB, wall p50 {r['wall_ms']:.2f} ms; "
              f"in process p50: json decode {r['decode_ms']:.2f} ms, host "
              f"to device {r['h2d_ms']:.3f} ms, forward "
              f"{r['forward_ms']:.3f} ms (CUDA events; wall "
              f"{r['forward_wall_ms']:.3f}), device to host "
              f"{r['d2h_ms']:.3f} ms, json encode {r['encode_ms']:.2f} ms; "
              f"peak {r['peak_gb']:.3f} GB ({r['transient_gb']:.3f} GB "
              f"above the loaded models)", flush=True)
    lap("17")
    torch.cuda.empty_cache()
    ppar = predict_parity_phase(device)
    print(f"phase 18 f32 :predict parity (TF32 off): resnet50 fused vs "
          f"unfused, 8 images: top-1 same, max err "
          f"{ppar['resnet']['max_err']:.3e} (limit 1e-4 x max-abs "
          f"{ppar['resnet']['max_abs']:.4f}); bert-base flash vs dense, "
          f"(2, 128): max err {ppar['bert']['max_err']:.3e} (limit 1e-5; "
          f"max-abs {ppar['bert']['max_abs']:.4f})", flush=True)
    lap("18")
    torch.cuda.empty_cache()
    images = image_entry_phase(device)
    for label, key, what in (
            ("examples.resnet.main, ResNet-50 224², batch 128, synthetic",
             "resnet", "images"),
            ("examples.resnet.main from shards (native loader, device "
             "feed, bf16 pixels on the host)", "resnet_shards", "images"),
            ("examples.vit.main, ViT-B/16 224², batch 64", "vit", "images"),
            ("examples.mnist.main, 100 steps of 128", "mnist", "accuracy")):
        r = images[key]
        extra = (f" accuracy={r['result']:.4f} (floor "
                 f"{MNIST_ACCURACY_FLOOR})" if what == "accuracy" else "")
        if key == "resnet_shards":
            extra = (f" shards {r['shard_mb']:.1f} MB of {SHARD_RECORDS} "
                     f"records written in {r['shard_write_s']:.2f}s")
        print(f"phase 19 {label} ({kind} | {ident}): "
              f"images_per_s={r['images_per_s']:.1f} "
              f"step_ms={r['step_ms']:.2f} peak_gb={r['peak_gb']:.2f} "
              f"({r['run_peak_gb']:.3f} above what was allocated before "
              f"the run) "
              f"losses={[round(x, 4) for x in r['losses']]} "
              f"run_s={r['wall_s']:.1f}{extra}", flush=True)
    print(f"phase 19 launches={images['launches']} (none: ResNet unfused "
          f"and ViT's dense attention are the reference's defaults)",
          flush=True)
    lap("19")
    torch.cuda.empty_cache()
    core = grpc_core_phase(device, os.path.join(base, "predict-store"))
    json_split = {"resnet50 fused 8 f32": "resnet50 fused 8",
                  "bert 1x128": "bert 1x128"}
    for label, r in core["cases"].items():
        j = pred["kinds"].get(json_split.get(label, ""), None)
        beside = (f"; phase 17's JSON: decode {j['decode_ms']:.2f} ms, "
                  f"encode {j['encode_ms']:.2f} ms, wall {j['wall_ms']:.2f}"
                  f" ms" if j else "")
        print(f"phase 20 gRPC core {label} ({kind} | {ident}): request "
              f"{r['request_mb']:.2f} MB, response {r['response_mb']:.2f} "
              f"MB; p50 binary decode {r['decode_ms']:.3f} ms, cast and "
              f"pad {r['prep_ms']:.3f} ms, LoadedModel.predict "
              f"{r['predict_ms']:.3f} ms (forward {r['forward_ms']:.3f} "
              f"ms by CUDA events), binary encode {r['encode_ms']:.3f} ms, "
              f"core wall {r['wall_ms']:.3f} ms{beside}; outputs equal "
              f"REST :predict's", flush=True)
    print(f"phase 20 bert int32 tokens through Predict: "
          f"{core['bert_refused']} (the reference casts integer inputs to "
          f"f32); bf16 round trip of {core['bf16_round_trip']} bit for "
          f"bit; launches={core['launches']}", flush=True)
    print(f"phase 20 RPC transport: {core['transport']}", flush=True)
    lap("20")
    torch.cuda.empty_cache()
    mesh = mesh_phase(device)
    for kern in kernels:
        n = mesh["launches"].get(kern["name"], 0)
        kern["launches_by_path"]["mesh_train"] = n
        kern["launches"] += n
    for kern in kernels[FLASH_RECORDS]:
        check(kern["launches_by_path"]["mesh_train"] > 0,
              f"{kern['name']} never launched on the mesh path")
    for kern in kernels[SERVING_RECORDS] + kernels[BNCONV_RECORDS]:
        check(kern["launches_by_path"]["mesh_train"] == 0,
              f"{kern['name']} launched on the mesh path")
    print(f"phase 21 mesh ({kind} | {ident}): {mesh['world']} rank(s), "
          f"backend {mesh['backend']}, NCCL {mesh['nccl']}; the five "
          f"collectives on dp held to their values on every rank",
          flush=True)
    for b in mesh["bench"]:
        bus = (f"{b['bus_gb_s']:.2f} GB/s" if b["bus_gb_s"] is not None
               else "null (n = 1: no byte crosses a link)")
        print(f"phase 21 {b['op']} {b['size_mb']:.1f} MB over "
              f"{b['n_devices']} rank(s): {b['mean_s'] * 1e3:.4f} ms, "
              f"algbw {b['alg_gb_s']:.2f} GB/s, busbw {bus}", flush=True)
    for name, errs in mesh["flash"].items():
        B, S, H, D = LM_FLASH_SHAPE
        tp = 2 if name == "tp2" else 1
        print(f"phase 21 flash kernels at {name}'s local heads on rank 0's "
              f"card, (B, S, H, D) = ({B}, {S}, {H // tp}, {D}) bf16 causal:"
              f" max abs err " + " ".join(f"{k} {v:.2e}" for k, v in
                                          errs.items()), flush=True)
    for name, e in mesh["entry"].items():
        print(f"phase 21 examples.lm.main through launcher_init's mesh, "
              f"{name}, dp = {mesh['world'] // (2 if name == 'tp2' else 1)}"
              f" ({kind} | {ident}): d_model 768, 12 layers, 12 heads, "
              f"d_ff 3072, vocab 32000, seq 512, per-device batch 8, "
              f"flash, bf16/f32, remat; {MESH_WARMUP} warm-up + "
              f"{MESH_TIMED} timed steps: step_ms={e['step_ms']} "
              f"p50_ms={e['p50_ms']:.3f} tokens_per_s_per_card="
              f"{e['tokens_per_s_per_card']:.1f} mfu={e['mfu']:.4f} "
              f"(analytic 6NT + 12BLS²D over 989 TFLOP/s a card) "
              f"peak_gb={e['peak_gb']:.2f} losses={e['losses']}",
              flush=True)
    par = mesh["parity"]
    print(f"phase 21 f32 mesh step vs mesh-less step, 3 steps, 2 layers at "
          f"phase 14's widths, TF32 off: max loss err {par['loss']:.2e}, "
          f"max grad_norm rel err {par['grad_norm']:.2e}, max param err "
          f"{par['params']:.2e} (limits 1e-5), max movement err "
          f"{par['moved']:.2e} (||Δ - Δ_plain|| / ||Δ_plain||, limit "
          f"{MESH_MOVED_LIMIT:.0e}); losses {par['losses']}", flush=True)
    for impl, e in mesh["seq_parallel"].items():
        print(f"phase 21 {impl} over tp = {mesh['world']} vs flash, f32: "
              f"logits max err {e['logits']:.2e} ({e['logits_scaled']:.2e}"
              f" over the logits' magnitude), loss err {e['loss']:.2e}, "
              f"grad_norm rel err {e['grad_norm']:.2e} (limits 1e-5: the "
              f"scaled logits, loss, grad_norm)", flush=True)
    print(f"phase 21 launches={mesh['launches']}", flush=True)
    lap("21")
    torch.cuda.empty_cache()
    pipe = pipe_moe_image_phase(device)
    for kern in kernels:
        n = pipe["launches"].get(kern["name"], 0)
        kern["launches_by_path"]["pipe_moe_image"] = n
        kern["launches"] += n
        held = {**pipe["checks"]["flash"], **pipe["checks"]["bnconv"]}
        if kern["name"] in held:
            kern["max_abs_err"] = max(kern["max_abs_err"],
                                      held[kern["name"]])
    for kern in kernels[FLASH_RECORDS.start:]:
        check(kern["launches_by_path"]["pipe_moe_image"] > 0,
              f"{kern['name']} never launched on the pipe_moe_image path")
    for kern in kernels[SERVING_RECORDS]:
        check(kern["launches_by_path"]["pipe_moe_image"] == 0,
              f"{kern['name']} launched on the pipe_moe_image path")
    B, S = PIPE_BATCH // PIPE_MICRO, PIPE_LM["max_seq_len"]
    print(f"phase 22 kernels at the paths' shapes: flash ({B}, {S}, 12, 64) "
          f"bf16 causal, max abs err " + " ".join(
              f"{k} {v:.2e}" for k, v in pipe["checks"]["flash"].items())
          + "; bnconv at the 4 ResNet-50 sites at batch "
          f"{PIPE_IMAGE_BATCH}, bf16, max abs err " + " ".join(
              f"{k} {v:.2e}" for k, v in pipe["checks"]["bnconv"].items()),
          flush=True)
    r = pipe["pipe"]
    print(f"phase 22 make_pipelined_lm_train_step ({kind} | {ident}): "
          f"launcher_init(pp=1), {PIPE_MICRO} microbatches of "
          f"{PIPE_BATCH // PIPE_MICRO} rows, d_model 768, 12 layers, 12 "
          f"heads, d_ff 3072, vocab 32000, seq 512, batch {PIPE_BATCH}, "
          f"flash, bf16/f32, remat; {PIPE_WARMUP} warm-up + {PIPE_TIMED} "
          f"timed steps: step_ms={r['step_ms']} p50_ms={r['p50_ms']:.3f} "
          f"tokens_per_s={r['tokens_per_s']:.1f} mfu={r['mfu']:.4f} "
          f"peak_gb={r['peak_gb']:.2f} state_s={r['setup_s']:.1f} "
          f"losses={r['losses']} launches={r['launches']} (predicted "
          f"{r['predicted']})", flush=True)
    par = pipe["pipe_parity"]
    print(f"phase 22 f32 pipelined step (2 microbatches) vs "
          f"make_lm_train_step, same mesh, 3 steps, 2 layers at the "
          f"entry point's widths, TF32 off: max loss err {par['loss']:.2e}, "
          f"max grad_norm rel err {par['grad_norm']:.2e}, max param err "
          f"{par['params']:.2e} (limits 1e-5), movement err "
          f"{par['moved']:.2e} (limit {MESH_MOVED_LIMIT:.0e})", flush=True)
    r = pipe["moe"]
    print(f"phase 22 examples.lm.main --n-experts 8 --attention-impl flash "
          f"through the mesh ({kind} | {ident}): {PIPE_MOE_STEPS} steps, "
          f"losses={r['losses']} p50_step_s={r['p50_step_s']} "
          f"tokens_per_s={r['tokens_per_s']:.1f} peak_gb="
          f"{r['peak_gb']:.2f} (phase 15, dense attention: p50_step_s="
          f"{moe['p50_step_s']} peak_gb={moe['peak_gb']:.2f}) "
          f"launches={r['launches']}", flush=True)
    for label, par in pipe["moe_parity"].items():
        print(f"phase 22 f32 MoE mesh step vs mesh-less, {label} dispatch, "
              f"8 experts top-2, 3 steps, 2 layers, TF32 off: max loss err "
              f"{par['loss']:.2e}, grad_norm rel err "
              f"{par['grad_norm']:.2e}, param err {par['params']:.2e} "
              f"(limits 1e-5), movement err {par['moved']:.2e}", flush=True)
    r = pipe["resnet"]
    print(f"phase 22 resnet50 fused through make_image_train_step(mesh), "
          f"BatchNorm over the global batch ({kind} | {ident}): batch "
          f"{PIPE_IMAGE_BATCH}, bf16/f32, sgd 0.1 m 0.9, "
          f"{PIPE_IMAGE_WARMUP} warm-up + {PIPE_IMAGE_TIMED} timed: "
          f"step_ms={r['step_ms']} images_per_s={r['images_per_s']:.1f} "
          f"peak_gb={r['peak_gb']:.2f} losses={r['losses']} "
          f"launches={r['launches']}", flush=True)
    par = pipe["image_parity"]
    print(f"phase 22 f32 fused resnet mesh step vs mesh-less, 2 steps, "
          f"TF32 off: max loss err {par['loss']:.2e} (limit 1e-5), running "
          f"statistics {par['stats']:.2e} (limit 1e-6), params "
          f"{par['params']:.2e}", flush=True)
    for dp in (2, 8):
        b = moe_exchange_bytes(dp)
        print(f"phase 22 MoE exchange a rank and layer, forward, at "
              f"examples/lm.py's widths over dp = {dp} (from the shapes; "
              f"not timed: one card): capacity {b['capacity']}, dense "
              f"(E, C, D) reduce-scatter + all-gather "
              f"{b['dense_buffers'] / 1e6:.2f} MB, filled slots alone "
              f"{b['filled_slots'] / 1e6:.2f} MB; dense dispatch's f32 "
              f"expert gather {b['weights'] / 1e6:.2f} MB", flush=True)
    print(f"phase 22 launches={pipe['launches']} by part "
          f"{pipe['parts']}", flush=True)
    lap("22")
    torch.cuda.empty_cache()
    ms = mesh_serving_phase(device, base, cfg, streams4)
    for kern in kernels:
        for path in ("mesh_serving", "encoder_tp"):
            n = ms[path].get(kern["name"], 0)
            kern["launches_by_path"][path] = n
            kern["launches"] += n
        if kern["name"] in ms["checks"]:
            kern["max_abs_err"] = max(kern["max_abs_err"],
                                      ms["checks"][kern["name"]])
    for kern in kernels[SERVING_RECORDS]:
        check(kern["launches_by_path"]["mesh_serving"] > 0,
              f"{kern['name']} never launched on the mesh_serving path")
    tma["mesh_serving"] = ms["mesh_serving"].get("paged_decode_tma", 0)
    check(tma["mesh_serving"] > 0,
          "paged_decode_tma_kernel never launched on the mesh_serving path")
    # the encoder steps run f32: the flash forward's FMA kernel and the
    # backward's dQ and dK/dV kernels, not the one-pass bf16 backward
    enc = ms["encoder_tp"]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(enc.get(name, 0) > 0,
              f"{name} never launched on the encoder_tp path ({enc})")
    print_mesh_serving(ms, cfg, kind, ident, serve)
    lap("23")
    torch.cuda.empty_cache()
    phase24(device, base, kernels, kind, ident)
    lap("24")
    torch.cuda.empty_cache()
    phase25(device, base, kernels, kind, ident)
    lap("25")
    torch.cuda.empty_cache()
    phase26(device, base, cfg, kernels, kind, ident, first_build)
    lap("26")
    for kern in kernels:
        for path, res in (("lm_entry", lm), ("moe_train", moe),
                          ("spec_serving", spec), ("predict", pred),
                          ("image_entry", images), ("grpc_core", core)):
            n = res["launches"][kern["name"]]
            kern["launches_by_path"][path] = n
            kern["launches"] += n
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-rank"]:
        sys.exit(serve_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--elastic-rank"]:
        sys.exit(elastic_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--elastic-resume"]:
        sys.exit(elastic_resume_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--compose-rank"]:
        sys.exit(compose_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--budget-rank"]:
        try:
            sys.exit(budget_rank_main(sys.argv[2:]))
        except SmokeFailure as e:
            print(f"chip_smoke FAILED: {e}", file=sys.stderr)
            sys.exit(1)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
