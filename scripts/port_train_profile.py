#!/usr/bin/env python3
"""Where the time goes in one train step of the PyTorch port, on one GPU.

Builds the long-context training configuration of ``chip_smoke.py``
(``bench/suite.py:bench_longcontext``: vocab 32000, d_model 1024, 8
layers, 16 heads, seq 8192, batch 2, bf16 compute over f32 params,
flash attention with remat; random weights from a numpy seed), takes two
warm-up steps of ``make_lm_train_step``, and profiles the next step with
``torch.profiler``. With ``--bert`` it builds phase 11's BERT-base
configuration instead (``bench/suite.py:bench_bert``: batch 16, seq 512,
the flash kernels non-causal) and profiles ``make_mlm_train_step``;
with ``--lm-entry``, the LM entry point's defaults (``examples/lm.py``:
d_model 768, 12 layers, seq 512, batch 8, dense attention with remat;
step 3's batch of ``batch_for_step``). Prints, and writes as
``port_train_profile[_bert|_lm_entry].json`` in the output directory:

- step wall time, tokens/s and MFU (the bench's flop count over 989
  TFLOP/s, bf16 dense);
- device busy time (sum of kernel time) and the idle share of the wall;
- device time by class (the three flash kernels, GEMMs, everything
  else) and by kernel name (top 15), and the flash kernels' launches.

Usage: ``python3 scripts/port_train_profile.py [--bert | --lm-entry]``
(needs CUDA).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# the flash kernels' symbols: bf16 on the tensor cores (*_mma_kernel),
# f32 on the FMA units
FLASH = ("flash_fwd_mma_kernel", "flash_fwd_kernel",
         "flash_bwd_dq_mma_kernel", "flash_bwd_dq_kernel",
         "flash_bwd_dkv_mma_kernel", "flash_bwd_dkv_kernel")
GEMM = ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas")


def kernel_class(name: str) -> str:
    if any(k in name for k in FLASH):
        return "flash"
    if any(k in name.lower() for k in GEMM):
        return "gemm"
    return "other"


def lm_entry_setup(device):
    """``examples/lm.py``'s state at its defaults and a batch of it."""
    from kubeflow_tpu_torch.examples.lm import batch_for_step
    from kubeflow_tpu_torch.models.convert import random_params
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.train import create_train_state, make_optimizer

    cfg = TransformerConfig(vocab_size=32000, d_model=768, n_layers=12,
                            n_heads=12, n_kv_heads=12, d_ff=3072,
                            max_seq_len=512)
    state = create_train_state(
        cfg, random_params(cfg, 0),
        make_optimizer(3e-4, warmup_steps=20, decay_steps=101),
        device=device)
    return cfg, state, batch_for_step(3, 8, 512, cfg.vocab_size)


def lm_entry_flops(cfg, n_params: int) -> int:
    """6·N·tokens plus the causal attention products, remat excluded
    (``train_flops``'s count at batch 8)."""
    B, S = 8, cfg.max_seq_len
    return 6 * n_params * B * S + 6 * cfg.n_layers * B * S * S * cfg.d_model


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.train import (
        make_lm_train_step,
        make_mlm_train_step,
    )

    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    bert = "--bert" in sys.argv[1:]
    entry = "--lm-entry" in sys.argv[1:]
    if entry:
        cfg, state, tokens = lm_entry_setup(device)
        batch = (tokens,)
        tokens_per_step = tokens.numel()
        step, flops = make_lm_train_step(), lm_entry_flops
    elif bert:
        cfg, state, batch = cs.bert_setup(device)
        tokens_per_step = cs.BERT_BATCH * cs.BERT_SEQ
        step, flops = make_mlm_train_step(), cs.bert_train_flops
    else:
        cfg, state, tokens = cs.train_setup(device)
        batch = (tokens,)
        tokens_per_step = cs.TRAIN_BATCH * cfg.max_seq_len
        step, flops = make_lm_train_step(), cs.train_flops
    for _ in range(2):                          # warm-up
        state, m = step(state, *batch)
    float(m["loss"])
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "device_time_total", None)
        if dt is None:
            dt = getattr(evt, "cuda_time_total", 0)
        if dt and evt.device_type.name == "CUDA":
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 1e3  # ms
    busy = sum(by_name.values())
    by_class = {}
    for name, ms in by_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    n_params = sum(p.numel() for p in state.params)
    config = "lm_entry" if entry else "bert" if bert else "lm"
    out = {"device": ident, "config": config,
           "step_wall_ms": wall * 1e3,
           "tokens_per_s": tokens_per_step / wall,
           "mfu": flops(cfg, n_params) / wall / cs.BF16_FLOPS,
           "loss": float(m["loss"]),
           "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
           "device_ms_by_class": by_class,
           "flash_kernels_ms": {k: sum(v for n, v in by_name.items()
                                       if k in n) for k in FLASH},
           "flash_launches": {k: n for k, n in ops.launch_counts().items()
                              if k.startswith("flash")},
           "top_kernels_ms": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:15]}
    print(json.dumps(out, indent=1))
    os.makedirs("chiprun_out", exist_ok=True)
    name = ("port_train_profile" if config == "lm"
            else f"port_train_profile_{config}")
    with open(f"chiprun_out/{name}.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
