#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paged serving engine, on one GPU.

Builds the full-width engine-bench LM (vocab 32000, d_model 1024, 8
layers, 16 heads, max_seq_len 2048; random weights from a numpy seed),
runs the ``kubeflow_tpu_torch`` ``DecodeEngine`` with the paged cache
and the fused sampler over 8 concurrent requests (~300-token prompts,
64 new tokens, half sampled), and profiles one such run with
``torch.profiler`` after a warm-up run. Prints, and writes to
``chiprun_out/port_decode_profile.json``:

- wall time, tokens/s, decode steps and prefill chunks of the run;
- device busy time (sum of kernel time) and the idle share of the wall;
- device time by kernel name (top 15), and the two port kernels' totals
  and launch counts.

Usage: ``python3 scripts/port_decode_profile.py`` (needs CUDA).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def run(eng, prompts, max_new):
    reqs = []
    for i, p in enumerate(prompts):
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=i)
        reqs.append(eng.submit(p, max_new=max_new, **kw))
    while eng.active_count or eng.pending_count:
        eng.run_once(timeout=0.01)
    return [r.result() for r in reqs]


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    dev = torch.device("cuda", 0)
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cfg = TransformerConfig(vocab_size=32000, d_model=1024, n_layers=8,
                            n_heads=16, n_kv_heads=16, d_ff=4096,
                            max_seq_len=2048, dtype="bfloat16")
    model = convert.to_module(cfg, convert.random_params(cfg, 0),
                              device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 32000, size=300 - 7 * i).tolist()
               for i in range(8)]
    eng = DecodeEngine(cfg, model, slots=8, steps_per_sync=4, paged=True,
                       sampler_impl="fused", autostart=False, device=dev)
    run(eng, prompts, 64)                       # warm-up
    torch.cuda.synchronize()
    steps0, chunks0 = eng.steps_total, eng.prefill_chunks
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(eng, prompts, 64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "device_time_total", None)
        if dt is None:
            dt = getattr(evt, "cuda_time_total", 0)
        if dt and evt.device_type.name == "CUDA":
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 1e3  # ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    kernels = {"paged_decode_attention": ("paged_split_kernel",
                                          "paged_combine_kernel"),
               "fused_sample": ("fused_sample_kernel",)}
    port = {k: sum(v for n, v in by_name.items()
                   if any(part in n for part in parts))
            for k, parts in kernels.items()}
    out = {"device": ident, "wall_ms": wall * 1e3,
           "tokens_per_s": 8 * 64 / wall,
           "decode_steps": eng.steps_total - steps0,
           "prefill_chunks": eng.prefill_chunks - chunks0,
           "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
           "port_kernels_ms": port,
           "port_kernel_launches": {
               "paged_decode_attention": ops.paged_attention.launches,
               "fused_sample": ops.sampling.launches},
           "top_kernels_ms": top}
    eng.close()
    print(json.dumps(out, indent=1))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/port_decode_profile.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
