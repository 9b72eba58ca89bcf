#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving engine, on one GPU.

Default (paged): builds the full-width engine-bench LM (vocab 32000,
d_model 1024, 8 layers, 16 heads, max_seq_len 2048; random weights from
a numpy seed), runs the ``kubeflow_tpu_torch`` ``DecodeEngine`` with the
paged cache and the fused sampler over 8 concurrent requests (~300-token
prompts, 64 new tokens, half sampled), and profiles one such run with
``torch.profiler`` after a warm-up run.

``--dense``: ``chip_smoke.py`` phase 9's configuration (the same widths
at max_seq_len 256; 48 requests of 128 prompt tokens and 128 new through
32 slots, 64 steps a host round-trip, bursts of 8): profiles its greedy
run (the default bounded sampler) and its fused-sampled run, each burst
after the engine's warm-up. It loads ``chip_smoke.py`` by path and runs
phase 9's own helpers (``dense_setup``, ``dense_engine``,
``dense_warm``, ``dense_burst`` and the ``DENSE_*`` constants), so the
profile and the smoke measure one configuration by one code path: a
change to those helpers changes this profile too.

Each run prints, and writes to
``chiprun_out/port_decode_profile.json``:

- wall time, tokens/s, decode steps, prefill chunks and batch prefills;
- device busy time (sum of kernel time) and the idle share of the wall;
- device time by kernel name (top 15), and the two port kernels' totals
  and launch counts;
- ``--dense``: the synchronizing CUDA calls of a second, unprofiled
  burst, by source line (``torch.cuda.set_sync_debug_mode``).

Usage: ``python3 scripts/port_decode_profile.py [--dense]`` (needs CUDA).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PORT_KERNELS = {"paged_decode_attention": ("paged_decode_kernel",
                                           "paged_decode_tma_kernel"),
                "fused_sample": ("fused_sample_kernel",)}


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


def profiled(fn, n_tokens: int, eng) -> dict:
    """``fn()`` under ``torch.profiler``: wall, device busy time by kernel
    and the port kernels' time and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch import ops

    torch.cuda.synchronize()
    steps0, chunks0 = eng.steps_total, eng.prefill_chunks
    batches0 = eng.batch_prefills
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return {"wall_ms": wall * 1e3, "tokens_per_s": n_tokens / wall,
            "decode_steps": eng.steps_total - steps0,
            "prefill_chunks": eng.prefill_chunks - chunks0,
            "batch_prefills": eng.batch_prefills - batches0,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "port_kernels_ms": {
                k: sum(v for n, v in by_name.items()
                       if any(part in n for part in parts))
                for k, parts in PORT_KERNELS.items()},
            "port_kernel_launches": {
                k: n for k, n in ops.launch_counts().items()
                if k in PORT_KERNELS},
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:15]}


def paged_profile(dev) -> dict:
    import numpy as np

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

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
    out = profiled(lambda: run(eng, prompts, 64), 8 * 64, eng)
    eng.close()
    return out


def dense_profile(dev) -> dict:
    """Phase 9's greedy and fused-sampled bursts, each after its engine's
    warm-up (``chip_smoke.dense_warm``)."""
    spec = importlib.util.spec_from_file_location(
        "port_decode_profile_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, model, prompts = cs.dense_setup(dev)
    out = {}
    for name, impl, kw in (("greedy", None, {}),
                           ("fused", "fused", cs.DENSE_SAMPLED)):
        eng = cs.dense_engine(cfg, model, dev, impl)
        cs.dense_warm(eng, prompts, kw)

        def burst():
            cs.dense_burst(eng, prompts, kw)

        out[name] = profiled(burst, cs.DENSE_REQUESTS * cs.DENSE_NEW, eng)
        steps0 = eng.steps_total
        out[name]["host_syncs"] = sync_census(burst)
        out[name]["host_syncs"]["decode_steps"] = eng.steps_total - steps0
        eng.close()
    return out


def sync_census(fn) -> dict:
    """Synchronizing CUDA calls made by ``fn()``, counted by the source
    line that made them (torch's sync debug mode warns on each)."""
    import collections
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    lines = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return {"total": sum(lines.values()), "by_line": dict(lines)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true",
                    help="profile chip_smoke.py phase 9's dense engine")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    out = {"device": ident, "mode": "dense" if args.dense else "paged",
           **(dense_profile(dev) if args.dense else paged_profile(dev))}
    print(json.dumps(out, indent=1))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/port_decode_profile.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
