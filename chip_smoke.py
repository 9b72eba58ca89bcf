#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and the port package beside it; without
them it exits non-zero and prints no result. It imports nothing of JAX or
of ``kubeflow_tpu``. Phases, each fatal on failure:

1. build both CUDA kernels from ``kubeflow_tpu_torch/ops/csrc`` (one
   ``nvcc`` each, in parallel) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   serving shapes (paged attention: bf16 within atol 8e-3, f32 within
   atol 1e-5; sampler: token-identical), timed with CUDA events;
3. serve the full-width engine-bench LM (vocab 32000, d_model 1024, 8
   layers, 16 heads, max_seq_len 2048; random weights from a numpy seed,
   written as a model-store export) through the port's ``ModelServer``
   with the paged cache and the fused sampler, POST 8 concurrent
   ``:generate`` requests (greedy and sampled, ~300-token prompts, 64 new
   tokens) and require both kernels to have launched during that run;
4. run the same greedy requests through the engine in f32 with the
   kernel and with the gather path (TF32 off) and require identical
   token streams.

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, the ``{"kernels": [...]}`` record, and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
SEED = 0
BENCH = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
             n_kv_heads=16, d_ff=4096, max_seq_len=2048)


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


def check_paged_kernel(device):
    import torch

    from kubeflow_tpu_torch.ops import paged_attention as pa

    results = {}
    # (label, QH, KH, dtype, atol): bf16 tolerance — the plain version
    # rounds scores to bf16 after its einsum (the reference's gather
    # rounding point) while the kernel keeps them in f32; both round the
    # output to bf16, so they differ by about one bf16 step of an output
    # of magnitude < 1 (3.9e-3); atol is two such steps. f32 differs only
    # by summation order
    cases = [("bf16", 16, 16, torch.bfloat16, 8e-3),
             ("bf16_gqa", 16, 4, torch.bfloat16, 8e-3),
             ("f32", 16, 16, torch.float32, 1e-5),
             ("f32_gqa", 16, 4, torch.float32, 1e-5)]
    for label, QH, KH, dtype, atol in cases:
        q, k, v, pages, pos, P = paged_inputs(8, QH, KH, 64, 64, 32, dtype,
                                              device, seed=SEED + QH + KH)
        got = pa.paged_decode_attention(q, k, v, pages, pos)
        want = pa.paged_decode_attention_plain(q, k, v, pages, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got.float()).all()),
              f"paged {label}: non-finite output")
        check(err <= atol, f"paged {label}: max abs err {err} > {atol}")
        check(got[-1].float().abs().max().item() == 0.0,
              f"paged {label}: all-sentinel row is not zeros")
        typical = want[:-1].float().abs().mean().item()
        print(f"paged_attention {label}: max_abs_err={err:.3e} "
              f"(atol {atol}) mean_abs_out={typical:.3e}", flush=True)
        results[label] = (q, k, v, pages, pos, P, err)
    q, k, v, pages, pos, P, err = results["bf16"]
    kernel_ms = time_ms(lambda: pa.paged_decode_attention(q, k, v, pages,
                                                          pos))
    plain_ms = time_ms(lambda: pa.paged_decode_attention_plain(
        q, k, v, pages, pos))
    nbytes, flops = paged_bytes_ops(q, k, pages, pos, P, k.shape[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    print(f"paged_attention bf16 B=8 QH=KH=16 Dh=64 ps=64 n_log=32: "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={max(t_bytes, t_ops):.4f} ({nbytes} B)", flush=True)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "kubeflow_tpu/ops/paged_attention.py:69",
            "max_abs_err": max(r[-1] for r in results.values()),
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def check_sampler_kernel(device):
    import torch

    from kubeflow_tpu_torch.ops import sampling as sm

    logits, temp, top_k, top_p = sampler_inputs(device)
    B, V = logits.shape
    for seed in range(4):
        noise = sm.gumbel_noise(list(range(B)), [seed] * B, V,
                                device=device)
        got = sm.fused_sample(logits, noise, temp, top_k, top_p)
        want = sm.fused_sample_plain(logits, noise, temp, top_k, top_p)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"fused_sample differs from plain: {got.tolist()} vs "
              f"{want.tolist()}")
    print(f"fused_sample B={B} V={V}: token-identical over 4 noise draws "
          f"({got.tolist()})", flush=True)
    kernel_ms = time_ms(lambda: sm.fused_sample(logits, noise, temp, top_k,
                                                top_p))
    plain_ms = time_ms(lambda: sm.fused_sample_plain(logits, noise, temp,
                                                     top_k, top_p))
    greedy = (temp <= 0).cpu()
    n_sampled = int((~greedy).sum())
    nbytes = (B * V * 4 + n_sampled * V * 4       # logits; noise if read
              + B * (4 + 4 + 4) + B * 4)          # per-row params, out
    kf = int(((top_k > 0) & (top_k < V)).cpu()[~greedy].sum())
    pf = int((top_p < 1).cpu()[~greedy].sum())
    # per element: a compare per k pass; exp + add per p pass (+ max, z)
    flops = V * (B + 32 * kf + (2 * 32 + 4) * pf + 2 * n_sampled)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    print(f"fused_sample: kernel_ms={kernel_ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f}", flush=True)
    return {"name": "fused_sample", "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/fused_sample.cu",
            "replaces": "kubeflow_tpu/ops/sampling.py:77",
            "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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
                max_new=64):
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.serving.server import ModelServer

    os.environ["KFTPU_PAGED"] = "1"
    os.environ["KFTPU_SAMPLER_IMPL"] = "fused"
    server = ModelServer(base, port=0, decode_slots=8,
                         decode_steps_per_sync=4, device=device)
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/lm:generate"
    try:
        # warm-up: engine build, first cuBLAS handles; not counted
        _post(url, {"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 2},
              False)
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
        launches = {m.__name__.rsplit(".", 1)[-1]: m.launches
                    for m in ops.KERNEL_MODULES}
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
        return {"wall_s": wall,
                "tokens_per_s": n_requests * max_new / wall,
                "ttft_s": ttfts, "launches": launches}
    finally:
        server.stop()


# -- phase 4: kernel vs gather greedy parity in f32 -------------------------


def parity_phase(base: str, cfg, device, *, n=4, max_new=24,
                 prompt_len=200):
    import dataclasses

    import torch

    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.model_store import (
        MODEL_FILE,
        read_params,
    )
    import yaml

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vdir = os.path.join(base, "lm", "1")
    with open(os.path.join(vdir, MODEL_FILE)) as f:
        meta = yaml.safe_load(f)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = convert.to_module(cfg32, read_params(vdir, meta), device=device)
    prompts = prompts_for(n, prompt_len, cfg.vocab_size, seed=SEED + 7)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    ident = gpu_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | {ident}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build(["paged_attention", "fused_sample"])
    print(f"phase 1 build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  [{name}] {line.strip()}", flush=True)

    kernels = [check_paged_kernel(device), check_sampler_kernel(device)]
    print("phase 2 kernels vs plain: ok", flush=True)

    cfg = TransformerConfig(**BENCH, dtype="bfloat16")
    with tempfile.TemporaryDirectory(prefix="kftpu-smoke-") as base:
        t0 = time.perf_counter()
        write_export(base, cfg)
        print(f"export written: {time.perf_counter() - t0:.1f}s", flush=True)
        serve = serve_phase(base, cfg, device)
        for kern in kernels:
            key = {"paged_decode_attention": "paged_attention",
                   "fused_sample": "sampling"}[kern["name"]]
            kern["launches"] = serve["launches"][key]
            check(kern["launches"] > 0,
                  f"{kern['name']} never launched on the serving path")
        ttft = serve["ttft_s"]
        print(f"phase 3 serving ({kind} | {ident}): 8 concurrent "
              f":generate x 64 tokens, prompts ~300: "
              f"tokens_per_s={serve['tokens_per_s']:.1f} "
              f"wall_s={serve['wall_s']:.3f} "
              f"ttft_ms_stream={[round(t * 1e3, 1) for t in ttft]} "
              f"launches={serve['launches']}", flush=True)
        streams = parity_phase(base, cfg, device)
        print(f"phase 4 f32 kernel == gather greedy streams "
              f"({len(streams)} x {len(streams[0])} tokens)", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(ident)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
