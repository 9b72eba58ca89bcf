#!/usr/bin/env python3
"""Split size of the port's paged decode kernel, swept on one GPU.

``kubeflow_tpu_torch/ops/csrc/paged_attention.cu`` splits each row's
live pages into blocks of about ``_SPLIT_TOKENS`` keys. This script times
the kernel (``chip_smoke.time_ms``: CUDA events, cold L2, device time
only) for several split sizes at two shapes of the serving model (B=8,
QH=KH=16, Dh=64, page 64, 32 logical pages, bf16): rows at their full
2048-token context, and rows at 280-340 tokens as in ``chip_smoke.py``'s
serving phase. Prints one JSON line per point with the bound of its
shape (live K/V bytes over 3.35 TB/s).

Usage: ``python3 scripts/port_paged_sweep.py`` (needs CUDA).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    import chip_smoke
    from kubeflow_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda", 0)
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    B, H, Dh, ps, n_log = 8, 16, 64, 64, 32
    P = B * n_log
    gen = torch.Generator(device="cpu").manual_seed(0)
    q = torch.randn((B, H, Dh), generator=gen).to(dev, torch.bfloat16)
    k = torch.randn((P, ps, H, Dh), generator=gen).to(dev, torch.bfloat16)
    v = torch.randn((P, ps, H, Dh), generator=gen).to(dev, torch.bfloat16)
    pages = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, n_log)
    rng = np.random.default_rng(0)
    shapes = {"full_2048": np.full(B, n_log * ps - 1),
              "serving_280_340": rng.integers(280, 341, size=B)}
    default = pa._SPLIT_TOKENS
    try:
        for label, pos_np in shapes.items():
            pos = torch.as_tensor(pos_np.astype(np.int32), device=dev)
            want = pa.paged_decode_attention_plain(q, k, v, pages, pos)
            nbytes, _ = chip_smoke.paged_bytes_ops(q, k, pages, pos, P, ps)
            for split in (64, 128, 256, 512, 1024):
                pa._SPLIT_TOKENS = split
                got = pa.paged_decode_attention(q, k, v, pages, pos)
                err = (got.float() - want.float()).abs().max().item()
                ms = chip_smoke.time_ms(
                    lambda: pa.paged_decode_attention(q, k, v, pages, pos))
                print(json.dumps({
                    "device": ident, "shape": label, "split_tokens": split,
                    "kernel_ms": ms,
                    "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                    "max_abs_err": err}), flush=True)
    finally:
        pa._SPLIT_TOKENS = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
