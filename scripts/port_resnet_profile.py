#!/usr/bin/env python3
"""Where the time goes in one ResNet-50 train step of the PyTorch port.

Builds the configuration of ``chip_smoke.py`` phase 7
(``bench/suite.py:bench_resnet50`` with ``KFTPU_RESNET_FUSED_BN=1``:
batch 256 of 224x224 images, bf16 compute and BN over f32 params, the
space_to_depth stem, the fused BN-apply + ReLU + 1x1 conv at its 16
sites, SGD 0.1 with momentum 0.9; random weights from a numpy seed),
takes two warm-up steps of ``make_image_train_step``, and profiles the
next step with ``torch.profiler``. Prints, and writes to
``chiprun_out/port_resnet_profile.json``:

- step wall time, images/s and MFU (``bench_resnet50``'s flop count
  over 989 TFLOP/s, bf16 dense);
- device busy time (sum of kernel time) and the idle share of the wall;
- device time by class: the bnconv kernels, cuDNN convolutions, GEMMs
  (the backward's ``dz @ w^T``), and the elementwise rest (BN, ReLU,
  casts, the SGD update), and every kernel's time by class;
- the SGD update's own device span (CUDA events around it) and the
  bnconv kernels' launches.

Usage: ``python3 scripts/port_resnet_profile.py`` (needs CUDA).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CONV = ("fprop", "dgrad", "wgrad", "conv", "implicit", "nhwc", "nchw",
        "cudnn")
GEMM = ("gemm", "nvjet", "cutlass", "cublas")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "bnconv" in low:
        return "bnconv"
    if any(k in low for k in CONV):
        return "conv"
    if any(k in low for k in GEMM):
        return "gemm"
    return "elementwise"


class TimedTx:
    """The state's optimizer with CUDA events around each update."""

    def __init__(self, tx):
        import torch

        self.tx = tx
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def init(self, params):
        return self.tx.init(params)

    def apply(self, params, grads, state, grad_norm=None):
        self.events[0].record()
        self.tx.apply(params, grads, state, grad_norm)
        self.events[1].record()


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from chip_smoke import (
        BF16_FLOPS,
        RESNET_BATCH,
        resnet50_train_flops_per_image,
        resnet_setup,
    )
    from kubeflow_tpu_torch import ops
    from kubeflow_tpu_torch.train import make_image_train_step

    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cfg, state, images, labels = resnet_setup(torch.device("cuda", 0))
    state.tx = TimedTx(state.tx)
    step = make_image_train_step()
    for _ in range(2):                          # warm-up
        state, m = step(state, images, labels)
    float(m["loss"])
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, images, labels)
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
    flops = resnet50_train_flops_per_image(cfg.stem) * RESNET_BATCH
    out = {"device": ident, "step_wall_ms": wall * 1e3,
           "images_per_s": RESNET_BATCH / wall,
           "mfu": flops / wall / BF16_FLOPS,
           "loss": float(m["loss"]),
           "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
           "device_ms_by_class": by_class,
           "sgd_span_ms": state.tx.events[0].elapsed_time(
               state.tx.events[1]),
           "bnconv_kernels_ms": {n: v for n, v in by_name.items()
                                 if kernel_class(n) == "bnconv"},
           "bnconv_launches": {k: n for k, n in ops.launch_counts().items()
                               if k.startswith("bnconv")},
           "top_kernels_ms": sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:15],
           "kernels_by_class": {
               cls: sorted(((n[:160], v) for n, v in by_name.items()
                            if kernel_class(n) == cls),
                           key=lambda kv: -kv[1])
               for cls in by_class}}
    print(json.dumps(out, indent=1))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/port_resnet_profile.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
