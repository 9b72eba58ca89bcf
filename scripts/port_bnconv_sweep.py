#!/usr/bin/env python3
"""The port's bnconv kernels timed on one GPU, alone or against another
checkout's.

``kubeflow_tpu_torch/ops/csrc/bnconv.cu`` holds the fused BN-apply +
ReLU + 1x1 conv forward (``bnconv_fwd``) and its dW (``bnconv_dw``).
Both are timed in bf16 at ``chip_smoke.py``'s four ResNet-50 sites
(batch 256) with ``chip_smoke.time_ms`` (CUDA events, cold L2, device
time only). Prints one JSON line per kernel and site, with the card's
name and power limit and the site's bound (x, a, b and w or dz read
once, out or dW written once, over 3.35 TB/s; or the flops over the
bf16 tensor cores' 989 TFLOP/s, whichever is larger), and one per
kernel for a ResNet-50 step (the sites times their blocks, 16 in all).

Usage (needs CUDA):

- ``python3 scripts/port_bnconv_sweep.py`` times this checkout;
- ``python3 scripts/port_bnconv_sweep.py --against DIR`` times DIR's
  kernels (another checkout's root, e.g. the parent commit unpacked by
  ``git archive``) and this checkout's in turns (DIR, this, this, DIR),
  each in a process of its own.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _smoke():
    """This checkout's ``chip_smoke`` (sites, inputs, bounds and timing),
    loaded by path: with ``--tree`` the package on ``sys.path`` is
    another's."""
    spec = importlib.util.spec_from_file_location(
        "port_bnconv_sweep_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _points(tree: str) -> None:
    import torch

    from kubeflow_tpu_torch.ops import bnconv as bc

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    bf = torch.bfloat16
    step = {"bnconv_fwd": [0.0, 0.0], "bnconv_dw": [0.0, 0.0]}
    for M, K, N, blocks in smoke.RESNET50_SITES:
        x, a, b, w, dz = smoke.bnconv_inputs(M, K, N, bf, dev,
                                             smoke.SEED + 60)
        fns = {"bnconv_fwd": lambda: bc.bnconv_fwd(x, a, b, w),
               "bnconv_dw": lambda: bc.bnconv_dw(x, a, b, dz, None, bf)}
        work = smoke.bnconv_bytes_ops(M, K, N, 2)
        for name, fn in fns.items():
            ms = smoke.time_ms(fn)
            nbytes, flops = work[name]
            bound = max(nbytes / smoke.HBM_BYTES_PER_S,
                        flops / smoke.BF16_FLOPS) * 1e3
            step[name][0] += blocks * ms
            step[name][1] += blocks * bound
            print(json.dumps({"device": ident, "tree": tree,
                              "kernel": name, "site": [M, K, N],
                              "kernel_ms": ms, "bound_ms": bound}),
                  flush=True)
        del x, a, b, w, dz
        torch.cuda.empty_cache()
    for name, (ms, bound) in step.items():
        print(json.dumps({"device": ident, "tree": tree, "kernel": name,
                          "site": "per step (16 sites)", "kernel_ms": ms,
                          "bound_ms": bound}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time DIR's kernels and this one's in turns")
    ap.add_argument("--tree", metavar="DIR",
                    help="time DIR's kernels only (one turn of --against)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    if args.against:
        other = os.path.abspath(args.against)
        for tree in (other, ROOT, ROOT, other):
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--tree", tree]).returncode
            if rc:
                return rc
        return 0
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    _points(args.tree or ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
