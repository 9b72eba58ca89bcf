#!/usr/bin/env python3
"""The port's fused sampler timed on one GPU, alone or against another
checkout's.

Every point is timed with ``chip_smoke.time_ms`` (CUDA events, cold L2,
device time only) on ``chip_smoke.py``'s random sampler rows (greedy,
top-k, top-p, both and unfiltered rows): B=8 at V=32000, the serving
model's vocabulary, and at Llama-3's 128,256; then each kind of row
alone (B=1, a prefill sample) at V=32000, which splits a row's time into
its load and draw (greedy, unfiltered), its four top-k passes (k=50) and
its max and four top-p passes (p=0.9). Prints one JSON line per point,
with the card's name and power limit, the bound of its rows
(``chip_smoke.sampler_bytes_ops``) and whether the tokens equal the
plain version's, and one for the floor of the timing itself:
``time_ms`` of a one-element fill.

Usage (needs CUDA):

- ``python3 scripts/port_sampler_sweep.py`` times this checkout's kernel;
- ``python3 scripts/port_sampler_sweep.py --against DIR`` times DIR's
  kernel (another checkout's root, e.g. the parent commit unpacked by
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
# (label, V, rows of chip_smoke.sampler_inputs)
POINTS = (("B=8", 32000, slice(0, 8)), ("B=8", 128256, slice(0, 8)),
          ("greedy", 32000, slice(0, 1)), ("k=50", 32000, slice(2, 3)),
          ("p=0.9", 32000, slice(4, 5)), ("k=100 p=0.8", 32000, slice(6, 7)),
          ("unfiltered", 32000, slice(7, 8)))


def _smoke():
    """This checkout's ``chip_smoke`` (inputs, bounds and timing), loaded
    by path: with ``--tree`` the package on ``sys.path`` is another's."""
    spec = importlib.util.spec_from_file_location(
        "port_sampler_sweep_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _points(tree):
    import torch

    from kubeflow_tpu_torch.ops import sampling as sm

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    one = torch.empty(1, device=dev)
    print(json.dumps({"device": ident, "tree": tree, "shape": "floor",
                      "kernel_ms": smoke.time_ms(one.zero_)}), flush=True)
    for label, V, rows in POINTS:
        logits, temp, top_k, top_p = smoke.sampler_inputs(dev, V=V)
        args = [a[rows].contiguous() for a in (logits, temp, top_k, top_p)]
        B = args[0].shape[0]
        noise = sm.gumbel_noise(list(range(B)), [0] * B, V, device=dev)
        got = sm.fused_sample(args[0], noise, *args[1:])
        want = sm.fused_sample_plain(args[0], noise, *args[1:])
        nbytes, flops = smoke.sampler_bytes_ops(*args)
        ms = smoke.time_ms(lambda: sm.fused_sample(args[0], noise,
                                                   *args[1:]))
        print(json.dumps({
            "device": ident, "tree": tree, "shape": f"{label} V={V}",
            "kernel_ms": ms,
            "bound_ms": max(nbytes / smoke.HBM_BYTES_PER_S,
                            flops / smoke.F32_FLOPS) * 1e3,
            "tokens_equal_plain": bool(torch.equal(got, want))}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time DIR's kernel and this one's in turns")
    ap.add_argument("--tree", metavar="DIR",
                    help="time DIR's kernel only (one turn of --against)")
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
