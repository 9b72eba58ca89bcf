#!/usr/bin/env python3
"""The port's flash kernels timed on one GPU, against another checkout's.

``kubeflow_tpu_torch/ops/flash_attention.py``'s ``flash_fwd`` and its
backward are timed with ``chip_smoke.time_ms`` (CUDA events, cold L2,
device time only): ``flash_bwd`` (dQ, dK and dV from one call) where the
tree has it, else ``flash_bwd_dq`` and ``flash_bwd_dkv`` and their sum
as ``flash_bwd``, so a tree with one backward kernel and one with two
compare call for call. The points are at
``chip_smoke.py``'s timed shapes, bf16 at D=64: phase 2's LM
(B=2, S=8192, H=16, causal) and BERT-base (B=16, S=512, H=12,
non-causal), and phase 17's two inference shapes of BERT-base
``:predict`` (B=8, S=512 and B=1, S=128, H=12, non-causal), on inputs
made by ``chip_smoke.flash_inputs`` from one seed, the backward from the
lse and delta of the tree's own forward. Each point prints one JSON line
with the card's name and power limit, its ms and the bound of its shape
(``chip_smoke.flash_bytes_ops``), and the errors against the tree's
plain versions: the norm error of out, dQ, dK and dV and the largest
absolute error of lse. At every shape each turn also times PyTorch's
fused attention, forward and backward (``chip_smoke.sdpa_yardstick``:
each backend pinned in turn, the fastest kept), as a yardstick.

Usage (needs CUDA):

- ``python3 scripts/port_flash_bwd_ab.py`` times this checkout;
- ``python3 scripts/port_flash_bwd_ab.py --against DIR`` times DIR's
  kernels (another checkout's root, e.g. the parent commit unpacked by
  ``git archive``) and this checkout's in turns (DIR, this, this, DIR),
  each in a process of its own;
- ``--lm-step`` adds, after each turn's kernel points, phase 5 of that
  tree's own ``chip_smoke.py`` (``train_phase``: the seq-8192 LM, 4
  steps, 16 forward launches a step, its launch checks the tree's) run
  on that tree's package, and prints its step ms on a JSON line;
- ``--rows`` adds, after each turn's kernel points, the forward's round
  costs at the non-causal timed shapes: ``flash_fwd`` with its items
  forced to 192 and to 64 q rows (``flash_tile`` patched in the
  wrapper), timed in the order 192, 64, 64, 192, and each geometry's
  fastest time over the rounds its grid takes
  (``ops/autotune.py:forward_rounds``' item and block counts on the
  card's SMs) gives a round's cost. The ratio of a 192-row round's to a
  64-row round's is ``FWD_ROUNDS``' relative cost; one JSON line a
  shape.
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
SHAPES = {"lm": ((2, 8192, 16, 64), True),
          "bert": ((16, 512, 12, 64), False),
          "predict_b8": ((8, 512, 12, 64), False),
          "predict_b1": ((1, 128, 12, 64), False)}


def _smoke(root: str = ROOT):
    """A checkout's ``chip_smoke`` (this one's by default: inputs, bounds
    and timing), loaded by path: with ``--tree`` the package on
    ``sys.path`` is another's."""
    spec = importlib.util.spec_from_file_location(
        "port_flash_bwd_ab_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _points(tree: str) -> None:
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    one_pass = hasattr(fa, "flash_bwd")
    for label, ((B, S, H, D), causal) in SHAPES.items():
        q, k, v, g, _ = smoke.flash_inputs(B, S, H, D, torch.bfloat16, dev,
                                           smoke.SEED + 1, False)
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        delta = fa.flash_delta(g, out)
        if one_pass:
            got = (out, *fa.flash_bwd(q, k, v, g, lse, delta,
                                      causal=causal))
        else:
            got = (out, fa.flash_bwd_dq(q, k, v, g, lse, delta,
                                        causal=causal),
                   *fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal))
        plain = smoke.over_heads(
            lambda q, k, v, g, lse, delta: (
                *fa.flash_fwd_plain(q, k, v, causal=causal),
                fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal),
                *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta,
                                        causal=causal)),
            q, k, v, g, lse, delta, 4)
        errs = {name: smoke.norm_err(a, b) for name, a, b in zip(
            ("out", "dq", "dk", "dv"), got, plain[:1] + plain[2:])}
        errs["lse_abs"] = (lse - plain[1]).abs().max().item()
        del got, plain
        ms = {"flash_fwd": smoke.time_ms(
                  lambda: fa.flash_fwd(q, k, v, causal=causal))}
        if one_pass:
            ms["flash_bwd"] = smoke.time_ms(lambda: fa.flash_bwd(
                q, k, v, g, lse, delta, causal=causal))
        else:
            ms["flash_bwd_dq"] = smoke.time_ms(lambda: fa.flash_bwd_dq(
                q, k, v, g, lse, delta, causal=causal))
            ms["flash_bwd_dkv"] = smoke.time_ms(lambda: fa.flash_bwd_dkv(
                q, k, v, g, lse, delta, causal=causal))
            ms["flash_bwd"] = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
        work = smoke.flash_bytes_ops(B, S, H, D, 2, causal)
        for name, t in ms.items():
            nbytes, flops = work[name]
            bound = max(nbytes / smoke.HBM_BYTES_PER_S,
                        flops / smoke.BF16_FLOPS) * 1e3
            print(json.dumps({"device": ident, "tree": tree, "shape": label,
                              "kernel": name, "kernel_ms": t,
                              "bound_ms": bound, "norm_err": errs}),
                  flush=True)
        lib = smoke.sdpa_yardstick(q, k, v, g, causal=causal)
        print(json.dumps({"device": ident, "tree": tree, "shape": label,
                          "library": "scaled_dot_product_attention",
                          "forward_ms": lib["flash_fwd"][0],
                          "forward_backend": lib["flash_fwd"][1],
                          "backward_ms": lib["backward"][0],
                          "backend": lib["backward"][1]}), flush=True)
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()


def _round_costs(tree: str) -> None:
    import torch

    from kubeflow_tpu_torch.ops import autotune
    from kubeflow_tpu_torch.ops import flash_attention as fa

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    sms = autotune.sm_count(dev)
    real = fa.flash_tile
    for label, ((B, S, H, D), causal) in SHAPES.items():
        if causal:
            continue
        q, k, v, _, _ = smoke.flash_inputs(B, S, H, D, torch.bfloat16, dev,
                                           smoke.SEED + 1, False)
        ms = {192: [], 64: []}
        try:
            for rows in (192, 64, 64, 192):
                fa.flash_tile = lambda *a, _r=rows, **kw: (_r, 64)
                ms[rows].append(smoke.time_ms(
                    lambda: fa.flash_fwd(q, k, v, causal=False)))
        finally:
            fa.flash_tile = real
        rounds = {rows: -(-B * H * -(-S // rows)
                          // (autotune.FWD_ROUNDS[rows][0] * sms))
                  for rows in ms}
        cost = {rows: min(ms[rows]) / rounds[rows] for rows in ms}
        print(json.dumps({"device": smoke.gpu_identity(), "tree": tree,
                          "shape": label, "sms": sms, "ms": ms,
                          "rounds": rounds, "round_ms": cost,
                          "relative_192": cost[192] / cost[64]}),
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def _lm_step(tree: str) -> None:
    import torch

    smoke = _smoke(tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        train = smoke.train_phase(torch.device("cuda", 0))
    except smoke.SmokeFailure as e:   # one of the phase's checks; go on
        print(json.dumps({"device": smoke.gpu_identity(), "tree": tree,
                          "phase": 5, "error": str(e)}), flush=True)
        return
    print(json.dumps({"device": smoke.gpu_identity(), "tree": tree,
                      "phase": 5, "step_ms": train["step_ms"],
                      "mean_step_ms": train["mean_step_ms"],
                      "launches": train["launches"]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time DIR's kernels and this one's in turns")
    ap.add_argument("--tree", metavar="DIR",
                    help="time DIR's kernels only (one turn of --against)")
    ap.add_argument("--lm-step", action="store_true",
                    help="also run phase 5's LM steps in each turn")
    ap.add_argument("--rows", action="store_true",
                    help="also time the forward's round costs in each turn")
    args = ap.parse_args()
    extra = (["--lm-step"] if args.lm_step else []) + (
        ["--rows"] if args.rows else [])
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    if args.against:
        other = os.path.abspath(args.against)
        for tree in (other, ROOT, ROOT, other):
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--tree", tree, *extra]).returncode
            if rc:
                return rc
        return 0
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    _points(args.tree or ROOT)
    if args.rows:
        _round_costs(args.tree or ROOT)
    if args.lm_step:
        _lm_step(args.tree or ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
