#!/usr/bin/env python3
"""The port's paged decode kernel timed on one GPU: over split sizes, or
against another checkout's kernel.

``kubeflow_tpu_torch/ops/csrc/paged_attention.cu`` splits each row's
live pages into blocks of ``split_tokens`` keys, from the tile table
(``ops/autotune.py``; a sweep point pins it with a table row for every
shape). A faster split is a finding for ``PERF.md``, not a table edit
here. Every point is
timed with ``chip_smoke.time_ms`` (CUDA events, cold L2, device time
only) at ``chip_smoke.py``'s two timed shapes of the serving model (B=8,
QH=KH=16, Dh=64, page 64, 32 logical pages, bf16): phase 2's ragged rows
up to the full 2048-token context, and phase 3's serving lengths
(positions 251-363). Prints one JSON line per point, with the card's
name and power limit and the bound of its shape (live K/V bytes over
3.35 TB/s), and one for the floor of the timing itself: ``time_ms`` of
a one-element fill, a launch that moves nothing.

With ``--against`` (or ``--tree``) it also times phase 2's rows at GQA
16/4, at f32 (QH=KH 16 and 16/4), Dh 96 and a GQA group of 16 (the
shapes ``paged_decode_kernel`` keeps), and phase 23's replicated kv-head
slices (``chip_smoke.replicated_kv_times``).

Usage (needs CUDA):

- ``python3 scripts/port_paged_sweep.py`` sweeps the split size;
- ``python3 scripts/port_paged_sweep.py --against DIR`` times DIR's
  kernel (another checkout's root, e.g. the parent commit unpacked by
  ``git archive``) and this checkout's at their own split sizes, in
  turns (DIR, this, this, DIR), each in a process of its own.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _smoke():
    """This checkout's ``chip_smoke`` (inputs, bounds and timing), loaded
    by path: with ``--tree`` the package on ``sys.path`` is another's."""
    spec = importlib.util.spec_from_file_location(
        "port_paged_sweep_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _split(pa, split):
    """Run the paged kernel at ``split`` keys a block (None: the tree's
    own choice). A tree from before the tile table keeps its split in
    ``_SPLIT_TOKENS``."""
    if split is None:
        yield
        return
    if hasattr(pa, "_SPLIT_TOKENS"):
        default = pa._SPLIT_TOKENS
        pa._SPLIT_TOKENS = split
        try:
            yield
        finally:
            pa._SPLIT_TOKENS = default
        return
    from kubeflow_tpu_torch.ops import autotune

    row = {"kernel": "paged_attn", "generation": "*", "dtype": "*",
           "split_tokens": split}
    with autotune.table_override(autotune.TileTable([row], [])):
        yield


def _own_split(pa, q, KH, ps, n_log) -> int:
    """Keys a block of the tree's own choice takes at this shape."""
    if hasattr(pa, "_SPLIT_TOKENS"):
        return pa._SPLIT_TOKENS
    from kubeflow_tpu_torch.ops import autotune

    return autotune.resolve_paged(
        max_seq_len=n_log * ps, page_size=ps, n_heads=q.shape[1],
        n_kv_heads=KH, head_dim=q.shape[2], dtype=q.dtype,
        generation=autotune.backend_generation(q.device)).split_tokens


def _points(splits, tree):
    import torch

    from kubeflow_tpu_torch.ops import paged_attention as pa

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    one = torch.empty(1, device=dev)
    print(json.dumps({"device": ident, "tree": tree, "shape": "floor",
                      "kernel_ms": smoke.time_ms(one.zero_)}), flush=True)
    shapes = [(shape, make, 16) for shape, make in smoke.PAGED_SHAPES.items()]
    shapes.append(("phase2_gqa", smoke.paged_inputs, 4))
    for shape, make, KH in shapes:
        q, k, v, pages, pos, P = make(8, 16, KH, 64, 64, 32,
                                      torch.bfloat16, dev,
                                      seed=smoke.SEED + 32)
        want = pa.paged_decode_attention_plain(q, k, v, pages, pos)
        nbytes, _ = smoke.paged_bytes_ops(q, k, pages, pos, P, 64)
        for split in splits or (None,):
            with _split(pa, split):
                got = pa.paged_decode_attention(q, k, v, pages, pos)
                err = (got.float() - want.float()).abs().max().item()
                ms = smoke.time_ms(
                    lambda: pa.paged_decode_attention(q, k, v, pages, pos))
            print(json.dumps({
                "device": ident, "tree": tree, "shape": shape, "KH": KH,
                "split_tokens": split or _own_split(pa, q, KH, 64, 32),
                "kernel_ms": ms,
                "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3,
                "max_abs_err": err}), flush=True)
    if not splits:
        # phase 2's rows on the kernel of the other shapes
        # (paged_decode_kernel): f32, Dh 96, a GQA group of 16
        for label, QH, KH, Dh, dtype in (
                ("f32", 16, 16, 64, torch.float32),
                ("f32_gqa", 16, 4, 64, torch.float32),
                ("dh96_bf16", 16, 16, 96, torch.bfloat16),
                ("gqa16_bf16", 32, 2, 64, torch.bfloat16)):
            q, k, v, pages, pos, P = smoke.paged_inputs(
                8, QH, KH, Dh, 64, 32, dtype, dev, seed=smoke.SEED + 32)
            nbytes, _ = smoke.paged_bytes_ops(q, k, pages, pos, P, 64)
            print(json.dumps({
                "device": ident, "tree": tree, "shape": f"phase2_{label}",
                "KH": KH, "kernel_ms": smoke.time_ms(
                    lambda: pa.paged_decode_attention(q, k, v, pages, pos)),
                "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3}),
                flush=True)
        # phase 23's replicated kv heads at serving rows, at the tree's
        # own split
        for r in smoke.replicated_kv_times(dev):
            print(json.dumps({
                "device": ident, "tree": tree, "shape": "replicated",
                **{key: r[key] for key in ("H", "KH", "tp", "kv_heads",
                                           "q_heads", "ms", "bound_ms",
                                           "max_abs_err")}}), flush=True)


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
    _points(None if args.tree else (64, 128, 256, 512, 1024),
            args.tree or ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
