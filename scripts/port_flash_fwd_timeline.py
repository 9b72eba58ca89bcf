#!/usr/bin/env python3
"""Where a call of the bf16 D = 64 flash forward spends its time, on one GPU.

No profiler counters work on the card's machine, so this builds a copy
of a checkout's ``kubeflow_tpu_torch/ops/csrc/flash_attention.cu`` with
``%globaltimer`` (the card's nanosecond clock, 32 ns steps) read around
fixed points of ``flash_fwd_wgmma_kernel``'s consumer warpgroups, summed
into a ``__device__`` array by block and warpgroup (each warpgroup's
first thread), loads it in place of that checkout's library, and runs
``flash_fwd`` at ``chip_smoke.py``'s LM shape ((2, 8192, 16, 64),
causal) after the same 128 MB flush ``chip_smoke.time_ms`` runs before
each timed call. The kernel is the persistent design: three consumer
warpgroups, 192 q rows an item, the next stage's S in flight under this
stage's softmax. Per warpgroup, summed over a block's stages:

- ``stage``: waiting for a stage's K and V (the ring's full barrier);
- ``s_wait``: waiting for S = Q.K^T to land;
- ``softmax``: the online softmax (max, exponentials, sums);
- ``pv_wait``: waiting for P.V to land;
- ``o_update``: O = O * alpha + P.V and the next P's rounding;
- ``stages``: the stages it computed.

Prints one JSON line per warpgroup with the medians over the blocks of
each span (µs), each span's mean per stage (ns), the grid, and the
card's name and power limit. The instrumented copy is built into the
git-ignored ``kubeflow_tpu_torch/_build/timeline/`` of the checkout it
instruments; that checkout's own library is not touched.

Usage (needs CUDA): ``python3 scripts/port_flash_fwd_timeline.py``
(this checkout) or ``--tree DIR`` (another checkout of the same design,
e.g. one unpacked by ``git archive``, to compare a change with it).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

MAX_BLOCKS, WGS, PER_WG = 4096, 3, 8
SLOTS = WGS * PER_WG
SPANS = ("stage", "s_wait", "softmax", "pv_wait", "o_update", "stages")
SHAPE = (2, 8192, 16, 64)

PRELUDE = f"""
__device__ unsigned long long kftpu_stamp[{MAX_BLOCKS}][{SLOTS}];
__device__ __forceinline__ unsigned long long kftpu_gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
// slot k of this block's warpgroup (its first thread adds)
#define KFTPU_ADD(k, v)                                                  \\
  if (threadIdx.x % 128 == 0)                                            \\
    kftpu_stamp[blockIdx.x + gridDim.x * blockIdx.y]                     \\
               [{PER_WG} * (threadIdx.x / 128) + (k)] += (v)
"""


def _k(name: str) -> int:
    return SPANS.index(name)


def _span(name: str, target: str, after: str = "",
          count: bool = False) -> tuple:
    """``target`` (whole statements, followed in the source by
    ``after``, which tells it from a like one) timed into span ``name``;
    with ``count`` the stage counter goes up by one too."""
    extra = f"  KFTPU_ADD({_k('stages')}, 1ull);\n" if count else ""
    new = ("{ const unsigned long long kftpu_t = kftpu_gtime();\n" + target
           + f"  KFTPU_ADD({_k(name)}, kftpu_gtime() - kftpu_t);\n" + extra
           + "}\n")
    return target + after, new + after


STAMPS = [
    _span("stage", "        mbar_wait(full(slot(j)), "
                   "((it0 + j - j_lo) / kStages) & 1);\n"),
    _span("s_wait", "        wgmma_wait<0>();\n        fence_regs(sc);\n"),
    _span("softmax", "        softmax(alpha, j);\n"),
    _span("s_wait", "          wgmma_wait<1>();\n          fence_regs(sc);\n"),
    _span("softmax", "          softmax(alpha_next, j + 1);\n"),
    _span("pv_wait", "          wgmma_wait<0>();\n          fence_regs(pv);\n"),
    _span("o_update", "          add_pv(alpha, j);\n"
                      "          fwd_pack(sc, pf);\n", count=True),
    _span("pv_wait", "        wgmma_wait<0>();\n        fence_regs(pv);\n",
          "        add_pv(alpha, j);\n        ++j;\n"),
    _span("o_update", "        add_pv(alpha, j);\n", "        ++j;\n",
          count=True),
]
def instrumented_source(src: str) -> str:
    """``src`` with the stamps: each anchor must occur exactly once in
    the forward kernel's body (the kernel changed otherwise: update the
    anchors)."""
    start = src.index("flash_fwd_wgmma_kernel(")
    end = src.index("\n}\n", start)
    body = src[start:end]
    for anchor, new in STAMPS:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        body = body.replace(anchor, new)
    head = src.index("namespace {")
    src = src[:head] + PRELUDE + src[head:start] + body + src[end:]
    return src + (
        '\nextern "C" int kftpu_flash_fwd_stamps(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, kftpu_stamp,\n"
        "                                   sizeof kftpu_stamp);\n}\n"
        '\nextern "C" int kftpu_flash_fwd_stamps_reset(const void* zeros) {\n'
        "  return (int)cudaMemcpyToSymbol(kftpu_stamp, zeros,\n"
        "                                 sizeof kftpu_stamp);\n}\n")


def build(tree: str) -> str:
    from kubeflow_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "timeline")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(tree, "kubeflow_tpu_torch", "ops", "csrc")
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        src = instrumented_source(f.read())
    cu = os.path.join(out_dir, "flash_attention_fwd.cu")
    with open(cu, "w") as f:
        f.write(src)
    shutil.copy(os.path.join(csrc, "hopper.cuh"), out_dir)
    so = os.path.join(out_dir, "libflash_fwd_timeline.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", metavar="DIR", default=ROOT,
                    help="the checkout whose kernel and wrapper to run")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    spec = importlib.util.spec_from_file_location(
        "port_flash_fwd_timeline_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    so = build(tree)
    lib = ctypes.CDLL(so)
    lib.kftpu_flash_fwd_stamps.argtypes = [ctypes.c_void_p]
    lib.kftpu_flash_fwd_stamps_reset.argtypes = [ctypes.c_void_p]
    _build._libs["flash_attention"] = lib      # the wrapper's library
    fa._lib()
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    zeros = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
    B, S, H, D = SHAPE
    q, k, v, _, _ = smoke.flash_inputs(B, S, H, D, torch.bfloat16, dev,
                                       smoke.SEED + 1, False)
    for _ in range(3):
        fa.flash_fwd(q, k, v, causal=True)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        if lib.kftpu_flash_fwd_stamps_reset(zeros.ctypes.data):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        fa.flash_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        buf = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
        if lib.kftpu_flash_fwd_stamps(buf.ctypes.data):
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        runs.append(buf.astype(np.int64))
    for wg in range(WGS):
        per_run = []
        for buf in runs:
            b = buf[:, PER_WG * wg:PER_WG * (wg + 1)]
            b = b[b[:, _k("stages")] > 0]
            if not len(b):
                break
            n = b[:, _k("stages")].sum()
            per_run.append({"blocks": len(b),
                            "stages": float(np.median(b[:, _k("stages")])),
                            **{f"{name}_us": float(np.median(
                                b[:, _k(name)]) / 1e3)
                               for name in SPANS if name != "stages"},
                            **{f"{name}_ns_a_stage": float(
                                b[:, _k(name)].sum() / n)
                               for name in SPANS if name != "stages"}})
        if not per_run:
            continue
        print(json.dumps({"device": ident, "tree": tree,
                          "shape": list(SHAPE), "causal": True,
                          "warpgroup": wg, **{
                              key: float(np.median([r[key] for r in per_run]))
                              for key in per_run[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
