#!/usr/bin/env python3
"""Where a call of the fused flash backward spends its time, on one GPU.

No profiler counters work on the card's machine, so this builds a copy
of ``kubeflow_tpu_torch/ops/csrc/flash_attention.cu`` with
``%globaltimer`` (the card's nanosecond clock, 32 ns steps) stamped at
fixed points of every block of ``flash_bwd_wgmma_kernel`` into a
``__device__`` array, loads it in place of the package's library, and
runs ``flash_bwd`` at ``chip_smoke.py``'s timed shapes (the LM's
(2, 8192, 16, 64) causal and BERT's (16, 512, 12, 64)) after the same
128 MB flush ``chip_smoke.time_ms`` runs before each timed call. The
stamps, each block's (its two adder warps', which add the block's dQ
partials in their fixed order):

- ``first_add_us``: the block's first add issued, from its start;
- ``wait_us``: the time its adds spent waiting for their turn (the
  counter of their head and q tile), summed, and ``waited``: how many
  of its adds found the turn not yet come;
- ``end_us``: the block's adders done, from the earliest block's start;
- ``items`` and ``adds``: the items it took and the adds it made;
- ``consumer``: per warpgroup (its first thread's clock, medians over
  the blocks, µs summed over the block's live tiles): waiting for a
  stage (``stage``), for its turn at S and dP (``turn``), for dV's
  products (``dv``), warpgroup 1 for both dS halves before dQ
  (``ds_barrier``), for dQ's issue and dK's products (``dk``) and for
  dQ's products (``dq``), each for its buffer (``dq_buffer``: warpgroup
  0 for the dS buffer's last dQ, warpgroup 1 for the adder's buffer), and
  ``tiles``.

Prints one JSON line per shape with the medians over the blocks (and
the last ``end_us``, the waits' share of the blocks' time, the most any
block waited), the grid, and the card's name and power limit. The
instrumented copy is built into the git-ignored
``kubeflow_tpu_torch/_build/timeline/``; the package's own library is
not touched.

Usage (needs CUDA): ``python3 scripts/port_flash_bwd_timeline.py``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

MAX_BLOCKS, SLOTS = 1024, 24
# the consumer spans (slots 8 + 8 wg + k)
SPANS = ("stage", "turn", "dv", "ds_barrier", "dk", "dq", "dq_buffer",
         "tiles")


def _span(k: int, anchor: str) -> tuple:
    """Time ``anchor`` on each consumer warpgroup's first thread into
    span ``k``'s slot (``tiles`` counts instead)."""
    slot = f"kftpu_stamp[blockIdx.x][8 + 8 * wg + {k}]"
    return (anchor, f"        const unsigned long long tc{k} = gtime();\n",
            f"        if (threadIdx.x % kWG == 0) {slot} += gtime() - tc{k};\n")


# (anchor in the fused kernel's source, text put before it, text put
# after it): slot 0 entry, 1 first add, 2 ns waited, 3 adds that
# waited, 4 end, 5 adds, 6 items, 7 the grid; 8.. the consumer spans
STAMPS = [
    ("template <int D>\n__global__ void __launch_bounds__(kWgThreads, 1)\n"
     "    flash_bwd_wgmma_kernel(",
     "__device__ unsigned long long kftpu_stamp"
     f"[{MAX_BLOCKS}][{SLOTS}];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n\n", ""),
    ("    mbar_init(res_empty, 8);\n", "",
     "    kftpu_stamp[blockIdx.x][0] = gtime();\n"),
    ("            if (turn > 0) {\n"
     "              while (ld_acquire(count) != turn) {\n"
     "              }\n",
     "            const unsigned long long t_w0 = gtime();\n"
     "            const bool at_turn = turn <= 0 || "
     "ld_acquire(count) == turn;\n",
     "              atomicAdd(&kftpu_stamp[blockIdx.x][2],\n"
     "                        gtime() - t_w0);\n"
     "              if (!at_turn)\n"
     "                atomicAdd(&kftpu_stamp[blockIdx.x][3], 1ull);\n"),
    ("            bulk_commit();\n            bulk_wait_read();\n"
     "            mbar_arrive(dq_empty(buf));\n",
     "            atomicMin(&kftpu_stamp[blockIdx.x][1], gtime());\n"
     "            atomicAdd(&kftpu_stamp[blockIdx.x][5], 1ull);\n", ""),
    ("        __syncwarp();\n"
     "        if (lane == 0) mbar_arrive(item_empty(n & 1));\n"
     "        if (x < 0) break;\n",
     "        if (lane == 0 && x < 0) {\n"
     "          atomicMax(&kftpu_stamp[blockIdx.x][4], gtime());\n"
     "          kftpu_stamp[blockIdx.x][7] = gridDim.x;\n"
     "        }\n"
     "        if (lane == 0 && x >= 0 && buf == 0)\n"
     "          kftpu_stamp[blockIdx.x][6] += 1;\n",
     ""),
    _span(0, "        mbar_wait(full(s), (it / kWgStages) & 1);\n"
             "        const uint32_t qa = ring + s * 2 * kBox, ga = qa + kBox;\n"),
    _span(1, "        float sT[32], dpT[32];\n        turn_begin();\n"),
    _span(2, "        wgmma_wait<1>();\n        fence_regs(fresh_v);\n"),
    ("      bar_sync(kDsBar, kWG);\n"
     "      mbar_wait(ds_full(tq & 1), (tq >> 1) & 1);\n",
     "      const unsigned long long tc3 = gtime();\n",
     "      if (tw == 0) kftpu_stamp[blockIdx.x][8 + 8 * wg + 3] += "
     "gtime() - tc3;\n"),
    _span(4, "          dq_begin(fq, tq);\n          wgmma_wait<1>();\n"),
    _span(5, "          release(s);\n          wgmma_wait<0>();\n"),
    ("      mbar_wait(dq_empty(buf), ((tq / kDqBufs) & 1) ^ 1);\n",
     "      const unsigned long long tc6 = gtime();\n",
     "      if (tw == 0) kftpu_stamp[blockIdx.x][8 + 8 * wg + 6] += "
     "gtime() - tc6;\n"),
    ("      if (wg == 0) mbar_wait(ds_free(x), ((tq >> 1) & 1) ^ 1);\n",
     "      const unsigned long long tc6 = gtime();\n",
     "      if (tw == 0) kftpu_stamp[blockIdx.x][8 + 8 * wg + 6] += "
     "gtime() - tc6;\n"),
    ("        const float* st = stats_gen + s * kStatStride;\n"
     "        const int q0 = i * kWgStep;\n", "",
     "        if (tw == 0) kftpu_stamp[blockIdx.x][8 + 8 * wg + 7] += 1;\n"),
]


def instrumented_source(src: str) -> str:
    """``src`` with the stamps of the module docstring inserted; raises
    if an anchor is not found exactly once (the kernel changed: update
    the anchors)."""
    for anchor, before, after in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + (
        '\nextern "C" int kftpu_flash_bwd_stamps(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, kftpu_stamp,\n"
        "                                   sizeof kftpu_stamp);\n}\n"
        '\nextern "C" int kftpu_flash_bwd_stamps_reset(const void* zeros) {\n'
        "  return (int)cudaMemcpyToSymbol(kftpu_stamp, zeros,\n"
        "                                 sizeof kftpu_stamp);\n}\n")


def build() -> str:
    from kubeflow_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "timeline")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = instrumented_source(f.read())
    cu = os.path.join(out_dir, "flash_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    shutil.copy(os.path.join(_build.CSRC, "hopper.cuh"), out_dir)
    so = os.path.join(out_dir, "libflash_bwd_timeline.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return so


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    spec = importlib.util.spec_from_file_location(
        "port_flash_bwd_timeline_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = ctypes.CDLL(build())
    lib.kftpu_flash_bwd_stamps.argtypes = [ctypes.c_void_p]
    lib.kftpu_flash_bwd_stamps_reset.argtypes = [ctypes.c_void_p]
    _build._libs["flash_attention"] = lib      # the wrapper's library
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    zeros = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
    zeros[:, 1] = np.iinfo(np.uint64).max     # the first add: a minimum
    for label, ((B, S, H, D), causal) in (("lm", ((2, 8192, 16, 64), True)),
                                          ("bert", ((16, 512, 12, 64),
                                                    False))):
        q, k, v, g, _ = smoke.flash_inputs(B, S, H, D, torch.bfloat16, dev,
                                           smoke.SEED + 1, False)
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        delta = fa.flash_delta(g, out)
        for _ in range(3):
            fa.flash_bwd(q, k, v, g, lse, delta, causal=causal)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            rc = lib.kftpu_flash_bwd_stamps_reset(zeros.ctypes.data)
            if rc:
                raise RuntimeError(f"cudaMemcpyToSymbol: {rc}")
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            fa.flash_bwd(q, k, v, g, lse, delta, causal=causal)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
            rc = lib.kftpu_flash_bwd_stamps(buf.ctypes.data)
            if rc:
                raise RuntimeError(f"cudaMemcpyFromSymbol: {rc}")
            grid = int(buf[:, 7].max())
            b = buf[:grid]
            b = b[b[:, 5] > 0].astype(np.int64)   # the blocks that added
            t0 = b[:, 0].min()
            span = (b[:, 4] - b[:, 0]).astype(np.float64)
            runs.append({
                "first_add_us": float(np.median(b[:, 1] - b[:, 0]) / 1e3),
                "wait_us": float(np.median(b[:, 2]) / 1e3),
                "wait_max_us": float(b[:, 2].max() / 1e3),
                "wait_share": float(b[:, 2].sum() / span.sum()),
                "waited": float(np.median(b[:, 3])),
                "waited_total": int(b[:, 3].sum()),
                "end_us": float(np.median(b[:, 4] - t0) / 1e3),
                "last_end_us": float((b[:, 4].max() - t0) / 1e3),
                "items": float(np.median(b[:, 6])),
                "adds": float(np.median(b[:, 5])),
                "adds_total": int(b[:, 5].sum()), "grid": grid,
                "blocks": len(b),
                **{f"wg{wg}_{name}": float(np.median(
                    b[:, 8 + 8 * wg + k]) / (1 if name == "tiles" else 1e3))
                   for wg in (0, 1) for k, name in enumerate(SPANS)}})
        print(json.dumps({"device": ident, "shape": label, "B": B, "S": S,
                          "H": H, "causal": causal, **{key: float(np.median(
                              [r[key] for r in runs])) for key in runs[0]}}),
              flush=True)
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
