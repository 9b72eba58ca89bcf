#!/usr/bin/env python3
"""Where a call of the paged TMA kernel spends its time, on one GPU.

No profiler counters work on the card's machine, so this builds a copy
of ``kubeflow_tpu_torch/ops/csrc/paged_attention.cu`` with
``%globaltimer`` (the card's nanosecond clock, 32 ns steps) stamped at
fixed points of every block of ``paged_decode_tma_kernel`` into a
``__device__`` array, loads it in place of the package's library, and
runs the wrapper at ``chip_smoke.py``'s shapes after the same 128 MB
flush ``chip_smoke.time_ms`` runs before each timed call. The stamps,
each block's from its own start:

- ``list_us``: the work list built (positions and page ids read, the
  units counted and ordered);
- ``first_issue_us``: the producer's first K and V boxes issued;
- ``first_data_us``: the consumers' first stage landed;
- ``first_unit_us``: the block's first unit's stages consumed;
- ``end_us`` (from the earliest block's start): the block done.

Prints one JSON line per shape with the medians over the blocks that
took work (``end_us``: median and last), the stages a block consumed,
the grid, and the card's name and power limit. The instrumented copy is
built into the git-ignored ``kubeflow_tpu_torch/_build/timeline/``; the
package's own library is not touched.

Usage (needs CUDA): ``python3 scripts/port_paged_timeline.py``.
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

MAX_BLOCKS, SLOTS = 1024, 8
# (anchor in the TMA kernel's source, text put before it, text put after
# it): slot 0 entry, 1 list, 2 first issue, 3 first data, 4 first unit,
# 5 end; 6 the stages the block consumed, 7 the grid
STAMPS = [
    ("  const int group = QH / KH;\n  if (tid == kConsumers) {",
     "  if (threadIdx.x == 0) kftpu_stamp[blockIdx.x][0] = gtime();\n", ""),
    ("  const int n_units = (n_full + s_misc[3]) * KH;\n", "",
     "  if (tid == 0) kftpu_stamp[blockIdx.x][1] = gtime();\n"),
    ("              hopper::tma_load_3d(dst + kTile, &map_v, full(s), 0, kh,\n"
     "                                  pg * ps + t);\n", "",
     "              if (it == 0) kftpu_stamp[blockIdx.x][2] = gtime();\n"),
    ("      hopper::mbar_wait(full(s), (it / kStages) & 1);\n"
     "      const int4 mt = meta[s];\n", "",
     "      if (tid == 0 && it == 0) kftpu_stamp[blockIdx.x][3] = gtime();\n"),
    ("    // fold the lane groups: within the warp (the lanes of one "
     "chunk),\n",
     "    if (tid == 0 && round == 0) kftpu_stamp[blockIdx.x][4] = gtime();\n",
     ""),
    ("    if (tid == 0) counters[ub] = 0u;  // ready for the next call\n"
     "  }\n", "",
     "  if (tid == 0) {\n"
     "    kftpu_stamp[blockIdx.x][5] = gtime();\n"
     "    kftpu_stamp[blockIdx.x][6] = it;\n"
     "    kftpu_stamp[blockIdx.x][7] = gridDim.x;\n"
     "  }\n"),
    ("bool tma_route(int group, int Dh, int el) {",
     "__device__ unsigned long long kftpu_stamp"
     f"[{MAX_BLOCKS}][{SLOTS}];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n\n", ""),
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
        '\nextern "C" int kftpu_paged_stamps(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, kftpu_stamp,\n"
        "                                   sizeof kftpu_stamp);\n}\n")


def build() -> str:
    from kubeflow_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "timeline")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "paged_attention.cu")) as f:
        src = instrumented_source(f.read())
    cu = os.path.join(out_dir, "paged_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    shutil.copy(os.path.join(_build.CSRC, "hopper.cuh"), out_dir)
    so = os.path.join(out_dir, "libpaged_timeline.so")
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
    from kubeflow_tpu_torch.ops import paged_attention as pa

    spec = importlib.util.spec_from_file_location(
        "port_paged_timeline_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = ctypes.CDLL(build())
    lib.kftpu_paged_stamps.argtypes = [ctypes.c_void_p]
    _build._libs["paged_attention"] = lib      # the wrapper's library
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    shapes = [("phase2", smoke.paged_inputs, 16, 16),
              ("serving", smoke.paged_serving_inputs, 16, 16),
              ("phase2_gqa", smoke.paged_inputs, 16, 4),
              # phase 23's first replicated case's work: 4 q heads over
              # one kv head at serving rows
              ("serving_1kv", smoke.paged_serving_inputs, 4, 1)]
    for shape, make, QH, KH in shapes:
        q, k, v, pages, pos, P = make(8, QH, KH, 64, 64, 32,
                                      torch.bfloat16, dev,
                                      seed=smoke.SEED + 32)
        for _ in range(3):
            pa.paged_decode_attention(q, k, v, pages, pos)
        runs = []
        for _ in range(5):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            pa.paged_decode_attention(q, k, v, pages, pos)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
            rc = lib.kftpu_paged_stamps(buf.ctypes.data)
            if rc:
                raise RuntimeError(f"cudaMemcpyFromSymbol: {rc}")
            b = buf[:int(buf[0, 7])].astype(np.int64)
            used = b[:, 6] > 0
            rel = (b[used] - b[used, :1]) / 1e3

            def med(i, rel=rel):
                return float(np.median(rel[:, i]))

            t0 = b[:, 0].min()
            runs.append({
                "list_us": med(1), "first_issue_us": med(2),
                "first_data_us": med(3), "first_unit_us": med(4),
                "end_us": float(np.median(b[used, 5] - t0) / 1e3),
                "last_end_us": float((b[used, 5].max() - t0) / 1e3),
                "stages": float(np.median(b[used, 6])),
                "blocks": int(used.sum()), "grid": int(b[0, 7])})
        print(json.dumps({"device": ident, "shape": shape, "QH": QH,
                          "KH": KH, **{key: float(np.median(
                              [r[key] for r in runs])) for key in runs[0]}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
