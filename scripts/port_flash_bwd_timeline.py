#!/usr/bin/env python3
"""Where a call of the fused flash backward spends its time, on one GPU.

No profiler counters work on the card's machine, so this builds a copy
of ``kubeflow_tpu_torch/ops/csrc/flash_attention.cu`` with
``%globaltimer`` (the card's nanosecond clock, 32 ns steps) stamped at
fixed points of every block of ``flash_bwd_wgmma_kernel`` into
``__device__`` arrays, loads it in place of the package's library, and
runs ``flash_bwd`` at ``chip_smoke.py``'s timed shapes (the LM's
(2, 8192, 16, 64) causal and BERT's (16, 512, 12, 64)) after the same
128 MB flush ``chip_smoke.time_ms`` runs before each timed call. The
stamps, each block's:

- the adders (the producer warpgroup's warps that add the block's dQ
  partials in their fixed order): ``first_add_us``, the first add
  issued from the block's start; ``wait_us``, the time the adds spent
  waiting for their turn (the counter of their head and q tile),
  summed, and ``waited``, how many found the turn not yet come;
  ``end_us``, the adders done from the earliest block's start;
  ``items`` and ``adds``;
- per consumer warpgroup (its first thread's clock; medians over the
  blocks, reported in µs a live tile; ``tiles`` counts them): the waits
  for a stage (``stage``), for the next tile's S^T and dP^T (``sdp``,
  issued at the end of this one), for dV's products (``dv``), for dK's
  (``dk``), for the other warpgroup's dS^T half (``ds``: the owner of
  the tile's dQ), for dQ's products (``dq``: the owner's), for buffers
  (``buffer``: the dS^T buffer's last dQ, the adder's dQ buffer), and
  ``issue``: the tile's time less those waits, the warpgroup issuing
  element-wise work and products. ``kv_us`` (µs an item): the wait for
  the item's K and V, which load once the previous item's last
  products are done; ``item_us``: an item's time, taken to consumed;
- ``heads``: the (batch, head) pairs whose items are in flight at once
  over the grid, the most and the median over the items' starts (each
  head's f32 dQ workspace is S x 64 x 4 bytes, 2 MB at the LM's S).

With ``--tree DIR`` the kernel of another checkout (its
``kubeflow_tpu_torch/ops/csrc/``) is instrumented instead, with the
stamps its source shares with this one (the adders, the items, K and
V, the heads); the per-tile spans follow this checkout's kernel and are
left out. Prints one JSON line per shape with the medians over the
blocks and five calls, the grid, and the card's name and power limit.
The instrumented copy is built into the git-ignored
``kubeflow_tpu_torch/_build/timeline/``; the package's own library is
not touched.

Usage (needs CUDA): ``python3 scripts/port_flash_bwd_timeline.py
[--tree DIR]``.
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
sys.path.insert(0, ROOT)

MAX_BLOCKS, SLOTS, MAX_ITEMS = 1024, 32, 64
# per-warpgroup slots (8 + 12 wg + k); ``tile`` is the live tiles' time
SPANS = ("stage", "sdp", "dv", "dk", "ds", "dq", "buffer", "kv", "tile",
         "tiles")
SLOT = {name: k for k, name in enumerate(SPANS)}
WAITS = SPANS[:SPANS.index("kv")]   # a tile's waits


def _slot(name: str) -> str:
    return f"kftpu_stamp[blockIdx.x][8 + 12 * wg + {SLOT[name]}]"


def _span(name: str, head: str, tail: str, var: str,
          prefix: str = "") -> tuple:
    """Time ``head`` (a wait; ``prefix + head + tail`` is found once) on
    each consumer warpgroup's first thread into span ``name``'s slot."""
    pad = head[:len(head) - len(head.lstrip())]
    return (prefix + head + tail,
            prefix + f"{pad}const unsigned long long {var} = gtime();\n"
            + head + f"{pad}if (tw == 0) {_slot(name)} += gtime() - {var};\n"
            + tail)


# (anchor, text put before it, text put after it); slots 0 entry, 1 first
# add, 2 ns waited, 3 adds that waited, 4 end, 5 adds, 6 items, 7 grid
COMMON = [
    ("template <int D>\n__global__ void __launch_bounds__(kWgThreads, 1)\n"
     "    flash_bwd_wgmma_kernel(",
     "__device__ unsigned long long kftpu_stamp"
     f"[{MAX_BLOCKS}][{SLOTS}];\n"
     "__device__ unsigned long long kftpu_items"
     f"[{MAX_BLOCKS}][{MAX_ITEMS}][3];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n\n", ""),
    ("    mbar_init(res_empty, 8);\n", "",
     "    kftpu_stamp[blockIdx.x][0] = gtime();\n"),
    ("          x = atomicAdd(counters, 1);\n"
     "          if (x >= n_items) x = -1;\n", "",
     f"          if (x >= 0 && n < {MAX_ITEMS}) {{\n"
     "            kftpu_items[blockIdx.x][n][0] = x / n_work;\n"
     "            kftpu_items[blockIdx.x][n][1] = gtime();\n"
     "          }\n"),
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
    ("      mbar_wait(res_full, n & 1);\n",
     "      const unsigned long long t_kv = gtime();\n",
     f"      if (tw == 0) {_slot('kv')} += gtime() - t_kv;\n"),
    ("      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(res_empty);  // K and V read\n",
     f"      if (wg == 0 && tw == 0 && n < {MAX_ITEMS})\n"
     "        kftpu_items[blockIdx.x][n][2] = gtime();\n", ""),
]

# this checkout's consumer loop: one span a wait, and the tile's time
TILE_START = ("        const uint32_t qa = q_at(it), ga = qa + kBox;\n"
              "        const bool own = owns(tq);\n"
              "        float fresh_v[32], fresh_k[32];\n")
TILE_END = "        ++i, ++it, ++tq;\n      };\n"
# the tile's end: the next tile's S^T and dP^T go out, then the owner
# waits for its dQ (the other for its dK), then for S^T and dP^T
NEXT = "            issue_sdp(it + 1);\n"
OWN = [
    _span("stage", "        wait_stage(it2);\n",
          "        wgmma_fence();\n        issue_ss(sT, ka, q_at(it2));\n",
          "t_st"),
    _span("dv", "        wgmma_wait<1>();\n",
          "        add_to(dva, fresh_v);\n", "t_dv"),
    _span("dk", "          wgmma_wait<1>();\n",
          "          add_to(dka, fresh_k);\n", "t_dk"),
    _span("dq", "            wgmma_wait<2>();\n",
          "          } else {\n            wgmma_wait<0>();\n          }\n"
          "          fence_regs(fq);\n", "t_dq", NEXT),
    _span("dk", "            wgmma_wait<2>();\n",
          "          } else {\n            wgmma_wait<0>();\n          }\n"
          "          add_to(dka, fresh_k);\n", "t_dk2", NEXT),
    _span("sdp", "          wgmma_wait<0>();\n",
          "          fence_regs(sT);\n          fence_regs(dpT);\n        }\n"
          + TILE_END, "t_sdp"),
    _span("ds", "      mbar_wait(ds_full(tq & 1), (tq >> 1) & 1);\n", "",
          "t_ds"),
    _span("buffer", "      if (!own) mbar_wait(ds_free(x), "
                    "((tq >> 1) & 1) ^ 1);\n", "", "t_bf"),
    _span("buffer", "      mbar_wait(dq_empty(buf), "
                    "((tq / kDqBufs) & 1) ^ 1);\n", "", "t_bq"),
    (TILE_START, "        const unsigned long long t_tile = gtime();\n", ""),
    (TILE_END, "        if (tw == 0) {\n"
               f"          {_slot('tile')} += gtime() - t_tile;\n"
               f"          {_slot('tiles')} += 1;\n        }}\n" + TILE_END),
]


def instrumented_source(src: str, own: bool = True) -> str:
    """``src`` with the stamps of the module docstring inserted (the
    per-tile spans only with ``own``); raises if an anchor is not found
    exactly once (the kernel changed: update the anchors)."""
    stamps = [(a, b + a + c) for a, b, c in COMMON]
    if own:
        stamps += [s if len(s) == 2 else (s[0], s[1] + s[0] + s[2])
                   for s in OWN]
    for anchor, text in stamps:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    return src + (
        '\nextern "C" int kftpu_flash_bwd_stamps(void* dst, void* items) {\n'
        "  int rc = (int)cudaMemcpyFromSymbol(dst, kftpu_stamp,\n"
        "                                     sizeof kftpu_stamp);\n"
        "  if (rc) return rc;\n"
        "  return (int)cudaMemcpyFromSymbol(items, kftpu_items,\n"
        "                                   sizeof kftpu_items);\n}\n"
        '\nextern "C" int kftpu_flash_bwd_stamps_reset(const void* zeros,\n'
        "                                             const void* none) {\n"
        "  int rc = (int)cudaMemcpyToSymbol(kftpu_stamp, zeros,\n"
        "                                   sizeof kftpu_stamp);\n"
        "  if (rc) return rc;\n"
        "  return (int)cudaMemcpyToSymbol(kftpu_items, none,\n"
        "                                 sizeof kftpu_items);\n}\n")


def build(tree: str) -> str:
    from kubeflow_tpu_torch.ops import _build

    own = os.path.abspath(tree) == ROOT
    csrc = os.path.join(tree, "kubeflow_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(_build.BUILD_DIR, "timeline",
                           "own" if own else "tree")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        src = instrumented_source(f.read(), own)
    cu = os.path.join(out_dir, "flash_attention.cu")
    with open(cu, "w") as f:
        f.write(src)
    shutil.copy(os.path.join(csrc, "hopper.cuh"), out_dir)
    so = os.path.join(out_dir, "libflash_bwd_timeline.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return so


def heads_in_flight(items) -> tuple:
    """The most and the median count of distinct heads whose items are in
    flight, sampled at each item's start; ``items`` (head, start, end)."""
    import numpy as np

    counts = []
    for _, t0, _ in items:
        counts.append(len({h for h, s, e in items if s <= t0 < e}))
    return int(max(counts)), float(np.median(counts))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", metavar="DIR", default=ROOT,
                    help="instrument DIR's kernel (the stamps it shares)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    spec = importlib.util.spec_from_file_location(
        "port_flash_bwd_timeline_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    own = os.path.abspath(args.tree) == ROOT
    lib = ctypes.CDLL(build(args.tree))
    lib.kftpu_flash_bwd_stamps.argtypes = [ctypes.c_void_p] * 2
    lib.kftpu_flash_bwd_stamps_reset.argtypes = [ctypes.c_void_p] * 2
    _build._libs["flash_attention"] = lib      # the wrapper's library
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    zeros = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
    zeros[:, 1] = np.iinfo(np.uint64).max     # the first add: a minimum
    none = np.zeros((MAX_BLOCKS, MAX_ITEMS, 3), np.uint64)
    spans = SPANS if own else ("kv",)
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
            rc = lib.kftpu_flash_bwd_stamps_reset(zeros.ctypes.data,
                                                  none.ctypes.data)
            if rc:
                raise RuntimeError(f"cudaMemcpyToSymbol: {rc}")
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            fa.flash_bwd(q, k, v, g, lse, delta, causal=causal)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
            its = np.zeros((MAX_BLOCKS, MAX_ITEMS, 3), np.uint64)
            rc = lib.kftpu_flash_bwd_stamps(buf.ctypes.data, its.ctypes.data)
            if rc:
                raise RuntimeError(f"cudaMemcpyFromSymbol: {rc}")
            grid = int(buf[:, 7].max())
            added = buf[:grid, 5] > 0             # the blocks that added
            b = buf[:grid][added].astype(np.int64)
            t0 = b[:, 0].min()
            span = (b[:, 4] - b[:, 0]).astype(np.float64)
            items = [(int(h), int(s), int(e)) for h, s, e in
                     its[:grid].reshape(-1, 3).astype(np.int64)
                     if s > 0 and e > 0]
            most, median = heads_in_flight(items)
            item_ns = np.array([e - s for _, s, e in items], np.float64)
            run = {
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
                "blocks": len(b), "heads_most": most,
                "heads_median": median,
                "item_us": float(np.median(item_ns) / 1e3)}
            for wg in (0, 1):
                col = {name: b[:, 8 + 12 * wg + SLOT[name]].astype(
                    np.float64) for name in SPANS}
                n_items = np.maximum(b[:, 6], 1)
                run[f"wg{wg}_kv_us"] = float(np.median(col["kv"] / n_items)
                                             / 1e3)
                if not own:
                    continue
                tiles = np.maximum(col["tiles"], 1)
                run[f"wg{wg}_tiles"] = float(np.median(col["tiles"]))
                run[f"wg{wg}_tile_us"] = float(np.median(col["tile"] / tiles)
                                               / 1e3)
                waits = sum(col[name] for name in WAITS)
                run[f"wg{wg}_issue_us"] = float(np.median(
                    (col["tile"] - waits) / tiles) / 1e3)
                for name in WAITS:
                    run[f"wg{wg}_{name}_us"] = float(np.median(
                        col[name] / tiles) / 1e3)
            runs.append(run)
        print(json.dumps({"device": ident, "tree": os.path.abspath(args.tree),
                          "shape": label, "B": B, "S": S, "H": H,
                          "causal": causal, "spans": list(spans),
                          **{key: float(np.median([r[key] for r in runs]))
                             for key in runs[0]}}), flush=True)
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
