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
  the tile's dQ, warpgroup tq & 1), for dQ's products (``dq``: the
  owner's), for buffers (``buffer``: the other's wait for a dS^T
  buffer's last dQ, the owner's for the adder's dQ buffer), and
  ``issue``: the tile's time less those waits, the warpgroup issuing
  element-wise work and products. ``ew``: the element-wise span, from
  the tile's S^T and dP^T landed to its dK issued (P, dV issued, dS,
  the dS^T half stored; the other's buffer wait inside it);
  ``both_ew``: the time of it the other warpgroup was in its own span
  too, when neither warpgroup issues products (the one that ends first
  counts it; ``both_ew_us`` sums the two a tile). ``kv_us`` (µs an
  item): the wait for the item's K and V, which load once the previous
  item's last products are done; ``item_us``: an item's time, taken to
  consumed;
- ``heads``: the (batch, head) pairs whose items are in flight at once
  over the grid, the most and the median over the items' starts (each
  head's f32 dQ workspace is S x 64 x 4 bytes, 2 MB at the LM's S).

Before the stamps, one JSON line holds the kernel's census
(:func:`sass_census`): ptxas's report for it (registers, spills) and
its SASS instructions by class (``wgmma``, FFMA, FADD or FMUL, MUFU,
conversions and permutes, shared-memory stores and loads, barriers,
other), from ``cuobjdump -sass`` of the library built as the package
builds it: the whole kernel, the steady tile loop, and that loop less
the edge tiles' path of P (``steady``, over ``tiles`` tiles: a
thread's instructions a tile). ``--census-only`` stops there;
``--sass FILE`` writes the kernel's SASS.

With ``--tree DIR`` the kernel of another checkout (its
``kubeflow_tpu_torch/ops/csrc/``) is instrumented instead, with the
stamps its source shares with this one (the adders, the items, K and
V, the heads); the per-tile spans follow this checkout's kernel and are
left out. Prints one JSON line per shape with the medians over the
blocks and five calls, the grid, and the card's name and power limit.
The instrumented copy is built into the git-ignored
``kubeflow_tpu_torch/_build/timeline/``; the package's own library is
not touched.

Usage (needs CUDA and the CUDA toolkit's ``cuobjdump``): ``python3
scripts/port_flash_bwd_timeline.py [--tree DIR] [--census-only]
[--sass FILE]``.
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
         "tiles", "ew", "both_ew")
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
TILE_START = ("        const uint32_t qa = stage16(it);"
              "  // Q; dO one box on\n"
              "        const bool own = owns(tq);\n"
              "        float fresh_v[32], fresh_k[32];\n")
# the element-wise span's end: dK issued, P, dS and the dS^T half made
EW_END = "        issue_rs(fresh_k, dh, dl, qa);\n"
TILE_END = "        ++i, ++it, ++tq;\n      };\n"
# the tile's end: the next tile's S^T and dP^T go out, then the owner
# waits for its dQ (the other for its dK), then for S^T and dP^T
NEXT = "            issue_sdp(it + 1);\n"
OWN = [
    _span("stage", "        wait_stage(it2);\n",
          "        wgmma_fence();\n"
          "        issue_ss(sT, k16, stage16(it2));\n",
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
    (TILE_START, "        const unsigned long long t_tile = gtime();\n"
                 "        if (tw == 0) kftpu_ew[wg] = t_tile;\n", ""),
    # each warpgroup's element-wise span, and the time of it the other
    # warpgroup spent in its own at once (counted by the one that ends
    # first, which finds the other's start still set)
    (EW_END, "", "        if (tw == 0) {\n"
                 "          const unsigned long long t_ew = gtime();\n"
                 "          const unsigned long long t_o = kftpu_ew[wg ^ 1];\n"
                 "          kftpu_ew[wg] = 0;\n"
                 f"          {_slot('ew')} += t_ew - t_tile;\n"
                 "          if (t_o)\n"
                 f"            {_slot('both_ew')} += t_ew - (t_o > t_tile ? "
                 "t_o : t_tile);\n        }\n"),
    ("  const int n_q = (S + kWgStep - 1) / kWgStep;\n", "",
     "  // a warpgroup's element-wise span's start, 0 outside it\n"
     "  volatile __shared__ unsigned long long kftpu_ew[2];\n"
     "  if (threadIdx.x < 2) kftpu_ew[threadIdx.x] = 0;\n"),
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


KERNEL = "flash_bwd_wgmma_kernel"
# SASS opcodes (the mnemonic before its first '.') by class; the rest
# (integer, moves, predicates, branches, uniform-datapath work) is "other"
CLASSES = {
    "wgmma": ("HGMMA",),
    "ffma": ("FFMA",),
    "fadd_fmul": ("FADD", "FMUL"),
    "mufu": ("MUFU",),
    "convert_permute": ("F2F", "F2FP", "PRMT", "I2F", "F2I", "I2FP",
                        "F2IP"),
    "shared_stores": ("STS", "STSM"),
    "shared_loads": ("LDS", "LDSM"),
    "barriers": ("BAR", "SYNCS", "WARPGROUP", "DEPBAR", "MEMBAR", "FENCE",
                 "WARPSYNC", "ERRBAR", "CCTL"),
}
OPCLASS = {op: name for name, ops in CLASSES.items() for op in ops}


def compile_kernel(tree: str, label: str) -> tuple:
    """``tree``'s ``csrc/flash_attention.cu`` built as it stands, with the
    package's flags (``-Xptxas -v`` among them), into the timeline's
    build directory; returns ``(library, compiler log)``."""
    from kubeflow_tpu_torch.ops import _build

    csrc = os.path.join(tree, "kubeflow_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(_build.BUILD_DIR, "timeline", f"census_{label}")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libflash_attention.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           os.path.join(csrc, "flash_attention.cu")],
                          check=True, capture_output=True, text=True)
    return so, done.stdout + done.stderr


def ptxas_lines(log: str) -> list:
    """The compiler's lines for the fused backward's kernel: from its
    ``Compiling entry function`` line to its ``Used ... registers``."""
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = KERNEL in line
        if on:
            lines.append(line.split("ptxas info    :")[-1].strip())
            if "Used" in line and "registers" in line:
                on = False
    return lines


def sass_of(so: str) -> list:
    """``(address, opcode, text)`` of each SASS instruction of the fused
    backward's kernel in ``so`` (``cuobjdump -sass``)."""
    import re

    from kubeflow_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    out, on = [], False
    for line in text.splitlines():
        if "Function :" in line:
            on = KERNEL in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if on and m:
            body = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            out.append((int(m.group(1), 16), body.split()[0].split(".")[0],
                        body))
    return out


def _branch_target(text: str):
    import re

    m = re.search(r"(0x[0-9a-f]+)\s*$", text)
    return int(m.group(1), 16) if m else None


def tile_loop(sass: list) -> tuple:
    """The steady tile loop's ``[start, end]`` addresses: of the loops (a
    backward branch before the kernel's last ``EXIT`` and its target: the
    retry stubs of the barrier waits after it jump back into the body)
    that hold no other loop with ``wgmma`` in it, the one with the most
    ``wgmma``."""
    last_exit = max((a for a, op, _ in sass if op == "EXIT"), default=0)
    loops = []
    for addr, op, text in sass:
        target = _branch_target(text) if op == "BRA" else None
        if target is not None and target < addr < last_exit:
            loops.append((target, addr))

    def wgmma(lo, hi):
        return sum(1 for a, op, _ in sass if lo <= a <= hi and op == "HGMMA")

    inner = [(lo, hi) for lo, hi in loops if wgmma(lo, hi) and not any(
        (lo2, hi2) != (lo, hi) and lo <= lo2 and hi2 <= hi and wgmma(lo2, hi2)
        for lo2, hi2 in loops)]
    return max(inner, key=lambda r: wgmma(*r)) if inner else None


# the masked score's exponent (kNegInfLog2e) marks make_p's edge path
MASKED = "-1.44269504977487275908e+30"


def edge_blocks(sass: list, span) -> list:
    """``[start, end]`` ranges inside ``span`` that a steady tile jumps
    over: skipped by a forward branch, holding the masked exponent (the
    edge tiles' path of P) and no ``wgmma``."""
    out = []
    for addr, op, text in sass:
        target = _branch_target(text) if op == "BRA" else None
        if target is None or not span[0] <= addr < target <= span[1]:
            continue
        inside = [(op2, t) for a, op2, t in sass if addr < a < target]
        if (any(MASKED in t for _, t in inside)
                and not any(op2 == "HGMMA" for op2, _ in inside)):
            out.append((addr + 16, target - 16))
    # the outermost skipped ranges only
    return [r for r in out if not any(o != r and o[0] <= r[0] and
                                      r[1] <= o[1] for o in out)]


def census(sass: list, span=None, skip=()) -> dict:
    """SASS instructions by class (:data:`CLASSES`), over ``span`` (a
    ``[start, end]`` of addresses) or the whole kernel, less the ranges
    in ``skip``, and the opcodes of class "other" that occur most."""
    from collections import Counter

    counts = dict.fromkeys([*CLASSES, "other"], 0)
    other = Counter()
    for addr, op, _ in sass:
        if span is not None and not span[0] <= addr <= span[1]:
            continue
        if any(lo <= addr <= hi for lo, hi in skip):
            continue
        counts[OPCLASS.get(op, "other")] += 1
        if op not in OPCLASS:
            other[op] += 1
    counts["total"] = sum(counts.values())
    counts["other_top"] = dict(other.most_common(12))
    return counts


def sass_census(tree: str, label: str, sass_out: str = "") -> dict:
    """The kernel's ptxas report and its SASS census: the whole kernel,
    its steady tile loop (one iteration's static instructions a thread;
    where the body branches by role, both roles are in it), and that
    loop less make_p's edge path (``steady``: the instructions a thread
    issues for the loop's tiles, barrier retries aside). ``tiles``: the
    tiles one iteration covers, counted by their 32 exponentials each.
    The kernel's SASS goes to ``sass_out`` if given."""
    so, log = compile_kernel(tree, label)
    sass = sass_of(so)
    if sass_out:
        with open(sass_out, "w") as f:
            f.writelines(f"{a:06x} {text}\n" for a, _, text in sass)
    loop = tile_loop(sass)
    out = {"ptxas": ptxas_lines(log), "kernel": census(sass),
           "tile_loop": None}
    if loop:
        edges = edge_blocks(sass, loop)
        steady = census(sass, loop, edges)
        out.update(tile_loop=census(sass, loop),
                   tile_loop_span=[f"{loop[0]:#x}", f"{loop[1]:#x}"],
                   edge_spans=[[f"{lo:#x}", f"{hi:#x}"] for lo, hi in edges],
                   steady=steady, tiles=max(round(steady["mufu"] / 32), 1))
    return out


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
    ap.add_argument("--sass", metavar="FILE", default="",
                    help="write the tile loop's SASS to FILE")
    ap.add_argument("--census-only", action="store_true",
                    help="print the SASS census and stop")
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
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    print(json.dumps({"device": ident, "tree": os.path.abspath(args.tree),
                      "census": sass_census(args.tree,
                                            "own" if own else "tree",
                                            args.sass)}),
          flush=True)
    if args.census_only:
        return 0
    lib = ctypes.CDLL(build(args.tree))
    lib.kftpu_flash_bwd_stamps.argtypes = [ctypes.c_void_p] * 2
    lib.kftpu_flash_bwd_stamps_reset.argtypes = [ctypes.c_void_p] * 2
    _build._libs["flash_attention"] = lib      # the wrapper's library
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
                for name in (*WAITS, "ew", "both_ew"):
                    run[f"wg{wg}_{name}_us"] = float(np.median(
                        col[name] / tiles) / 1e3)
            if own:
                # the time a tile both warpgroups were in their
                # element-wise spans at once (each overlap is counted by
                # one of them)
                both = sum(b[:, 8 + 12 * wg + SLOT["both_ew"]]
                           for wg in (0, 1)).astype(np.float64)
                tiles = np.maximum(b[:, 8 + SLOT["tiles"]], 1)
                run["both_ew_us"] = float(np.median(both / tiles) / 1e3)
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
