#!/usr/bin/env python3
"""Where a call of the bf16 D = 64 flash forward spends its time, on one GPU.

No profiler counters work on the card's machine, so this builds a copy
of a checkout's ``kubeflow_tpu_torch/ops/csrc/flash_attention.cu`` with
``%globaltimer`` (the card's nanosecond clock, 32 ns steps) read around
fixed points of ``flash_fwd_wgmma_kernel``'s consumer warpgroups, summed
into a ``__device__`` array by block and warpgroup (each warpgroup's
first thread), loads it in place of that checkout's library, and runs
``flash_fwd`` at one of ``chip_smoke.py``'s timed shapes (``--shape``:
the LM's (2, 8192, 16, 64) causal, BERT-base's (16, 512, 12, 64) or
``:predict``'s (8, 512, 12, 64), not causal) after the same 128 MB
flush ``chip_smoke.time_ms`` runs before each timed call. The kernel is
the item hand-off design: three or one consumer warpgroups, the next
stage's S in flight under this stage's softmax, and the next item's
first S issued with this item's last P.V. Per warpgroup, summed over a block's stages or items:

- ``stage``: waiting for a stage's K and V (the ring's full barrier);
- ``s_wait``: waiting for S = Q.K^T to land;
- ``softmax``: the online softmax (max, exponentials, sums); within it,
  with ``--exp-spans``, ``exponents``: the exponent loop (read at
  data-dependent clock reads around it: ptxas may still move independent
  arithmetic across, so the span is approximate, and these stamps slow
  the copy's softmax);
- ``pv_wait``: waiting for P.V to land;
- ``o_update``: O = O * alpha + P.V and the next P's rounding;
- ``skip``: the stages of an item none of whose products are the
  warpgroup's (a causal item's upper stages for its lower rows);
- ``next_item``: waiting for the next item's Q buffer and reading its
  item;
- ``handoff``: this item's last P.V and O update, with the next item's
  first S and its softmax under it where the warpgroup hands off (it
  drains where its last stage comes before the item's);
- ``epilogue``: the next item's P rounded, then O / l stored and lse;
- ``stages`` and ``items``: the stages it computed, the items it wrote.

Prints one JSON line per warpgroup with the medians over the blocks of
each span (µs), each stage span's mean per stage (ns) and each item
span's mean per item (ns), the grid, and the card's name and power
limit. The instrumented copy is built into the git-ignored
``kubeflow_tpu_torch/_build/timeline/`` of the checkout it instruments;
that checkout's own library is not touched.

Usage (needs CUDA): ``python3 scripts/port_flash_fwd_timeline.py
[--shape lm|bert|predict_b8] [--exp-spans]`` (this checkout) or
``--tree DIR`` (another checkout of the same design, e.g. one unpacked
by ``git archive``, to compare a change with it; a checkout of an
earlier design is read by its own copy of this script).
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

SPANS = ("stage", "s_wait", "softmax", "exponents", "pv_wait", "o_update",
         "skip", "next_item", "handoff", "epilogue", "stages", "items")
PER_STAGE = ("stage", "s_wait", "softmax", "exponents", "pv_wait",
             "o_update")
PER_ITEM = ("skip", "next_item", "handoff", "epilogue")
MAX_BLOCKS, WGS, PER_WG = 4096, 3, len(SPANS)
SLOTS = WGS * PER_WG
# (B, S, H, D), causal: chip_smoke.py's timed shapes
SHAPES = {"lm": ((2, 8192, 16, 64), True),
          "bert": ((16, 512, 12, 64), False),
          "predict_b8": ((8, 512, 12, 64), False)}

PRELUDE = f"""
__device__ unsigned long long kftpu_stamp[{MAX_BLOCKS}][{SLOTS}];
__device__ __forceinline__ unsigned long long kftpu_gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
// the clock read once d is computed
__device__ __forceinline__ unsigned long long kftpu_gtime_after(float d) {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer; // %1" : "=l"(t) : "f"(d));
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


class _Stamps:
    """Anchors and their stamped text: each target (whole statements,
    between ``before`` and ``after`` in the source, which tell it from a
    like one)
    timed into a span by a clock variable of its own (no new scope, so a
    declaration inside stays visible)."""

    def __init__(self):
        self.items = []

    def span(self, name: str, target: str, after: str = "",
             count: str = "", before: str = "") -> "_Stamps":
        var = f"kftpu_t{len(self.items)}"
        extra = f"  KFTPU_ADD({_k(count)}, 1ull);\n" if count else ""
        new = (f"const unsigned long long {var} = kftpu_gtime();\n"
               + target
               + f"  KFTPU_ADD({_k(name)}, kftpu_gtime() - {var});\n"
               + extra)
        self.items.append((before + target + after, before + new + after))
        return self

    def raw(self, anchor: str, before: str) -> "_Stamps":
        """``before`` put in front of ``anchor``."""
        self.items.append((anchor, before + anchor))
        return self


W1, W0 = "          ", "        "
KERNEL_STAMPS = (
    _Stamps()
    .span("stage", W1 + "wait_ring(rix(j));\n")
    .span("s_wait", W1 + "wgmma_wait<0>();\n" + W1 + "fence_regs(sc);\n",
          W1 + "softmax(cur, m, l, alpha, j);\n")
    .span("softmax", W1 + "softmax(cur, m, l, alpha, j);\n")
    .span("stage", W1 + "wait_ring(rix(j + 1));\n")
    .span("s_wait", W1 + "wgmma_wait<1>();\n" + W1 + "fence_regs(sc);\n",
          W1 + "softmax(cur, m, l, alpha_next, j + 1);\n")
    .span("softmax", W1 + "softmax(cur, m, l, alpha_next, j + 1);\n")
    .span("pv_wait", W1 + "wgmma_wait<0>();\n" + W1 + "fence_regs(pv);\n",
          W1 + "add_pv(alpha, rix(j));\n" + W1 + "fwd_pack(sc, pf);\n")
    .span("o_update", W1 + "add_pv(alpha, rix(j));\n" + W1
          + "fwd_pack(sc, pf);\n", count="stages")
    .span("skip", W0 + "for (int s = cur.live_hi; s < cur.j_hi; ++s) {"
          "  // none of ours\n" + W1 + "wait_ring(rix(s));\n" + W1
          + "release(empty(rix(s) % kStages));\n" + W0 + "}\n")
    .span("next_item", W0 + "if (!drains) nxt = view(n + 1, it_end);\n")
    .span("next_item", W0 + "cur = drains ? view(n + 1, it_end) : nxt;\n")
    .span("stage", W1 + "wait_ring(it_end);\n")
    .span("s_wait", W1 + "wgmma_wait<1>();\n" + W1 + "fence_regs(sc);\n",
          W1 + "softmax(nxt, ")
    .span("softmax", W1
          + "softmax(nxt, m_next, l_next, alpha_next, nxt.j_lo);\n")
    .span("pv_wait", W1 + "wgmma_wait<0>();\n" + W1 + "fence_regs(pv);\n",
          W1 + "add_pv(alpha, rix(j));\n" + W0 + "} else {\n")
    .span("o_update", W1 + "add_pv(alpha, rix(j));\n", W0 + "} else {\n",
          count="stages")
    .span("pv_wait", W1 + "wgmma_wait<0>();\n" + W1 + "fence_regs(pv);\n",
          before=W1 + "issue_pv(rix(j));\n")
    .span("o_update", W1 + "add_pv(alpha, rix(j));\n", count="stages",
          after=W0 + f"}}\n  KFTPU_ADD({_k('handoff')}, kftpu_gtime() - "
          "kftpu_h);\n")
    .span("epilogue", W0 + "if (hand_off) fwd_pack(sc, pf);  // P.V's "
          "registers are free\n" + W0 + "epilogue(cur);\n", count="items")
)
# the hand-off's whole block, stamped after the spans inside it
HANDOFF_BLOCK = (W0 + "if (hand_off) {\n", W0 + "}\n" + W0
                 + "for (int s = cur.live_hi")
SOFTMAX_STAMPS = (
    _Stamps()
    .raw("  float ps[2] = {0.f, 0.f};\n",
         "  const unsigned long long kftpu_e0 = "
         "kftpu_gtime_after(mc[0] + mc[1]);\n")
    .raw("#pragma unroll\n  for (int r = 0; r < 2; ++r) {\n"
         "    l[r] = l[r] * alpha[r] + ps[r];",
         "  KFTPU_ADD(" + str(_k("exponents")) + ", "
         "kftpu_gtime_after(ps[0] + ps[1]) - kftpu_e0);\n")
)


def _apply(body: str, stamps: _Stamps) -> str:
    for anchor, new in stamps.items:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        body = body.replace(anchor, new)
    return body


def _body(src: str, name: str) -> tuple:
    """(start, end) of the definition of the function ``name``."""
    start = src.index(name + "(")
    return start, src.index("\n}\n", start)


def instrumented_source(src: str, exp_spans: bool = False) -> str:
    """``src`` with the kernel's stamps (with ``exp_spans``, also inside
    the softmax): each anchor must occur exactly once in the function it
    stamps (the kernel changed otherwise: update the anchors)."""
    start, end = _body(src, "flash_fwd_wgmma_kernel")
    body = src[start:end]
    # the whole hand-off block first, then the spans in it
    head, tail = HANDOFF_BLOCK
    if body.count(head) != 1 or body.count(tail) != 1:
        raise RuntimeError("the hand-off block's anchors moved")
    i, j = body.index(head), body.index(tail) + len(W0 + "}\n")
    body = (body[:i] + "const unsigned long long kftpu_h = "
            "kftpu_gtime();\n" + body[i:j]
            + f"  KFTPU_ADD({_k('handoff')}, kftpu_gtime() - kftpu_h);\n"
            + body[j:])
    src = src[:start] + _apply(body, KERNEL_STAMPS) + src[end:]
    if exp_spans:
        start, end = _body(src, "fwd_softmax_at")
        src = src[:start] + _apply(src[start:end], SOFTMAX_STAMPS) + src[end:]
    head = src.index("namespace {")
    src = src[:head] + PRELUDE + src[head:]
    return src + (
        '\nextern "C" int kftpu_flash_fwd_stamps(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, kftpu_stamp,\n"
        "                                   sizeof kftpu_stamp);\n}\n"
        '\nextern "C" int kftpu_flash_fwd_stamps_reset(const void* zeros) {\n'
        "  return (int)cudaMemcpyToSymbol(kftpu_stamp, zeros,\n"
        "                                 sizeof kftpu_stamp);\n}\n")


def build(tree: str, exp_spans: bool = False) -> str:
    from kubeflow_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "timeline")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(tree, "kubeflow_tpu_torch", "ops", "csrc")
    with open(os.path.join(csrc, "flash_attention.cu")) as f:
        src = instrumented_source(f.read(), exp_spans)
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
    ap.add_argument("--shape", choices=sorted(SHAPES), default="lm",
                    help="chip_smoke.py's timed shape to run")
    ap.add_argument("--exp-spans", action="store_true",
                    help="also stamp the softmax's exponent loop (slows "
                         "the copy's softmax)")
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
    so = build(tree, args.exp_spans)
    lib = ctypes.CDLL(so)
    lib.kftpu_flash_fwd_stamps.argtypes = [ctypes.c_void_p]
    lib.kftpu_flash_fwd_stamps_reset.argtypes = [ctypes.c_void_p]
    _build._libs["flash_attention"] = lib      # the wrapper's library
    fa._lib()
    dev = torch.device("cuda", 0)
    ident = smoke.gpu_identity()
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)
    zeros = np.zeros((MAX_BLOCKS, SLOTS), np.uint64)
    (B, S, H, D), causal = SHAPES[args.shape]
    q, k, v, _, _ = smoke.flash_inputs(B, S, H, D, torch.bfloat16, dev,
                                       smoke.SEED + 1, False)
    for _ in range(3):
        fa.flash_fwd(q, k, v, causal=causal)
    runs, ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        if lib.kftpu_flash_fwd_stamps_reset(zeros.ctypes.data):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fa.flash_fwd(q, k, v, causal=causal)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
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
            items = max(int(b[:, _k("items")].sum()), 1)
            per_run.append({
                "blocks": len(b),
                "stages": float(np.median(b[:, _k("stages")])),
                "items": float(np.median(b[:, _k("items")])),
                **{f"{name}_us": float(np.median(b[:, _k(name)]) / 1e3)
                   for name in PER_STAGE + PER_ITEM},
                **{f"{name}_ns_a_stage": float(b[:, _k(name)].sum() / n)
                   for name in PER_STAGE},
                **{f"{name}_ns_an_item": float(b[:, _k(name)].sum() / items)
                   for name in PER_ITEM}})
        if not per_run:
            continue
        print(json.dumps({"device": ident, "tree": tree,
                          "shape": [B, S, H, D], "causal": causal,
                          "warpgroup": wg,
                          "instrumented_ms": float(np.median(ms)), **{
                              key: float(np.median([r[key] for r in per_run]))
                              for key in per_run[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
