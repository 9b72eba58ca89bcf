"""Paged decode attention: one query token per row, K/V read through the
row's page table.

Counterpart of ``kubeflow_tpu/ops/paged_attention.py``. The CUDA kernel
(``csrc/paged_attention.cu``) replaces the Pallas ``_paged_decode_kernel``;
its source note says what bounds it and how it is laid out.

- :func:`paged_decode_attention` — the wrapper. A CUDA tensor launches
  the kernel (or raises); a CPU tensor takes the plain version. No
  fallback in between.
- :func:`paged_decode_attention_plain` — the plain PyTorch version: the
  gather core of ``models/transformer.py:_paged_decode_attend`` at
  ``S == 1`` (dense logical view, scores in f32 after an einsum in the
  input dtype, probabilities cast back before the value product), with
  sentinel pages masked so an all-sentinel row gives zeros exactly as
  the kernel does. Where the engine's safety contract holds (sentinel
  entries only past a row's causal frontier) it equals the gather core.

``launches`` counts kernel launches by kernel name (never plain calls).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops.attention import NEG_INF, gqa_repeat

launches = {"paged_decode_attention": 0}
MAX_HEAD_DIM = 256     # the kernel's widest head (32 lanes x 2 x 16 bytes)
MAX_HEAD_BLOCK = 8     # q heads a block takes (kMaxGroup in csrc)
_MAX_SMEM = 48 * 1024  # default dynamic shared memory, no opt-in needed
_SPLIT_TOKENS = 128    # keys per split block (scripts/port_paged_sweep.py)


def _check(q, k_pages, v_pages, pages, positions) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B, QH, Dh) and pools (P, ps, KH, Dh);"
                         f" got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, QH, Dh = q.shape
    P, ps, KH, Dh2 = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError("k and v pools must have one shape")
    if Dh2 != Dh:
        raise ValueError(f"head dim {Dh} != pool head dim {Dh2}")
    if QH % KH:
        raise ValueError(f"q heads {QH} must be a multiple of kv heads {KH}")
    if pages.dim() != 2 or pages.shape[0] != B:
        raise ValueError(f"pages must be (B={B}, n_log)")
    if positions.shape != (B,):
        raise ValueError(f"positions must be ({B},)")
    if pages.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("pages and positions must be int32")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    devs = {t.device for t in (q, k_pages, v_pages, pages, positions)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def paged_decode_attention_plain(q, k_pages, v_pages, pages, positions, *,
                                 sm_scale: Optional[float] = None):
    """Plain PyTorch version (see the module docstring)."""
    B, QH, Dh = q.shape
    P, ps, KH, _ = k_pages.shape
    n_log = pages.shape[1]
    T = n_log * ps
    scale = sm_scale if sm_scale is not None else Dh ** -0.5
    idx = pages.long().clamp(0, P - 1)
    kc = k_pages[idx].reshape(B, T, KH, Dh)
    vc = v_pages[idx].reshape(B, T, KH, Dh)
    kc, vc = gqa_repeat(q[:, None], kc, vc)
    s = torch.einsum("bhd,bthd->bht", q, kc).float() * scale
    kv_pos = torch.arange(T, device=q.device)
    live = ((kv_pos[None, :] <= positions.long()[:, None])
            & (pages != P).repeat_interleave(ps, dim=1))      # (B, T)
    s = s.masked_fill(~live[:, None, :], NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)) * live[:, None, :]
    probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bht,bthd->bhd", probs.to(q.dtype), vc)


def _lib():
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.kftpu_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 9 + [i] * 8
                       + [ctypes.c_float, i, ctypes.c_longlong, p])
        fn.restype = ctypes.c_int
        sm = lib.kftpu_paged_decode_smem_bytes
        sm.argtypes = [i, i, i, i]
        sm.restype = ctypes.c_size_t
    return lib


def _pages_per_split(lib, group: int, Dh: int, el: int, ps: int) -> int:
    """Logical pages per split block: about ``_SPLIT_TOKENS`` keys, fewer
    where the block's shared memory would pass ``_MAX_SMEM``."""
    pps = max(1, _SPLIT_TOKENS // ps)
    while pps > 1 and lib.kftpu_paged_decode_smem_bytes(
            group, Dh, el, pps) > _MAX_SMEM:
        pps //= 2
    smem = lib.kftpu_paged_decode_smem_bytes(group, Dh, el, pps)
    if smem > _MAX_SMEM:
        raise ValueError(f"group {group} x Dh {Dh} x page {ps} needs "
                         f"{smem} B of shared memory (max {_MAX_SMEM})")
    return pps


# device -> (fold counters, split workspace), kept between calls
_scratch: Dict[Tuple[str, Optional[int]], Tuple[torch.Tensor,
                                               torch.Tensor]] = {}


def device_scratch(device: torch.device, n_counters: int, n_ws: int):
    """The fused fold's buffers on ``device``: ``n_counters`` (or more)
    int32 counters, zeroed once when allocated, and ``n_ws`` (or more)
    f32 of split workspace. Both are kept per device and grown, never
    shrunk; a grown counter buffer is a new zeroed one.

    The kernel leaves every counter it draws from at 0 (the last split
    of each (row, KV head, head block) resets it), and calls on one
    stream run in order, so each call finds its counters at 0 and the
    workspace free.
    The contract: on one device, calls run on one stream at a time."""
    key = (device.type, device.index)
    counters, ws = _scratch.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    _scratch[key] = (counters, ws)
    return counters, ws


def paged_decode_attention(q, k_pages, v_pages, pages, positions, *,
                           sm_scale: Optional[float] = None):
    """Single-token decode attention straight off a paged KV pool.

    - ``q``: ``(B, QH, Dh)`` f32/bf16, one rotated query token per row;
    - ``k_pages``/``v_pages``: the pool ``(P, page_size, KH, Dh)``, or a
      slice ``pool[:, :, a:b]`` of its kv heads (read in place: a rank
      whose q heads map to some of a replicated pool's kv heads);
    - ``pages``: ``(B, n_log)`` int32 page table, sentinel ``P``;
    - ``positions``: ``(B,)`` int32, each row's query position (keys
      ``<= positions[b]`` attend).

    Returns ``(B, QH, Dh)`` in ``q.dtype``. On a CUDA device the kernel
    is one launch that folds its splits itself, through counters and a
    workspace kept per device (:func:`device_scratch`): calls on one
    device must run on one stream at a time.
    """
    _check(q, k_pages, v_pages, pages, positions)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, pages,
                                            positions, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("pages", pages), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, QH, Dh = q.shape
    P, ps, KH, _ = k_pages.shape
    tok = k_pages.stride(1)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride() != (ps * tok, tok, Dh, 1):
            raise ValueError(f"{name} must be a pool or a slice of its kv "
                             f"heads; strides {t.stride()}")
    n_log = pages.shape[1]
    el = q.element_size()
    vec = 16 // el
    if Dh % vec or Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} must be a multiple of {vec} (16-"
                         f"byte row slices) and at most {MAX_HEAD_DIM} for "
                         "the CUDA kernel")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q/k/v must be 16-byte aligned")
    lib = _lib()
    group = QH // KH
    pps = _pages_per_split(lib, group, Dh, el, ps)
    n_splits = -(-n_log // pps)
    scale = sm_scale if sm_scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    # per-split partials (acc, then m/l) of each block of at most
    # MAX_HEAD_BLOCK q heads, folded by the unit's last split
    n_hb = -(-group // MAX_HEAD_BLOCK)
    n_part = B * KH * n_hb * n_splits * min(group, MAX_HEAD_BLOCK)
    counters, ws = device_scratch(q.device, B * KH * n_hb,
                                  n_part * (Dh + 2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.kftpu_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pages.data_ptr(), positions.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws.data_ptr() + n_part * Dh * 4,
            counters.data_ptr(), B, QH, KH, Dh, P, ps, n_log, pps,
            float(scale), int(q.dtype == torch.bfloat16), tok, stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches["paged_decode_attention"] += 1
    return out
