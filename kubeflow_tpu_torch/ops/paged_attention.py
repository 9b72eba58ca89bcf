"""Paged decode attention: one query token per row, K/V read through the
row's page table.

Counterpart of ``kubeflow_tpu/ops/paged_attention.py``. Two CUDA kernels
(``csrc/paged_attention.cu``) replace the Pallas ``_paged_decode_kernel``;
the source note says what bounds them and how they are laid out:
``paged_decode_tma_kernel`` at bf16, head dim 64 and GQA groups of at
most 8 (:func:`paged_route`), ``paged_decode_kernel`` at every other
shape.

- :func:`paged_decode_attention` — the wrapper. A CUDA tensor launches
  the kernel of its route (or raises); a CPU tensor takes the plain
  version. No fallback in between.
- :func:`paged_work` — the TMA kernel's work list, as each of its
  blocks computes it on the card (a mirror the tests hold).
- :func:`paged_decode_attention_plain` — the plain PyTorch version: the
  gather core of ``models/transformer.py:_paged_decode_attend`` at
  ``S == 1`` (dense logical view, scores in f32 after an einsum in the
  input dtype, probabilities cast back before the value product), with
  sentinel pages masked so an all-sentinel row gives zeros exactly as
  the kernel does. Where the engine's safety contract holds (sentinel
  entries only past a row's causal frontier) it equals the gather core.

``launches`` counts kernel launches (never plain calls):
``paged_decode_attention`` every launch, ``paged_decode_tma`` those of
the TMA route.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops import autotune
from kubeflow_tpu_torch.ops.attention import NEG_INF, gqa_repeat

launches = {"paged_decode_attention": 0, "paged_decode_tma": 0}
MAX_HEAD_DIM = 256     # the kernel's widest head (32 lanes x 2 x 16 bytes)
MAX_HEAD_BLOCK = 8     # q heads a block takes (kMaxGroup in csrc)
# the TMA kernel (csrc tma::): batch rows its work list holds, rows of at
# most this many keys taken whole (where they busy the card), rows a ring
# stage (and a TMA box) holds
TMA_MAX_ROWS = 1024
TMA_WHOLE_KEYS = 512
TMA_STAGE_ROWS = 64
TMA_MAX_STRIDE = 1 << 40   # a TMA map's strides are below 2**40 bytes
_MAP_BYTES = 128           # sizeof(CUtensorMap)


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


def paged_route(dtype: torch.dtype, head_dim: int, group: int) -> str:
    """The kernel a CUDA call at this dtype, head dim and GQA group
    launches (``autotune.paged_route``): ``paged_decode_tma_kernel`` or
    ``paged_decode_kernel``."""
    return autotune.paged_route(group, head_dim, dtype.itemsize)


class WorkUnit(NamedTuple):
    """One unit of the TMA kernel's work list: row ``b``, kv head ``kh``,
    head block ``hb`` (always 0: the route takes groups of at most 8),
    split ``sp`` of the row's ``nsp``, and its logical pages."""
    b: int
    kh: int
    hb: int
    sp: int
    nsp: int
    pages: Tuple[int, ...]


def paged_work(pages, positions, *, P: int, ps: int, KH: int, pps: int,
               grid: int, sms: int) -> Tuple[bool, List[WorkUnit]]:
    """``(whole, units)``: the TMA kernel's work list, as each block
    computes it from ``positions`` and the page table (a copy of the
    list's part of ``csrc/paged_attention.cu:paged_decode_tma_kernel``).

    A row's mapped live pages are those below its causal frontier whose
    id lies in ``[0, P)``, in page-table order. ``whole``: every row is
    one unit, when no row passes ``TMA_WHOLE_KEYS`` keys and the rows
    with a live page x kv heads busy 3/4 of the ``sms`` SMs, or when the
    longest row is within 1.5x a block's share of all the page loads
    (pages x kv heads over ``grid`` blocks); otherwise each row is cut
    into chunks of ``span`` pages and a remainder, ``span`` the larger
    of ``pps`` and a block's share. The chunks, heaviest first: the full
    ones by (row, split), then the remainders (with ``whole``, the rows)
    by size, most first, ties by row; each chunk is one unit a kv head.
    Which block takes which unit: :func:`paged_deal`."""
    rows = [[int(x) for x in r] for r in torch.as_tensor(pages).tolist()]
    pos = [int(x) for x in torch.as_tensor(positions).tolist()]
    live = []
    for r, p in zip(rows, pos):
        nl = min(len(r), p // ps + 1) if p >= 0 else 0
        live.append([j for j in range(nl) if 0 <= r[j] < P])
    n = [len(x) for x in live]
    longest, total = max(n, default=0), sum(n)
    loads = total * KH
    busy = sum(1 for x in n if x)
    whole = ((longest * ps <= TMA_WHOLE_KEYS and 4 * busy * KH >= 3 * sms)
             or 2 * longest * grid <= 3 * loads)
    span = max(pps, -(-loads // grid))
    chunks = []    # (size, row, split, of splits, pages)
    for b, lp in enumerate(live):
        nsp = 1 if whole else -(-len(lp) // span)
        step = len(lp) if whole else span
        for sp in range(nsp):
            chunk = tuple(lp[sp * step:(sp + 1) * step])
            chunks.append((len(chunk), b, sp, nsp, chunk))
    full = [c for c in chunks if not whole and c[0] == span]
    rest = sorted((c for c in chunks if (whole or c[0] < span) and c[0]),
                  key=lambda c: (-c[0], c[1]))
    units = [WorkUnit(b, kh, 0, sp, nsp, pg)
             for _, b, sp, nsp, pg in full + rest for kh in range(KH)]
    return whole, units


def paged_deal(n_units: int, grid: int, block: int) -> List[int]:
    """The units block ``block`` of ``grid`` takes, in order: the list
    is dealt in rounds of ``grid``, every other round from the last block
    back, so the blocks with the heaviest units of one round take the
    lightest of the next."""
    out = []
    for r in range(-(-n_units // grid)):
        u = r * grid + (grid - 1 - block if r & 1 else block)
        if u < n_units:
            out.append(u)
    return out


def _lib():
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.kftpu_paged_decode_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 8 + [f, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        sm = lib.kftpu_paged_decode_smem_bytes
        sm.argtypes = [i, i, i, i]
        sm.restype = ctypes.c_size_t
        maps = lib.kftpu_paged_tma_maps
        maps.argtypes = [p, p, p, i, i, i, ctypes.c_longlong]
        maps.restype = ctypes.c_int
        tma = lib.kftpu_paged_decode_tma
        tma.argtypes = [p] * 8 + [i] * 8 + [f, p]
        tma.restype = ctypes.c_int
    return lib


def _pages_per_split(lib, q, KH: int, ps: int, n_log: int) -> int:
    """Logical pages per split, from the tile table's ``split_tokens``
    for this shape class (``autotune.resolve_paged``). With no row, the
    analytic choice: about ``autotune.SPLIT_TOKENS`` keys, fewer where
    the block's shared memory would pass its route's limit
    (``autotune.paged_smem_limit``). A row's split is taken as it is:
    one the block cannot hold raises (``autotune.validate_entry`` keeps
    such rows out of the table)."""
    B, QH, Dh = q.shape
    group, el = QH // KH, q.element_size()
    limit = autotune.paged_smem_limit(group, Dh, el)
    cfg = autotune.resolve_paged(
        max_seq_len=n_log * ps, page_size=ps, n_heads=QH, n_kv_heads=KH,
        head_dim=Dh, dtype=q.dtype,
        generation=autotune.backend_generation(q.device))
    pps = max(1, cfg.split_tokens // ps)
    if cfg.source == "fallback":
        while pps > 1 and lib.kftpu_paged_decode_smem_bytes(
                group, Dh, el, pps) > limit:
            pps //= 2
    smem = lib.kftpu_paged_decode_smem_bytes(group, Dh, el, pps)
    if smem > limit:
        raise ValueError(f"group {group} x Dh {Dh} x page {ps} x {pps} "
                         f"pages ({cfg.source}) needs {smem} B of shared "
                         f"memory (max {limit})")
    return pps


# device -> (fold counters, split workspace), kept between calls
_scratch: Dict[Tuple[str, Optional[int]], Tuple[torch.Tensor,
                                               torch.Tensor]] = {}


def device_scratch(device: torch.device, n_counters: int, n_ws: int):
    """The fused fold's buffers on ``device``: ``n_counters`` (or more)
    int32 counters, zeroed once when allocated, and ``n_ws`` (or more)
    f32 of split workspace. Both are kept per device and grown, never
    shrunk; a grown counter buffer is a new zeroed one.

    Both kernels leave every counter they draw from at 0 (the last split
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


def check_paged_tma(k_pages, v_pages, batch: int) -> None:
    """The TMA kernel reads each pool through a map of (Dh, KH, P * ps)
    and lists at most ``TMA_MAX_ROWS`` batch rows: raise unless each
    pool's base is on 16 bytes, its key-row stride (in bytes) is a
    multiple of 16 below ``TMA_MAX_STRIDE``, its P * ps rows are
    addressable by an int, and ``batch`` fits the list."""
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        P, ps = t.shape[:2]
        row = t.stride(1) * t.element_size()
        if (t.data_ptr() % 16 or row % 16 or not 0 < row < TMA_MAX_STRIDE
                or P * ps >= 1 << 31):
            raise ValueError(
                f"the paged TMA kernel reads {name} through a TMA map: its "
                f"base must be on 16 bytes, its key rows a multiple of 16 "
                f"bytes apart below 2**40 and P * ps below 2**31; got base "
                f"address {t.data_ptr()}, rows {row} bytes apart, "
                f"{P} x {ps} rows")
    if batch > TMA_MAX_ROWS:
        raise ValueError(f"the paged TMA kernel lists at most "
                         f"{TMA_MAX_ROWS} batch rows; got {batch}")


# (device, k, v, P, ps, KH, token stride) -> the two encoded maps; a pool
# is allocated once, so its maps are encoded once
_maps: "collections.OrderedDict[tuple, ctypes.Array]" = \
    collections.OrderedDict()
_MAX_MAPS = 64


def _tma_maps(lib, k_pages, v_pages) -> ctypes.Array:
    P, ps, KH, _ = k_pages.shape
    tok = k_pages.stride(1)
    key = (k_pages.device.index, k_pages.data_ptr(), v_pages.data_ptr(),
           P, ps, KH, tok)
    maps = _maps.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(2 * _MAP_BYTES)
        rc = lib.kftpu_paged_tma_maps(maps, k_pages.data_ptr(),
                                      v_pages.data_ptr(), P, ps, KH, tok)
        if rc != 0:
            raise ValueError(f"the paged pools' TMA maps could not be "
                             f"encoded (cudaError {rc}): pools "
                             f"{tuple(k_pages.shape)}, token stride {tok}")
        _maps[key] = maps
        while len(_maps) > _MAX_MAPS:
            _maps.popitem(last=False)
    else:
        _maps.move_to_end(key)
    return maps


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


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

    Returns ``(B, QH, Dh)`` in ``q.dtype``. On a CUDA device it is one
    launch of its route's kernel (:func:`paged_route`), which folds its
    splits itself through counters and a workspace kept per device
    (:func:`device_scratch`): calls on one device must run on one stream
    at a time.
    """
    _check(q, k_pages, v_pages, pages, positions)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, pages,
                                            positions, sm_scale=sm_scale)
    _require_cuda(q)
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
    group = QH // KH
    tma = paged_route(q.dtype, Dh, group) == autotune.PAGED_TMA_KERNEL
    if tma:
        check_paged_tma(k_pages, v_pages, B)
    lib = _lib()
    pps = _pages_per_split(lib, q, KH, ps, n_log)
    n_splits = -(-n_log // pps)
    scale = float(sm_scale if sm_scale is not None else Dh ** -0.5)
    out = torch.empty_like(q)
    # per-split partials (acc, then m/l) of each block of at most
    # MAX_HEAD_BLOCK q heads, folded by the unit's last split
    n_hb = -(-group // MAX_HEAD_BLOCK)
    n_part = B * KH * n_hb * n_splits * min(group, MAX_HEAD_BLOCK)
    counters, ws = device_scratch(q.device, B * KH * n_hb,
                                  n_part * (Dh + 2))
    ws_ml = ws.data_ptr() + n_part * Dh * 4
    with torch.cuda.device(q.device):
        if tma:
            maps = _tma_maps(lib, k_pages, v_pages)
            rc = lib.kftpu_paged_decode_tma(
                maps, q.data_ptr(), pages.data_ptr(), positions.data_ptr(),
                out.data_ptr(), ws.data_ptr(), ws_ml, counters.data_ptr(),
                B, QH, KH, P, ps, n_log, pps, _sm_count(q.device.index),
                scale, _stream(q))
        else:
            rc = lib.kftpu_paged_decode_attention(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                pages.data_ptr(), positions.data_ptr(), out.data_ptr(),
                ws.data_ptr(), ws_ml, counters.data_ptr(), B, QH, KH, Dh, P,
                ps, n_log, pps, scale, int(q.dtype == torch.bfloat16), tok,
                _stream(q))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches["paged_decode_attention"] += 1
    if tma:
        launches["paged_decode_tma"] += 1
    return out
