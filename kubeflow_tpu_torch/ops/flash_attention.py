"""Flash attention kernels: the forward (out and lse) and the backward
(dQ, dK and dV).

Counterpart of the three Pallas kernels of
``kubeflow_tpu/ops/attention.py`` (``_flash_fwd_kernel``,
``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``). The CUDA kernels
live in ``csrc/flash_attention.cu``; its source note says what bounds
them and how they are laid out. The autograd function that strings them
together is ``ops/attention.py:flash_attention``.

- :func:`flash_fwd` and :func:`flash_bwd` — the wrappers. A CUDA tensor
  launches the kernel (or raises); a CPU tensor takes the plain version.
  No fallback in between. At bf16 and D <= 64 :func:`flash_bwd` is one
  kernel for dQ, dK and dV (counted under ``flash_bwd``); elsewhere it
  launches the dQ kernel and the dK/dV kernel (counted under
  ``flash_bwd_dq`` and ``flash_bwd_dkv``). :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv` compute one part each: at bf16 and D <= 64 they
  run :func:`flash_bwd` and return their part of it.
- ``*_plain`` — the plain PyTorch versions: the same arithmetic on
  whole (S, S) score matrices. Scores come from q pre-scaled in f32;
  masked scores are ``NEG_INF`` (finite); the forward's online softmax
  steps over the kernels' key blocks (``BLOCK_K``) and rounds P to the V
  dtype before P·V; the backward recomputes ``P = exp(s - lse)`` and
  keeps dS in f32.

Tensors are ``(B, S, H, D)`` (K and V already GQA-repeated, as at the
model's call site); ``lse`` and ``delta`` are ``(B, H, S)`` f32;
``kv_len`` is an optional ``(B,)`` int32 valid length per batch row.

The bf16 kernels (forward, dQ and dK/dV) stage rows with 16-byte
copies: their wrappers raise (:func:`check_rows_16b`) on a bf16 input
whose rows do not start on 16 bytes, rather than copy it. At bf16 and
D = 64 the forward and the fused backward are wgmma kernels that read
q, k, v and dO through TMA maps, and the wrappers also refuse what a map
cannot encode (:func:`check_tma`). The forward owns 192 q rows an item,
or 64 where that grid ends first on the card's SMs
(``autotune.flash_tile``), over 64-key stages, on a persistent grid;
the backward owns 128 keys a block over 64-row q stages. Each walks a
work list (:func:`wgmma_work`): one item a block tile with the range of
tiles it streams, the causal ranges of the reference's ``_last_live_kv``
(forward) and ``_first_live_q`` (backward); it is made once a shape and
kept on the card. The backward's list is one head's, in descending kv
tile: the order in which its blocks add dQ's partials into each q tile,
which the persistent grid takes head by head.

The kernels are built for the head dims of ``HEAD_DIMS``, and past
the largest for any multiple of ``WIDE_STEP`` (the wide kernels, which
sum the scores over 64-wide slices of D). Any other D runs at the next
of those widths: the wrappers zero-pad q, k, v and dO along D
(:func:`pad_head_dim`), take the scale from the true D, and slice the
results back (:func:`unpad_head_dim`). Zero columns add nothing to the
scores or to ``delta``, and the padded output and gradient columns come
out zero, so this is exact. No head dim is refused.

``launches`` counts kernel launches by kernel name (never plain calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from kubeflow_tpu_torch.ops import autotune
from kubeflow_tpu_torch.ops.attention import NEG_INF
from kubeflow_tpu_torch.ops.autotune import (
    FLASH_TILE,
    WGMMA_HEAD_DIM,
    WGMMA_TILES,
    flash_tile,
)

launches = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
HEAD_DIMS = (64, 128, 256)   # the head dims the CUDA kernels are built for
WIDE_STEP = 64          # past HEAD_DIMS[-1], any multiple of it (kDC in csrc)
BLOCK_K = 64   # the forward kernels' key block (kBK, kFwdStep in csrc)
TMA_MAX_STRIDE = 1 << 40  # bytes: a TMA map's strides lie below it


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def padded_head_dim(D: int) -> int:
    """The built head dim a ``D``-wide input runs at: the smallest of
    ``HEAD_DIMS`` that holds it, and past the largest, ``D`` rounded up
    to a multiple of ``WIDE_STEP``."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    return -(-D // WIDE_STEP) * WIDE_STEP


def pad_head_dim(tensors, width: int) -> tuple:
    """Each ``(B, S, H, D)`` tensor zero-padded along D to ``width`` (the
    tensor itself where D is already ``width``)."""
    return tuple(t if t.shape[-1] == width else
                 torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def unpad_head_dim(tensors, D: int) -> tuple:
    """Each tensor's first ``D`` columns of its last dim, contiguous (the
    tensor itself where it is ``D`` wide)."""
    return tuple(t if t.shape[-1] == D else t[..., :D].contiguous()
                 for t in tensors)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Where the sums run: f32, or f64 for f64 inputs (the plain path's
    ``gradcheck``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(_acc_dtype(t.dtype))


def _check(q, k, v, *extra, kv_len=None) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)) + tuple(
            (f"input {i}", t) for i, t in enumerate(extra)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)} (repeat GQA heads first)")
        if t.dtype != q.dtype:
            raise TypeError("q, k, v and dO must share one dtype")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"dtype {q.dtype} not supported (f32, bf16; f64 "
                        "on the CPU)")
    if kv_len is not None and kv_len.shape != (q.shape[0],):
        raise ValueError(f"kv_len must be ({q.shape[0]},)")
    devs = {t.device for t in (q, k, v) + tuple(extra)}
    if kv_len is not None:
        devs.add(kv_len.device)
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def flash_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = Σ_d dO·O`` per row, ``(B, H, S)`` in f32 (f64 for f64
    inputs): the plain op the backward passes read beside ``lse``."""
    acc = _acc_dtype(out.dtype)
    return (g.to(acc) * out.to(acc)).sum(dim=-1).transpose(1, 2).contiguous()


def _scores(q, k, causal: bool, scale: float, kv_len):
    """Masked f32 scores (B, H, S, T) from q pre-scaled in f32."""
    s = torch.einsum("bshd,bthd->bhst", _wide(q) * scale, _wide(k))
    S, T = q.shape[1], k.shape[1]
    pos = torch.arange(T, device=q.device)
    if causal:
        live = pos[None, :] <= torch.arange(S, device=q.device)[:, None]
        s = s.masked_fill(~live[None, None], NEG_INF)
    if kv_len is not None:
        valid = pos[None, :] < kv_len.long()[:, None]
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    return s


def flash_fwd_plain(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, kv_len=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd` (see the module docstring).

    The online softmax runs over key blocks of ``BLOCK_K``, the blocks
    every forward kernel steps over (as the Pallas kernel steps over its
    ``block_k``), so P is rounded to the V dtype at the same running max
    and a bf16 result can be held to the kernel within f32 summation
    order."""
    s = _scores(q, k, causal, _scale(q, sm_scale), kv_len)
    B, H, S, T = s.shape
    m = torch.full((B, H, S, 1), NEG_INF, dtype=s.dtype, device=s.device)
    den = torch.zeros_like(m)
    acc = torch.zeros((B, H, S, q.shape[-1]), dtype=s.dtype, device=s.device)
    for t0 in range(0, T, BLOCK_K):
        st = s[..., t0:t0 + BLOCK_K]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.exp(st - m_new)
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhst,bthd->bhsd", _wide(p.to(v.dtype)),
            _wide(v[:, t0:t0 + BLOCK_K]))
        m = m_new
    den = den.clamp_min(1e-30)
    out = (acc / den).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(den))[..., 0]


def _grad_parts(q, k, v, g, lse, delta, causal, scale, kv_len):
    s = _scores(q, k, causal, scale, kv_len)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bshd,bthd->bhst", _wide(g), _wide(v))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, g, lse, delta, *, causal: bool = True,
                       sm_scale: Optional[float] = None, kv_len=None
                       ) -> torch.Tensor:
    """Plain version of :func:`flash_bwd_dq`."""
    scale = _scale(q, sm_scale)
    _, ds = _grad_parts(q, k, v, g, lse, delta, causal, scale, kv_len)
    dq = torch.einsum("bhst,bthd->bshd", ds, _wide(k)) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, *, causal: bool = True,
                        sm_scale: Optional[float] = None, kv_len=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_bwd_dkv`."""
    scale = _scale(q, sm_scale)
    p, ds = _grad_parts(q, k, v, g, lse, delta, causal, scale, kv_len)
    dv = torch.einsum("bhst,bshd->bthd", p, _wide(g))
    dk = torch.einsum("bhst,bshd->bthd", ds, _wide(q) * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels --------------------------------------------------------


def _lib():
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if lib.kftpu_flash_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kftpu_flash_fwd.argtypes = [p] * 8 + [i] * 7 + [f, i, i, p, p]
        lib.kftpu_flash_bwd.argtypes = [p] * 14 + [i] * 7 + [f, i, i, p]
        lib.kftpu_flash_bwd_dq.argtypes = [p] * 9 + [i] * 4 + [f, i, i, p]
        lib.kftpu_flash_bwd_dkv.argtypes = [p] * 10 + [i] * 4 + [f, i, i, p]
        for fn in (lib.kftpu_flash_fwd, lib.kftpu_flash_bwd,
                   lib.kftpu_flash_bwd_dq, lib.kftpu_flash_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib


def check_rows_16b(tensors) -> None:
    """The bf16 flash kernels copy each head-dim row in 16-byte pieces
    (``cp.async``): raise unless every row of every tensor starts on 16
    bytes, i.e. its base pointer and its (b, s, h) strides (in bytes,
    over dims longer than 1) are multiples of 16."""
    for t in tensors:
        el = t.element_size()
        strides = [st * el for st, n in zip(t.stride()[:3], t.shape[:3])
                   if n > 1]
        if t.data_ptr() % 16 or any(st % 16 for st in strides):
            raise ValueError(
                "the bf16 flash kernels read rows that start on 16 bytes: "
                f"got base address {t.data_ptr()} and (b, s, h) strides "
                f"{tuple(t.stride()[:3])} of {el}-byte elements")


def tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """``t``'s (b, s, h) element strides as the kernels take them: a dim
    of one element is never stepped, so its stride (which PyTorch leaves
    free) is given as one row of the head dim."""
    return tuple(st if n > 1 else t.shape[-1]
                 for st, n in zip(t.stride()[:3], t.shape[:3]))


def check_tma(tensors) -> None:
    """The wgmma kernels load q, k, v (and dO) through 4-D TMA maps over
    (D, S, H, B): raise unless each tensor's base is on 16 bytes and its
    (b, s, h) strides (:func:`tma_strides`, in bytes) are multiples of 16
    below ``TMA_MAX_STRIDE``, what such a map encodes."""
    for t in tensors:
        el = t.element_size()
        strides = [st * el for st in tma_strides(t)]
        if t.data_ptr() % 16 or any(st % 16 or not 0 <= st < TMA_MAX_STRIDE
                                    for st in strides):
            raise ValueError(
                "the wgmma flash kernels read each input through a TMA "
                "map: its base must be on 16 bytes and its (b, s, h) "
                f"strides multiples of 16 bytes below 2**40; got base "
                f"address {t.data_ptr()} and strides {tuple(strides)} "
                "bytes")


def _first_live_q(j: int, block_q: int, block_k: int) -> int:
    """The reference's ``_first_live_q`` (attention.py :160)."""
    return (j * block_k) // block_q


def _last_live_kv(i: int, block_q: int, block_k: int) -> int:
    """The reference's ``_last_live_kv`` (attention.py :152)."""
    return (i * block_q + block_q - 1) // block_k


@functools.lru_cache(maxsize=64)
def wgmma_work(kernel: str, S: int, causal: bool,
               tile: Optional[Tuple[int, int]] = None
               ) -> Tuple[Tuple[int, int, int], ...]:
    """The wgmma kernel's work list at sequence length ``S``: one
    ``(tile, first, end)`` item per block tile of ``tile`` (by default
    its ``WGMMA_TILES``). The forward: ``block_q``-row q tiles (192, or
    64 on a short grid) streaming 64-key stages, causal ranges ending
    after ``_last_live_kv``, heaviest first (most streamed stages, then
    the lower tile). The backward (``flash_bwd``, one head's list):
    128-key kv tiles streaming 64-row q tiles, causal ranges starting at
    ``_first_live_q``, in descending kv tile, the order of dQ's adds. The
    kernels walk every tile for a batch row whose ``kv_len`` is 0, whose
    keys are all masked."""
    block_q, block_k = tile or WGMMA_TILES[kernel]
    n_q, n_kv = -(-S // block_q), -(-S // block_k)
    if kernel == "flash_bwd":
        return tuple((j, _first_live_q(j, block_q, block_k) if causal
                      else 0, n_q) for j in reversed(range(n_kv)))
    items = [(i, 0, min(n_kv, _last_live_kv(i, block_q, block_k) + 1)
              if causal else n_kv) for i in range(n_q)]
    return tuple(sorted(items, key=lambda it: (it[1] - it[2], it[0])))


@functools.lru_cache(maxsize=64)
def _work_tensor(kernel: str, S: int, causal: bool, tile: Tuple[int, int],
                 device: torch.device) -> torch.Tensor:
    """:func:`wgmma_work` as a ``(n, 3)`` int32 tensor on ``device``,
    made once a shape (the kernels only read it)."""
    return torch.tensor(wgmma_work(kernel, S, causal, tile),
                        dtype=torch.int32).to(device)


_FWD_COUNTERS: dict = {}


def _fwd_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The wgmma forward's two int32 counters for launches on ``stream``
    (csrc: the items taken and the blocks done; each launch leaves them
    zero), made once a (device, stream), so launches on other streams
    never share them."""
    key = (device, stream)
    counters = _FWD_COUNTERS.get(key)
    if counters is None:
        counters = _FWD_COUNTERS[key] = torch.zeros(2, dtype=torch.int32,
                                                    device=device)
    return counters


def fused_backward(q: torch.Tensor) -> bool:
    """Whether the wgmma kernels run for ``q`` (:func:`flash_bwd`'s one
    pass, and the forward's): bf16 at head dims up to ``WGMMA_HEAD_DIM``
    (padded to it)."""
    return (q.dtype == torch.bfloat16
            and padded_head_dim(q.shape[-1]) == WGMMA_HEAD_DIM)


def _wgmma_route(kernel: str, tensors, causal: bool):
    """``(block_q, block_k, work pointer, items)`` of one launch: the
    wgmma kernel's tile and work list after :func:`check_tma` where it
    runs (:func:`fused_backward`), else ``FLASH_TILE`` and no list. The
    forward's rows are those whose grid ends first on q's card
    (``autotune.flash_tile``); the backward has one tile."""
    q = tensors[0]
    if not fused_backward(q):
        return (*FLASH_TILE, None, 0)
    B, S, H, D = q.shape
    tile = flash_tile(kernel, D, q.dtype, batch_heads=B * H, seq=S,
                      sms=autotune.sm_count(q.device))
    check_tma(tensors)
    work = _work_tensor(kernel, S, causal, tile, q.device)
    return (*tile, work.data_ptr(), work.shape[0])


def _cuda_args(q, tensors, kv_len, rows_16b=False):
    """Check what the kernels take (with ``rows_16b``, that bf16 rows
    start on 16 bytes); returns (strides array, kv_len pointer, dims) for
    the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, S, H, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not supported by the CUDA "
                        "kernels (f32, bf16)")
    if padded_head_dim(D) != D:
        raise ValueError(f"head dim {D} must be padded to "
                         f"{padded_head_dim(D)} first (pad_head_dim)")
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("the head dim of q/k/v/dO must be contiguous")
    if rows_16b and q.dtype == torch.bfloat16:
        check_rows_16b(tensors)
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *[st for t in tensors for st in tma_strides(t)])
    if kv_len is not None:
        if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
            raise TypeError("kv_len must be a contiguous int32 tensor")
        len_ptr = kv_len.data_ptr()
    else:
        len_ptr = None
    return strides, len_ptr, (B, H, S, D)


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, causal: bool = True,
              sm_scale: Optional[float] = None, kv_len=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward: ``(out, lse)``, out ``(B, S, H, D)`` in q's dtype,
    lse ``(B, H, S)`` f32."""
    _check(q, k, v, kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len)
    scale, D0 = float(_scale(q, sm_scale)), q.shape[-1]
    q, k, v = pad_head_dim((q, k, v), padded_head_dim(D0))
    strides, len_ptr, (B, H, S, D) = _cuda_args(q, (q, k, v), kv_len,
                                                rows_16b=True)
    if fused_backward(q) and not scale > 0:
        raise ValueError(f"the bf16 flash forward takes scale > 0 (its "
                         f"row max runs on the raw products), got {scale}")
    block_q, block_k, work, n_work = _wgmma_route("flash_fwd", (q, k, v),
                                                  causal)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    counters = (_fwd_counters(q.device, stream).data_ptr()
                if fused_backward(q) else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        _launch("flash_fwd", lib.kftpu_flash_fwd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), len_ptr, out.data_ptr(), lse.data_ptr(),
                strides, work, B, H, S, D, n_work, block_q, block_k, scale,
                int(causal), int(q.dtype == torch.bfloat16), stream,
                counters)
    return unpad_head_dim((out,), D0)[0], lse


def _bwd_check(q, k, v, g, lse, delta, kv_len):
    _check(q, k, v, g, kv_len=kv_len)
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        want = _acc_dtype(q.dtype)
        if t.shape != (B, H, S) or t.dtype != want:
            raise ValueError(f"{name} must be ({B}, {H}, {S}) {want}")
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if q.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_bwd(q, k, v, g, lse, delta, *, causal: bool = True,
              sm_scale: Optional[float] = None, kv_len=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` of flash attention from the forward's ``lse`` and
    ``delta = Σ_d dO·O`` (both ``(B, H, S)`` f32); ``g`` is dO. At bf16
    and D <= 64 one kernel computes all three (one launch of
    ``flash_bwd``), adding dQ's partials in a fixed order into an f32
    workspace of its own; elsewhere the dQ and the dK/dV kernels."""
    _bwd_check(q, k, v, g, lse, delta, kv_len)
    if q.device.type == "cpu":
        return (flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                                   sm_scale=sm_scale, kv_len=kv_len),
                *flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                     sm_scale=sm_scale, kv_len=kv_len))
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
    if not fused_backward(q):
        return (_bwd_dq_kernel(q, k, v, g, lse, delta, **kw),
                *_bwd_dkv_kernel(q, k, v, g, lse, delta, **kw))
    scale, D0 = float(_scale(q, sm_scale)), q.shape[-1]
    q, k, v, g = pad_head_dim((q, k, v, g), padded_head_dim(D0))
    strides, len_ptr, (B, H, S, D) = _cuda_args(q, (q, k, v, g), kv_len,
                                                rows_16b=True)
    block_q, block_k, work, n_work = _wgmma_route("flash_bwd", (q, k, v, g),
                                                  causal)
    dev = q.device
    # the item counter, then the adds landed in each (head, q tile)
    counters = torch.zeros(1 + B * H * -(-S // block_q), dtype=torch.int32,
                           device=dev)
    ws = torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
                  for _ in range(3))
    lib = _lib()
    with torch.cuda.device(dev):
        _launch("flash_bwd", lib.kftpu_flash_bwd, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), len_ptr, dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), strides, work, counters.data_ptr(),
                ws.data_ptr(), B, H, S, D, n_work, block_q, block_k, scale,
                int(causal), 1, _stream(q))
    return unpad_head_dim((dq, dk, dv), D0)


def flash_bwd_dq(q, k, v, g, lse, delta, *, causal: bool = True,
                 sm_scale: Optional[float] = None, kv_len=None
                 ) -> torch.Tensor:
    """dQ of flash attention; arguments as :func:`flash_bwd`. At bf16 and
    D <= 64 on the card it is :func:`flash_bwd`'s dQ."""
    _bwd_check(q, k, v, g, lse, delta, kv_len)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
    if fused_backward(q):
        return flash_bwd(q, k, v, g, lse, delta, **kw)[0]
    return _bwd_dq_kernel(q, k, v, g, lse, delta, **kw)


def flash_bwd_dkv(q, k, v, g, lse, delta, *, causal: bool = True,
                  sm_scale: Optional[float] = None, kv_len=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of flash attention; arguments as :func:`flash_bwd`.
    At bf16 and D <= 64 on the card they are :func:`flash_bwd`'s."""
    _bwd_check(q, k, v, g, lse, delta, kv_len)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)
    if fused_backward(q):
        return flash_bwd(q, k, v, g, lse, delta, **kw)[1:]
    return _bwd_dkv_kernel(q, k, v, g, lse, delta, **kw)


def _bwd_dq_kernel(q, k, v, g, lse, delta, *, causal, sm_scale, kv_len):
    """The dQ kernel of every route but the fused one."""
    scale, D0 = float(_scale(q, sm_scale)), q.shape[-1]
    q, k, v, g = pad_head_dim((q, k, v, g), padded_head_dim(D0))
    strides, len_ptr, (B, H, S, D) = _cuda_args(q, (q, k, v, g), kv_len,
                                                rows_16b=True)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dq", lib.kftpu_flash_bwd_dq, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), len_ptr, dq.data_ptr(), strides, B, H, S,
                D, scale, int(causal), int(q.dtype == torch.bfloat16),
                _stream(q))
    return unpad_head_dim((dq,), D0)[0]


def _bwd_dkv_kernel(q, k, v, g, lse, delta, *, causal, sm_scale, kv_len):
    """The dK/dV kernel of every route but the fused one."""
    scale, D0 = float(_scale(q, sm_scale)), q.shape[-1]
    q, k, v, g = pad_head_dim((q, k, v, g), padded_head_dim(D0))
    strides, len_ptr, (B, H, S, D) = _cuda_args(q, (q, k, v, g), kv_len,
                                                rows_16b=True)
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        _launch("flash_bwd_dkv", lib.kftpu_flash_bwd_dkv, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), len_ptr, dk.data_ptr(), dv.data_ptr(),
                strides, B, H, S, D, scale, int(causal),
                int(q.dtype == torch.bfloat16), _stream(q))
    return unpad_head_dim((dk, dv), D0)
