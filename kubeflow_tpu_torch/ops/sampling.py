"""Fused temperature → top-k → top-p → Gumbel-max sampler.

Counterpart of ``kubeflow_tpu/ops/sampling.py``. Both filters reduce to
per-row value thresholds over the ordered-int encoding of f32, found
EXACTLY without a sort, so the sampler keeps full-vocab support. The
CUDA kernel (``csrc/fused_sample.cu``) replaces the Pallas
``_fused_sample_kernel``: one thread-block cluster per row finds each
threshold by a radix select (four 8-bit digits) over histograms merged
through the cluster's shared memory; the plain version keeps the
reference's 32-step binary searches.

- :func:`fused_sample` — the wrapper. A CUDA tensor launches the kernel
  (or raises: a cluster launch the device refuses is an error, never a
  fall back to the plain version); a CPU tensor takes the plain
  version.
- :func:`fused_sample_plain` — the plain PyTorch version, the reference
  kernel's arithmetic written out over a ``(B, V)`` batch.

The Gumbel noise is an INPUT, as in the reference (whose wrapper draws
it from per-row keys outside the kernel): callers draw it per row from
``(seed, step)`` (:func:`gumbel_noise`), so a row's stream never depends
on its co-tenants, and tests hand both packages the same noise.

``launches`` counts kernel launches by kernel name (never plain calls).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from kubeflow_tpu_torch.ops.attention import NEG_INF

_SEARCH_ITERS = 32
_INT_MIN = -(2 ** 31)
_INT_MAX = 2 ** 31 - 1

launches = {"fused_sample": 0}


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 with int order == float order (no NaNs)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _mid(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Overflow-safe int32 midpoint over the full int32 range."""
    return (lo >> 1) + (hi >> 1) + (lo & hi & 1)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    """First index of each row's maximum (min index among the maxima)."""
    V = x.shape[-1]
    iota = torch.arange(V, device=x.device)
    hit = x >= x.amax(dim=-1, keepdim=True)
    return torch.where(hit, iota, V).amin(dim=-1)


def _per_row(x, B: int, dtype, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype,
                                              device=device), (B,))


def fused_sample_plain(logits, noise, temperature, top_k, top_p):
    """Plain PyTorch version of the fused sampler; ``(B,)`` int32."""
    B, V = logits.shape
    dev = logits.device
    logits = logits.float()
    temp = _per_row(temperature, B, torch.float32, dev)
    k = _per_row(top_k, B, torch.int32, dev)
    p = _per_row(top_p, B, torch.float32, dev)
    greedy = temp <= 0.0
    scaled = logits / torch.where(greedy, torch.ones_like(temp),
                                  temp)[:, None]
    ordered = _ordered_bits(scaled)

    # top-k: largest t with count(ordered >= t) >= k_eff
    k_eff = torch.where(k <= 0, torch.full_like(k, V), k.clamp(max=V))
    lo = torch.full((B,), _INT_MIN, dtype=torch.int32, device=dev)
    hi = torch.full((B,), _INT_MAX, dtype=torch.int32, device=dev)
    for _ in range(_SEARCH_ITERS):
        mid = _mid(lo, hi)
        ge = (ordered >= mid[:, None]).sum(dim=-1) >= k_eff
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    kmask = ordered >= lo[:, None]

    # top-p over the k-filtered renormalised distribution
    m = torch.where(kmask, scaled, NEG_INF).amax(dim=-1, keepdim=True)
    e = torch.where(kmask, torch.exp(scaled - m), 0.0)
    target = p * e.sum(dim=-1)
    lo = torch.full((B,), _INT_MIN, dtype=torch.int32, device=dev)
    hi = torch.full((B,), _INT_MAX, dtype=torch.int32, device=dev)
    for _ in range(_SEARCH_ITERS):
        mid = _mid(lo, hi)
        mass = torch.where(kmask & (ordered > mid[:, None]), e,
                           0.0).sum(dim=-1)
        below = mass < target
        lo, hi = torch.where(below, lo, mid), torch.where(below, mid, hi)
    p_thresh = torch.where(kmask & (ordered >= hi[:, None]), ordered,
                           _INT_MAX).amin(dim=-1)
    pmask = kmask & (ordered >= p_thresh[:, None])
    mask = torch.where((p >= 1.0)[:, None], kmask, pmask)

    score = torch.where(mask, scaled + noise.float(), NEG_INF)
    out = torch.where(greedy, _first_max(logits), _first_max(score))
    return out.to(torch.int32)


_M64 = (1 << 64) - 1


def noise_seed(seed: int, step: int) -> int:
    """The generator seed of ``(seed, step)``: the packed pair through
    splitmix64's finaliser, so its low 32 bits (all the CPU generator
    keeps) depend on both halves."""
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def uniform_to_gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def gumbel_noise(seeds: Sequence[int], steps: Sequence[int], V: int, *,
                 device) -> torch.Tensor:
    """``(B, V)`` f32 Gumbel noise, row ``i`` drawn from a generator
    seeded by ``(seeds[i], steps[i])`` alone — the engine's per-row
    reproducibility contract (the reference keys ``fold_in(key(seed),
    step)``; torch and jax.random never draw the same bits)."""
    dev = torch.device(device)
    rows = []
    for seed, step in zip(seeds, steps):
        gen = torch.Generator(device=dev)
        gen.manual_seed(noise_seed(seed, step))
        rows.append(torch.rand((V,), generator=gen, device=dev))
    return uniform_to_gumbel(torch.stack(rows))


_max_vocab: dict = {}  # device index → largest V with the row on chip


def _lib():
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("fused_sample")
    fn = lib.kftpu_fused_sample
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
        init = lib.kftpu_fused_sample_init
        init.argtypes = []
        init.restype = ctypes.c_int
    return lib


def _device_max_vocab(lib, index: int) -> int:
    """Prepare the kernel on the current device once; the largest V whose
    row its clusters hold in shared memory. Raises if the device cannot
    hold a cluster of it."""
    if index not in _max_vocab:
        rc = lib.kftpu_fused_sample_init()
        if rc < 0:
            raise RuntimeError(f"fused_sample init failed: cudaError {-rc}")
        if rc == 0:
            raise RuntimeError("fused_sample: no cluster of the kernel fits "
                               "this device (cudaOccupancyMaxActiveClusters "
                               "is 0)")
        _max_vocab[index] = rc
    return _max_vocab[index]


def fused_sample(logits, noise, temperature, top_k, top_p):
    """Sample ``(B,)`` int32 token ids from ``(B, V)`` f32 logits.

    ``noise`` is ``(B, V)`` f32 Gumbel noise; ``temperature``/``top_k``/
    ``top_p`` are per-row ``(B,)`` tensors (f32, int32, f32) or scalars.
    Semantics match the reference: temperature <= 0 → argmax of the raw
    logits; top_k <= 0 → no k filter; top_p >= 1 → no p filter.
    """
    if logits.dim() != 2 or noise.shape != logits.shape:
        raise ValueError(f"logits and noise must both be (B, V); got "
                         f"{tuple(logits.shape)} and {tuple(noise.shape)}")
    if logits.dtype != torch.float32 or noise.dtype != torch.float32:
        raise TypeError("logits and noise must be float32")
    B, V = logits.shape
    dev = logits.device
    temp = _per_row(temperature, B, torch.float32, dev).contiguous()
    k = _per_row(top_k, B, torch.int32, dev).contiguous()
    p = _per_row(top_p, B, torch.float32, dev).contiguous()
    if noise.device != dev:
        raise ValueError("logits and noise must be on one device")
    if dev.type == "cpu":
        return fused_sample_plain(logits, noise, temp, k, p)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (logits.is_contiguous() and noise.is_contiguous()):
        raise ValueError("logits and noise must be contiguous")
    lib = _lib()
    with torch.cuda.device(dev):
        max_v = _device_max_vocab(lib, torch.cuda.current_device())
        # a row past the clusters' shared memory lives in device memory
        ws = (torch.empty((B, V), dtype=torch.float32, device=dev)
              if V > max_v else None)
        out = torch.empty((B,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kftpu_fused_sample(
            logits.data_ptr(), noise.data_ptr(), temp.data_ptr(),
            k.data_ptr(), p.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, V, stream)
    if rc != 0:
        raise RuntimeError(f"fused_sample kernel launch failed: "
                           f"cudaError {rc}")
    launches["fused_sample"] += 1
    return out
