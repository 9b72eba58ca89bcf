"""The host side of the wgmma flash backward (``ops/flash_attention.py``).

The bf16 D = 64 dQ and dK/dV kernels walk a work list that the wrapper
computes (:func:`wgmma_work`): one item per 128-row block tile with the
range of 64-row tiles it streams. Here each item's range is held against
the reference's causal loop limits (``kubeflow_tpu/ops/attention.py``
``_first_live_q`` and ``_last_live_kv``) at the same block sizes, every
tile appears once, and the heaviest come first. Then the wrappers: with
the library replaced by a fake, a stride or base that a TMA map cannot
encode is refused before any launch, a view of a fused projection is
handed to the library with the kernel's own tile and list, and CPU
tensors take the plain path and count no launch.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import _first_live_q, _last_live_kv
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import flash_attention as fa

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 128, 1000, 8192])
def test_work_list_ranges_match_the_reference(kernel, causal, S):
    """Each item's streamed range is the reference's at the kernel's
    block sizes: dK/dV from ``_first_live_q`` to the last q tile, dQ
    from 0 to ``_last_live_kv`` + 1 (every tile without causality)."""
    block_q, block_k = at.WGMMA_TILES[kernel]
    n_q, n_kv = -(-S // block_q), -(-S // block_k)
    for tile, first, end in fa.wgmma_work(kernel, S, causal):
        if kernel == "flash_bwd_dkv":
            want = (_first_live_q(tile, block_q, block_k) if causal else 0,
                    n_q)
        else:
            want = (0, min(n_kv, _last_live_kv(tile, block_q, block_k) + 1)
                    if causal else n_kv)
        assert (first, end) == want, (tile, first, end)
        assert 0 <= first < end


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 128, 1000, 8192])
def test_work_list_holds_every_tile_once_heaviest_first(kernel, causal, S):
    """One item per block tile of the kernel's own size, none twice, in
    order of the tiles each streams (most first; ties by tile)."""
    block_q, block_k = at.WGMMA_TILES[kernel]
    own = block_k if kernel == "flash_bwd_dkv" else block_q
    work = fa.wgmma_work(kernel, S, causal)
    assert sorted(t for t, _, _ in work) == list(range(-(-S // own)))
    sizes = [end - first for _, first, end in work]
    assert sizes == sorted(sizes, reverse=True)
    for (t0, f0, e0), (t1, f1, e1) in zip(work, work[1:]):
        assert e0 - f0 > e1 - f1 or t0 < t1


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_wrapper_runs_the_tile_the_table_resolves(kernel):
    """The tile a launch takes (``_wgmma_route``) is what ``resolve_flash``
    falls back to for the shape: the wgmma tile for bf16 at D <= 64
    (padded to 64), 64 x 64 otherwise."""
    for D, dtype in ((64, torch.bfloat16), (32, torch.bfloat16),
                     (128, torch.bfloat16), (64, torch.float32)):
        with at.table_override(at.TileTable([], [])):
            cfg = at.resolve_flash(kernel, seq=512, head_dim=D, n_heads=4,
                                   n_kv_heads=4, dtype=dtype, causal=True,
                                   generation="sm_90")
        width = fa.padded_head_dim(D)
        tensors = [torch.zeros(1, 512, 4, width, dtype=dtype, device="meta")
                   for _ in range(4)]
        block_q, block_k, _, n_work = fa._wgmma_route(kernel, tensors, True)
        assert (cfg.source, cfg.block_q, cfg.block_k) == (
            "fallback", block_q, block_k)
        assert (n_work > 0) == (dtype == torch.bfloat16 and D <= 64)


class _FakeLib:
    """Stands in for the built library: records each launch's arguments
    and reports success."""

    def __init__(self):
        self.calls = []

    def _record(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn

    def __getattr__(self, name):
        if name.startswith("kftpu_"):
            return self._record(name)
        raise AttributeError(name)


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers' CUDA branch on ``meta`` tensors (which have no
    device to launch on): ``_cuda_args``'s row check and launch
    arguments without its device check, the fake library, and launch
    counters of their own."""
    lib = _FakeLib()
    monkeypatch.setattr(fa, "_cuda_args", _meta_args)
    monkeypatch.setattr(fa, "_lib", lambda: lib)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "launches", dict.fromkeys(fa.launches, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoDevice())
    return lib


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _meta_args(q, tensors, kv_len, rows_16b=False):
    """``_cuda_args``'s row check and launch arguments, for meta
    tensors."""
    import ctypes

    if rows_16b and q.dtype == torch.bfloat16:
        fa.check_rows_16b(tensors)
    strides = (ctypes.c_longlong * (3 * len(tensors)))(
        *[st for t in tensors for st in fa.tma_strides(t)])
    B, S, H, D = q.shape
    return strides, None, (B, H, S, D)


def _bwd_inputs(q):
    """k, v, dO (contiguous) and lse, delta beside ``q`` (meta)."""
    k, v, g = (torch.zeros(q.shape, dtype=q.dtype, device="meta")
               for _ in range(3))
    stats = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device="meta")
    return k, v, g, stats, stats


def _call(wrapper, q, k, v, g, lse, delta, causal=True):
    fn = getattr(fa, wrapper)
    return fn(q, k, v, g, lse, delta, causal=causal)


BAD_VIEWS = {
    # (b, s, h) strides past what a TMA map encodes (2**40 bytes)
    "stride_past_2_40": lambda: torch.empty_strided(
        (2, 256, 2, 64), (1 << 40, 128, 64, 1), dtype=torch.bfloat16,
        device="meta"),
    # rows 136 bytes apart: not a multiple of 16
    "row_stride_off_16": lambda: torch.zeros(
        2, 256, 2, 68, dtype=torch.bfloat16, device="meta")[..., :64],
    # heads 72 bytes apart
    "head_stride_off_16": lambda: torch.empty_strided(
        (2, 256, 2, 64), (256 * 2 * 64, 2 * 64, 36, 1),
        dtype=torch.bfloat16, device="meta"),
}


@pytest.mark.parametrize("wrapper", KERNELS)
@pytest.mark.parametrize("view", sorted(BAD_VIEWS))
def test_wrapper_refuses_what_a_tma_map_cannot_encode(fake_lib, wrapper,
                                                      view):
    """A q a TMA map cannot describe raises before the library is
    called, and no launch is counted."""
    q = BAD_VIEWS[view]()
    with pytest.raises(ValueError, match="16 bytes"):
        _call(wrapper, q, *_bwd_inputs(q))
    assert fake_lib.calls == [] and fa.launches[wrapper] == 0


def test_check_tma_refuses_a_base_off_16_bytes():
    """A base 2 bytes past a 16-byte boundary (a CPU tensor: meta
    tensors have no address) is refused by the check itself; the
    aligned tensor beside it passes."""
    flat = torch.zeros(2 * 64 * 2 * 64 + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    fa.check_tma([flat[:2 * 64 * 2 * 64].view(2, 64, 2, 64)])
    with pytest.raises(ValueError, match="16 bytes"):
        fa.check_tma([flat[1:1 + 2 * 64 * 2 * 64].view(2, 64, 2, 64)])


@pytest.mark.parametrize("wrapper", KERNELS)
@pytest.mark.parametrize("causal", [True, False])
def test_fused_projection_view_reaches_the_library(fake_lib, wrapper,
                                                   causal):
    """q, k and v as views of one (B, S, 3, H, D) tensor pass the checks
    and reach the library once, with the kernel's tile and work list."""
    qkv = torch.zeros(2, 1000, 3, 2, 64, dtype=torch.bfloat16,
                      device="meta")
    q, k, v = (qkv[:, :, i] for i in range(3))
    g = torch.zeros(2, 1000, 2, 64, dtype=torch.bfloat16, device="meta")
    stats = torch.zeros(2, 2, 1000, device="meta")
    _call(wrapper, q, k, v, g, stats, stats, causal=causal)
    (name, args), = fake_lib.calls
    assert name == f"kftpu_{wrapper}"
    strides = list(args[8 if wrapper == "flash_bwd_dq" else 9])
    assert strides[:3] == [1000 * 3 * 2 * 64, 3 * 2 * 64, 64]
    tail = args[-11:]   # B, H, S, D, n_work, block_q, block_k, ...
    assert tail[:4] == (2, 2, 1000, 64)
    assert tail[4] == len(fa.wgmma_work(wrapper, 1000, causal))
    assert tuple(tail[5:7]) == at.WGMMA_TILES[wrapper]
    assert fa.launches[wrapper] == 1


@pytest.mark.parametrize("wrapper", KERNELS)
def test_cpu_tensors_take_the_plain_path_and_count_no_launch(fake_lib,
                                                             wrapper):
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 70, 2, 64))
                                   .astype(np.float32)).bfloat16()
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(g, out)
    before = dict(fa.launches)
    _call(wrapper, q, k, v, g, lse, delta)
    assert fake_lib.calls == [] and fa.launches == before
