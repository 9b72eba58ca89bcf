"""The host side of the wgmma flash forward (``ops/flash_attention.py``).

The bf16 D = 64 forward walks the work list the wrapper computes
(:func:`wgmma_work`): one item per 128-row q tile with the range of
64-key kv tiles it streams. Each item's range is held against the
reference's ``_last_live_kv`` (``kubeflow_tpu/ops/attention.py``) at the
same block sizes, every tile appears once, the heaviest come first, and
it covers the blocks the backward's list covers.
Then the wrapper, with the library replaced by the fake of
``test_torch_flash_bwd_schedule.py``: a stride or base that a TMA map
cannot encode is refused before any launch, a view of a fused QKV
projection reaches the library with the kernel's tile and list, the
other kernels (f32, D = 128) get the 64 x 64 tile and no list, and CPU
tensors take the plain path and count no launch.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import _last_live_kv
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import flash_attention as fa
from test_torch_flash_bwd_schedule import BAD_VIEWS, fake_lib  # noqa: F401

SEQS = [64, 128, 1000, 8192]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_work_list_ranges_match_the_reference(causal, S):
    """Each q tile streams kv tiles from 0 to the reference's
    ``_last_live_kv`` + 1 at 128 x 64 (every tile without causality)."""
    block_q, block_k = at.WGMMA_TILES["flash_fwd"]
    assert (block_q, block_k) == (128, 64)
    n_kv = -(-S // block_k)
    for tile, first, end in fa.wgmma_work("flash_fwd", S, causal):
        want = (0, min(n_kv, _last_live_kv(tile, block_q, block_k) + 1)
                if causal else n_kv)
        assert (first, end) == want, (tile, first, end)
        assert 0 <= first < end


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_work_list_holds_every_tile_once_heaviest_first(causal, S):
    """One item per 128-row q tile, none twice, in order of the kv tiles
    each streams (most first; ties by tile)."""
    work = fa.wgmma_work("flash_fwd", S, causal)
    assert sorted(t for t, _, _ in work) == list(range(-(-S // 128)))
    sizes = [end - first for _, first, end in work]
    assert sizes == sorted(sizes, reverse=True)
    for (t0, f0, e0), (t1, f1, e1) in zip(work, work[1:]):
        assert e0 - f0 > e1 - f1 or t0 < t1


def _live_blocks(kernel, S, causal):
    """The 64 x 64 (q rows, keys) blocks a wgmma kernel's list walks, less
    those wholly past S or wholly above the causal diagonal (which the
    kernels skip)."""
    block_q, block_k = at.WGMMA_TILES[kernel]
    blocks = set()
    for tile, first, end in fa.wgmma_work(kernel, S, causal):
        if kernel == "flash_fwd":     # q tiles of 128 rows, 64-key stages
            rows = range(2 * tile, 2 * tile + 2)
            keys = range(first, end)
        else:                         # kv tiles of 128 keys, 64-row stages
            rows = range(first, end)
            keys = range(2 * tile, 2 * tile + 2)
        blocks |= {(r, c) for r in rows for c in keys
                   if 64 * r < S and 64 * c < S and not (causal and c > r)}
    return blocks


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_forward_walks_dqs_list(causal, S):
    """The forward walks the pairs dQ sums over: its list (128-row q
    tiles streaming 64-key stages) and the one-pass backward's (128-key
    tiles streaming 64-row q stages), each cut into 64 x 64 blocks, cover
    the same live blocks, so the backward's P is made over the keys the
    forward's was."""
    n = -(-S // 64)
    want = {(r, c) for r in range(n) for c in range(n)
            if not (causal and c > r)}
    assert _live_blocks("flash_fwd", S, causal) == want
    assert _live_blocks("flash_bwd", S, causal) == want


@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32)])
def test_the_wrapper_runs_the_tile_the_table_resolves(D, dtype):
    """The tile a forward launch takes is what ``resolve_flash`` falls
    back to for the shape: 128 x 64 with a list for bf16 at D <= 64
    (padded to 64), 64 x 64 and none otherwise."""
    with at.table_override(at.TileTable([], [])):
        cfg = at.resolve_flash("flash_fwd", seq=512, head_dim=D, n_heads=4,
                               n_kv_heads=4, dtype=dtype, causal=True,
                               generation="sm_90")
    width = fa.padded_head_dim(D)
    tensors = [torch.zeros(1, 512, 4, width, dtype=dtype, device="meta")
               for _ in range(3)]
    block_q, block_k, _, n_work = fa._wgmma_route("flash_fwd", tensors, True)
    assert (cfg.source, cfg.block_q, cfg.block_k) == (
        "fallback", block_q, block_k)
    assert (n_work > 0) == (dtype == torch.bfloat16 and D <= 64)


def _fwd_tail(args):
    """``(B, H, S, D, n_work, block_q, block_k)`` of a recorded
    ``kftpu_flash_fwd`` call, and its work pointer."""
    return tuple(args[8:15]), args[7]


@pytest.mark.parametrize("view", sorted(BAD_VIEWS))
def test_wrapper_refuses_what_a_tma_map_cannot_encode(fake_lib, view):
    """A q a TMA map cannot describe raises before the library is
    called, and no launch is counted."""
    q = BAD_VIEWS[view]()
    k, v = (torch.zeros(q.shape, dtype=q.dtype, device="meta")
            for _ in range(2))
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_fwd(q, k, v)
    assert fake_lib.calls == [] and fa.launches["flash_fwd"] == 0


def test_a_stride_past_the_map_on_k_or_v_is_refused(fake_lib):
    """k and v are read through maps too: either one out of a map's
    reach raises before the library is called."""
    good = torch.zeros(2, 256, 2, 64, dtype=torch.bfloat16, device="meta")
    bad = BAD_VIEWS["stride_past_2_40"]()
    for args in ((good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="TMA map"):
            fa.flash_fwd(*args)
    assert fake_lib.calls == [] and fa.launches["flash_fwd"] == 0


@pytest.mark.parametrize("causal", [True, False])
def test_fused_projection_view_reaches_the_library(fake_lib, causal):
    """q, k and v as views of one (B, S, 3, H, D) tensor pass the checks
    and reach the library once, with the kernel's tile and work list."""
    qkv = torch.zeros(2, 1000, 3, 2, 64, dtype=torch.bfloat16,
                      device="meta")
    q, k, v = (qkv[:, :, i] for i in range(3))
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    (name, args), = fake_lib.calls
    assert name == "kftpu_flash_fwd"
    assert list(args[6])[:3] == [1000 * 3 * 2 * 64, 3 * 2 * 64, 64]
    tail, work = _fwd_tail(args)
    assert tail == (2, 2, 1000, 64,
                    len(fa.wgmma_work("flash_fwd", 1000, causal)), 128, 64)
    assert work is not None
    assert args[15:17] == (0.125, int(causal))
    assert out.shape == (2, 1000, 2, 64) and lse.shape == (2, 2, 1000)
    assert fa.launches["flash_fwd"] == 1


@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (64, torch.float32)])
def test_other_kernels_get_the_64_tile_and_no_list(fake_lib, D, dtype):
    """Off the wgmma route (D = 128, f32) the library gets the 64 x 64
    tile and a null list, and no TMA check runs."""
    q, k, v = (torch.zeros(2, 200, 2, D, dtype=dtype, device="meta")
               for _ in range(3))
    fa.flash_fwd(q, k, v)
    (name, args), = fake_lib.calls
    tail, work = _fwd_tail(args)
    assert tail == (2, 2, 200, D, 0, 64, 64) and work is None


def test_cpu_tensors_take_the_plain_path_and_count_no_launch(fake_lib):
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v)
    want, want_lse = fa.flash_fwd_plain(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert fake_lib.calls == [] and fa.launches == before
