"""The host side of the wgmma flash forward (``ops/flash_attention.py``).

The bf16 D = 64 forward walks the work list the wrapper computes
(:func:`wgmma_work`): one item per q tile of its rows (192, or 64 on a
short grid) with the range of 64-key stages it streams. Each item's
range is held against the reference's ``_last_live_kv``
(``kubeflow_tpu/ops/attention.py``) at the same block sizes, every tile
appears once, the heaviest come first, and it covers the blocks the
backward's list covers, at both tiles.
Then the wrapper, with the library replaced by the fake of
``test_torch_flash_bwd_schedule.py``: a stride or base that a TMA map
cannot encode is refused before any launch, a view of a fused QKV
projection reaches the library with the tile the shape class resolves
and its list, the other kernels (f32, D = 128) get the 64 x 64 tile and
no list, a scale the kernel cannot take is refused, and CPU tensors
take the plain path and count no launch.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import _last_live_kv
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import flash_attention as fa
from test_torch_flash_bwd_schedule import BAD_VIEWS, fake_lib  # noqa: F401

SEQS = [64, 128, 1000, 8192]
# the forward's two tiles: 192 q rows an item, and a short grid's 64
TILES = [(192, 64), (64, 64)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_work_list_ranges_match_the_reference(causal, S, tile):
    """Each q tile streams kv stages from 0 to the reference's
    ``_last_live_kv`` + 1 at its tile (every stage without causality)."""
    assert {at.WGMMA_TILES["flash_fwd"], at.WGMMA_FWD_SHORT_TILE} == set(
        TILES)
    block_q, block_k = tile
    n_kv = -(-S // block_k)
    for tile, first, end in fa.wgmma_work("flash_fwd", S, causal,
                                          (block_q, block_k)):
        want = (0, min(n_kv, _last_live_kv(tile, block_q, block_k) + 1)
                if causal else n_kv)
        assert (first, end) == want, (tile, first, end)
        assert 0 <= first < end


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_work_list_holds_every_tile_once_heaviest_first(causal, S, tile):
    """One item per q tile of the tile's rows, none twice, in order of
    the stages each streams (most first; ties by tile)."""
    work = fa.wgmma_work("flash_fwd", S, causal, tile)
    assert sorted(t for t, _, _ in work) == list(range(-(-S // tile[0])))
    sizes = [end - first for _, first, end in work]
    assert sizes == sorted(sizes, reverse=True)
    for (t0, f0, e0), (t1, f1, e1) in zip(work, work[1:]):
        assert e0 - f0 > e1 - f1 or t0 < t1


def _live_blocks(kernel, S, causal, tile=None):
    """The 64 x 64 (q rows, keys) blocks a wgmma kernel's list walks, less
    those wholly past S or wholly above the causal diagonal (which the
    kernels skip)."""
    block_q, block_k = tile or at.WGMMA_TILES[kernel]
    q64, k64 = block_q // 64, block_k // 64
    blocks = set()
    for t, first, end in fa.wgmma_work(kernel, S, causal, tile):
        if kernel == "flash_fwd":     # q tiles walking key stages
            rows = range(q64 * t, q64 * (t + 1))
            keys = range(k64 * first, k64 * end)
        else:                         # kv tiles walking q stages
            rows = range(q64 * first, q64 * end)
            keys = range(k64 * t, k64 * (t + 1))
        blocks |= {(r, c) for r in rows for c in keys
                   if 64 * r < S and 64 * c < S and not (causal and c > r)}
    return blocks


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_forward_walks_dqs_list(causal, S, tile):
    """The forward walks the pairs dQ sums over: its list (q tiles of
    either tile's rows streaming 64-key stages) and the one-pass
    backward's (128-key tiles streaming 64-row q stages), each cut into
    64 x 64 blocks, cover the same live blocks, so the backward's P is
    made over the keys the forward's was."""
    n = -(-S // 64)
    want = {(r, c) for r in range(n) for c in range(n)
            if not (causal and c > r)}
    assert _live_blocks("flash_fwd", S, causal, tile) == want
    assert _live_blocks("flash_bwd", S, causal) == want


@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (64, torch.float32)])
def test_the_wrapper_runs_the_tile_the_table_resolves(monkeypatch, D,
                                                      dtype):
    """The tile a forward launch takes on 132 SMs is what
    ``resolve_flash`` falls back to for the shape there: at bf16 and
    D <= 64 (padded to 64) a list and, with 32 items of 64 rows (a short
    grid), 64 x 64; 64 x 64 and none otherwise."""
    monkeypatch.setattr(at, "sm_count", lambda device: 132)
    with at.table_override(at.TileTable([], [])):
        cfg = at.resolve_flash("flash_fwd", seq=512, head_dim=D, n_heads=4,
                               n_kv_heads=4, dtype=dtype, causal=True,
                               batch=1, sms=132, generation="sm_90")
    width = fa.padded_head_dim(D)
    tensors = [torch.zeros(1, 512, 4, width, dtype=dtype, device="meta")
               for _ in range(3)]
    block_q, block_k, _, n_work = fa._wgmma_route("flash_fwd", tensors, True)
    assert (cfg.source, cfg.block_q, cfg.block_k) == (
        "fallback", block_q, block_k)
    wgmma = dtype == torch.bfloat16 and D <= 64
    assert (n_work > 0) == wgmma
    assert (block_q, block_k) == (64, 64)


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
    # 2 x 2 heads of 16 items of 64 rows: a short grid, 64 rows an item
    assert tail == (2, 2, 1000, 64, len(fa.wgmma_work(
        "flash_fwd", 1000, causal, (64, 64))), 64, 64)
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


@pytest.mark.parametrize("B,S,H,rows", [(2, 8192, 16, 192), (16, 512, 12, 192),
                                        (8, 512, 12, 64), (1, 128, 12, 64),
                                        (8, 128, 12, 64)])
def test_launch_arguments_at_the_timed_shapes(fake_lib, B, S, H, rows):
    """At the four timed shapes and the BERT entry point's, the library
    gets the rows whose grid ends first on 132 SMs, 64-key stages and
    that tile's list: 192 rows at the LM
    and BERT-base, 64 where the 192-row tile's last round would leave
    SMs idle ((8, 512): 288 items on 132 SMs) or an item a third empty
    (S = 128)."""
    q, k, v = (torch.zeros(B, S, H, 64, dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    fa.flash_fwd(q, k, v, causal=False)
    (name, args), = fake_lib.calls
    tail, work = _fwd_tail(args)
    n_work = len(fa.wgmma_work("flash_fwd", S, False, (rows, 64)))
    assert tail == (B, H, S, 64, n_work, rows, 64) and work is not None
    assert n_work == -(-S // rows)


@pytest.mark.parametrize("scale", [0.0, -0.125])
def test_a_scale_the_kernel_cannot_take_is_refused(fake_lib, scale):
    """The bf16 forward's row max runs on the raw products, which order
    as the scores only for scale > 0: another scale raises before the
    library is called."""
    q, k, v = (torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16,
                           device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="scale > 0"):
        fa.flash_fwd(q, k, v, sm_scale=scale)
    assert fake_lib.calls == [] and fa.launches["flash_fwd"] == 0


def test_counters_kept_per_device_and_stream(fake_lib):
    """The wgmma forward takes its item counters last: two int32 zeros
    made once a (device, stream) and handed to every launch there (the
    kernel leaves them zero); another stream gets its own, and the other
    kernels none."""
    q, k, v = (torch.zeros(1, 300, 2, 64, dtype=torch.bfloat16,
                           device="meta") for _ in range(3))
    fa.flash_fwd(q, k, v)
    fa.flash_fwd(q, k, v)
    (_, a1), (_, a2) = fake_lib.calls
    assert len(a1) == 20 and a1[19] is not None
    mine = fa._fwd_counters(q.device, 0)
    assert mine is fa._fwd_counters(q.device, 0)
    assert mine.shape == (2,) and mine.dtype == torch.int32
    assert fa._fwd_counters(q.device, 1) is not mine
    f32 = [t.float() for t in (q, k, v)]
    fa.flash_fwd(*f32)
    assert fake_lib.calls[-1][1][19] is None
