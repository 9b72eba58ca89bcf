"""The host side of the paged TMA kernel (``ops/paged_attention.py``).

bf16 at head dim 64 and GQA groups of at most 8 run
``paged_decode_tma_kernel``, whose blocks each compute a work list of
live pages on the card. :func:`paged_work` mirrors that list: on random
page tables and positions every mapped live page of every (row, kv head)
appears exactly once and no sentinel or dead page does; rows are whole
units where they fill the card; a split row's ranges come in order;
heavier units come first; :func:`paged_deal` hands each unit to one
block. The live pages are held against the gate of the reference's
``_paged_decode_kernel`` (``kubeflow_tpu/ops/paged_attention.py``).

Then the wrapper, with the library replaced by a fake that records its
calls (as ``test_torch_flash_bwd_schedule.py`` does): bf16 Dh 64 at
groups up to 8 reaches the TMA entry point with the encoded maps, which
are encoded once a pool; f32, Dh 96 and a group of 16 reach the other
kernel; a pool a TMA map cannot describe and a batch past the list are
refused before any call; CPU tensors take the plain path and count no
launch.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import paged_attention as pa


def _table(rng, B, n_log, P, *, sentinel_holes=True):
    """Random rows: positions from -1 (no key) to past the context, page
    ids from a shuffled pool, some rows' dead pages left mapped, some
    unmapped, a few live pages made the sentinel, one row all sentinel."""
    ps = 16
    pages = rng.permutation(P)[:B * n_log].reshape(B, n_log).astype(np.int32)
    positions = rng.integers(-1, n_log * ps + 4, size=B).astype(np.int32)
    for b in range(B):
        if rng.random() < 0.5:
            pages[b, max(0, positions[b]) // ps + 1:] = P
        if sentinel_holes and rng.random() < 0.3:
            pages[b, rng.integers(0, n_log)] = P
    pages[rng.integers(0, B)] = P
    return pages, positions, ps


def _live(pages, positions, P, ps):
    """Each row's live pages by the reference kernel's own gate
    (``_paged_decode_kernel``: ``j * page_size <= pos`` and the entry is
    not the sentinel)."""
    return [[j for j in range(len(row)) if j * ps <= pos and row[j] != P]
            for row, pos in zip(pages, positions)]


CASES = [(B, n_log, KH, pps, grid, sms)
         for B, n_log in ((1, 4), (5, 6), (8, 32), (33, 9))
         for KH in (1, 4, 16)
         for pps, grid, sms in ((2, 132, 132), (1, 264, 132), (4, 7, 7))]


@pytest.mark.parametrize("B,n_log,KH,pps,grid,sms", CASES)
def test_work_list_covers_every_live_page_once(B, n_log, KH, pps, grid,
                                               sms):
    """Every mapped live page of every (row, kv head) once, in one unit
    of that row and head; no sentinel, dead or past-the-row page; a
    split row's units numbered 0..nsp-1, their pages in the row's order;
    units by size, heaviest first; ``paged_deal`` hands each unit to
    exactly one block."""
    rng = np.random.default_rng(B * 1000 + n_log * 10 + KH + pps)
    P = B * n_log + 7
    for _ in range(5):
        pages, positions, ps = _table(rng, B, n_log, P)
        whole, units = pa.paged_work(pages, positions, P=P, ps=ps, KH=KH,
                                     pps=pps, grid=grid, sms=sms)
        live = _live(pages, positions, P, ps)
        got = {}
        for u in units:
            assert u.hb == 0 and 0 <= u.kh < KH and u.pages
            got.setdefault((u.b, u.kh), []).append(u)
        for b, lp in enumerate(live):
            for kh in range(KH):
                mine = sorted(got.pop((b, kh), []), key=lambda u: u.sp)
                assert [p for u in mine for p in u.pages] == lp
                assert [u.sp for u in mine] == list(range(len(mine)))
                assert all(u.nsp == len(mine) for u in mine)
                if whole:
                    assert len(mine) == (1 if lp else 0)
        assert not got
        sizes = [len(u.pages) for u in units]
        assert sizes == sorted(sizes, reverse=True)
        dealt = sorted(x for blk in range(grid)
                       for x in pa.paged_deal(len(units), grid, blk))
        assert dealt == list(range(len(units)))


def test_rows_are_whole_where_they_fill_the_card():
    """The serving shape (B 8, 16 kv heads, 4-6 pages of 64: 128 units
    for 132 SMs): every row one unit, no fold; the same rows over one kv
    head (8 units) are split into ranges of pps pages instead, as are
    rows to the whole context (phase 2 of the chip smoke)."""
    rng = np.random.default_rng(0)
    B, n_log, ps, P = 8, 32, 64, 256
    positions = rng.integers(251, 364, size=B).astype(np.int32)
    pages = np.full((B, n_log), P, np.int32)
    perm = rng.permutation(P).astype(np.int32)
    for b in range(B):
        n = positions[b] // ps + 1
        pages[b, :n] = perm[b * n_log:b * n_log + n]
    whole, units = pa.paged_work(pages, positions, P=P, ps=ps, KH=16,
                                 pps=2, grid=264, sms=132)
    assert whole and len(units) == 128
    assert all(u.nsp == 1 and len(u.pages) in (4, 5, 6) for u in units)
    whole, units = pa.paged_work(pages, positions, P=P, ps=ps, KH=1,
                                 pps=2, grid=132, sms=132)
    assert not whole and max(len(u.pages) for u in units) == 2
    long_pos = np.full(B, n_log * ps - 1, np.int32)
    full_pages = perm.reshape(B, n_log)
    whole, units = pa.paged_work(full_pages, long_pos, P=P, ps=ps, KH=16,
                                 pps=2, grid=264, sms=132)
    # 8 x 32 x 16 page loads over 264 blocks: ranges of a block's share
    assert not whole and {len(u.pages) for u in units} == {16}
    assert all(u.nsp >= 2 for u in units)


def test_a_balanced_batch_is_whole_even_when_long():
    """Rows all within 1.5x a block's share of the loads take no fold:
    eight full 2048-key rows over 16 kv heads on 64 blocks."""
    P = 8 * 32
    pages = np.arange(P, dtype=np.int32).reshape(8, 32)
    positions = np.full(8, 2047, np.int32)
    whole, units = pa.paged_work(pages, positions, P=P, ps=64, KH=16,
                                 pps=2, grid=64, sms=132)
    assert whole and len(units) == 128


# -- the wrapper over a fake library ---------------------------------------


class _FakeLib:
    """Stands in for the built library: records each call's arguments,
    answers the shared-memory query with the Python mirror, writes a
    recognisable map pair, reports success."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def kftpu_paged_decode_smem_bytes(group, Dh, el, pps):
        return at.paged_smem_bytes(group, Dh, el, pps)

    def kftpu_paged_tma_maps(self, maps, *args):
        self.calls.append(("kftpu_paged_tma_maps", args))
        maps.raw = bytes(range(256))
        return 0

    def __getattr__(self, name):
        if name.startswith("kftpu_"):
            def fn(*args):
                self.calls.append((name, args))
                return 0
            return fn
        raise AttributeError(name)


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrapper's CUDA branch on ``meta`` tensors (no device to launch
    on): the fake library, 132 SMs, a fresh map cache and launch
    counters of their own."""
    lib = _FakeLib()
    monkeypatch.setattr(pa, "_require_cuda", lambda t: None)
    monkeypatch.setattr(pa, "_lib", lambda: lib)
    monkeypatch.setattr(pa, "_stream", lambda t: 0)
    monkeypatch.setattr(pa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(pa, "_maps", type(pa._maps)())
    monkeypatch.setattr(pa, "_scratch", {})
    monkeypatch.setattr(pa, "launches", dict.fromkeys(pa.launches, 0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoDevice())
    return lib


def _meta(B=8, QH=16, KH=16, Dh=64, P=64, ps=64, n_log=8,
          dtype=torch.bfloat16, pool=None):
    q = torch.zeros(B, QH, Dh, dtype=dtype, device="meta")
    k = pool if pool is not None else torch.zeros(
        P, ps, KH, Dh, dtype=dtype, device="meta")
    pages = torch.zeros(B, n_log, dtype=torch.int32, device="meta")
    positions = torch.zeros(B, dtype=torch.int32, device="meta")
    return q, k, k, pages, positions


@pytest.mark.parametrize("QH,KH", [(16, 16), (16, 4), (8, 1), (12, 3)])
def test_bf16_dh64_small_groups_reach_the_tma_kernel(fake_lib, QH, KH):
    """One map encoding for the pool (K then V, its token stride), then
    one launch with the encoded pair, the split and the SM count."""
    q, k, v, pages, positions = _meta(QH=QH, KH=KH)
    assert pa.paged_route(q.dtype, 64, QH // KH) == at.PAGED_TMA_KERNEL
    pa.paged_decode_attention(q, k, v, pages, positions)
    names = [n for n, _ in fake_lib.calls]
    assert names == ["kftpu_paged_tma_maps", "kftpu_paged_decode_tma"]
    maps_args = fake_lib.calls[0][1]
    assert maps_args[2:] == (64, 64, KH, KH * 64)      # P, ps, KH, tok
    args = fake_lib.calls[1][1]
    assert args[0].raw == bytes(range(256))
    assert args[8:16] == (8, QH, KH, 64, 64, 8, 2, 132)
    assert pa.launches == {"paged_decode_attention": 1,
                           "paged_decode_tma": 1}


def test_maps_are_encoded_once_a_pool(fake_lib):
    """A second call on the same pool reuses its maps; a slice of its kv
    heads (another base, shape and stride) gets its own."""
    q, k, v, pages, positions = _meta(QH=16, KH=4)
    for _ in range(3):
        pa.paged_decode_attention(q, k, v, pages, positions)
    ks = k[:, :, 1:2]
    pa.paged_decode_attention(q[:, :4].contiguous(), ks, ks, pages,
                              positions)
    encodes = [a for n, a in fake_lib.calls if n == "kftpu_paged_tma_maps"]
    assert [a[2:] for a in encodes] == [(64, 64, 4, 256), (64, 64, 1, 256)]
    assert pa.launches["paged_decode_tma"] == 4


@pytest.mark.parametrize("QH,KH,Dh,dtype", [
    (16, 16, 64, torch.float32), (8, 2, 96, torch.bfloat16),
    (32, 2, 64, torch.bfloat16), (4, 4, 128, torch.bfloat16)])
def test_other_shapes_reach_the_split_kernel(fake_lib, QH, KH, Dh, dtype):
    """f32, Dh 96 and 128, and a group of 16 launch paged_decode_kernel
    with their dtype flag and token stride; no map is encoded."""
    q, k, v, pages, positions = _meta(QH=QH, KH=KH, Dh=Dh, dtype=dtype)
    assert pa.paged_route(dtype, Dh, QH // KH) == at.PAGED_SPLIT_KERNEL
    pa.paged_decode_attention(q, k, v, pages, positions)
    (name, args), = fake_lib.calls
    assert name == "kftpu_paged_decode_attention"
    assert args[18] == int(dtype == torch.bfloat16) and args[19] == KH * Dh
    assert pa.launches == {"paged_decode_attention": 1,
                           "paged_decode_tma": 0}


BAD_POOLS = {
    # key rows 2**40 bytes apart: past what a TMA map encodes
    "row_stride_past_2_40": (8, lambda: torch.empty_strided(
        (4, 64, 1, 64), (64 << 39, 1 << 39, 64, 1), dtype=torch.bfloat16,
        device="meta")),
    # P * ps rows past an int's coordinates
    "rows_past_2_31": (8, lambda: torch.empty(
        (1 << 25, 64, 1, 64), dtype=torch.bfloat16, device="meta")),
    # a batch past the work list's 1024 rows
    "batch_past_the_list": (pa.TMA_MAX_ROWS + 1, lambda: torch.empty(
        (4, 64, 1, 64), dtype=torch.bfloat16, device="meta")),
}


@pytest.mark.parametrize("case", sorted(BAD_POOLS))
def test_what_a_map_cannot_encode_is_refused_before_any_call(fake_lib,
                                                            case):
    B, make = BAD_POOLS[case]
    pool = make()
    q, k, v, pages, positions = _meta(B=B, QH=1, KH=1, pool=pool)
    with pytest.raises(ValueError, match="TMA"):
        pa.paged_decode_attention(q, k, v, pages, positions)
    assert fake_lib.calls == []
    assert pa.launches == {"paged_decode_attention": 0,
                           "paged_decode_tma": 0}


def test_check_refuses_a_base_off_16_bytes():
    """A pool 2 bytes past a 16-byte boundary (CPU tensors: meta tensors
    have no address) is refused by the check; the aligned one passes."""
    n = 4 * 16 * 2 * 64
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    good = flat[:n].view(4, 16, 2, 64)
    pa.check_paged_tma(good, good, 8)
    bad = flat[1:1 + n].view(4, 16, 2, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        pa.check_paged_tma(bad, good, 8)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch(monkeypatch):
    """On the CPU the wrapper is the plain version, whatever the route,
    and never reaches the library."""
    monkeypatch.setattr(pa, "_lib", lambda: pytest.fail("library loaded"))
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(3, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(6, 16, 2, 64)).astype(np.float32))
    pages = torch.tensor([[0, 1], [2, 6], [6, 6]], dtype=torch.int32)
    positions = torch.tensor([20, 3, 5], dtype=torch.int32)
    before = dict(pa.launches)
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    got = pa.paged_decode_attention(q, k, k, pages, positions)
    want = pa.paged_decode_attention_plain(q, k, k, pages, positions)
    assert pa.paged_route(q.dtype, 64, 4) == at.PAGED_TMA_KERNEL
    assert torch.equal(got, want) and (got[2] == 0).all()
    assert pa.launches == before
