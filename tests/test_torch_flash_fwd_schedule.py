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

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import _last_live_kv
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import flash_attention as fa
from test_torch_flash_bwd_schedule import (  # noqa: F401
    BAD_VIEWS, _Barrier, fake_lib)

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


# the timed shapes (B, S, H, causal) and the rows their grids take on 132
# SMs; a 192-row round's cost against a 64-row round's as measured for
# the hand-off design (PERF.md §6 row 3: 1.07 and 1.08 at :predict's
# shapes, 1.17 at BERT's) and the committed FWD_ROUNDS'
TIMED_ROWS = {(2, 8192, 16, True): 192, (16, 512, 12, False): 192,
              (8, 512, 12, False): 64, (1, 128, 12, False): 64}


@pytest.mark.parametrize("cost", [1.08, 1.17, None])
@pytest.mark.parametrize("shape", sorted(TIMED_ROWS))
def test_forward_rounds_pick_the_faster_tile_at_the_timed_shapes(
        monkeypatch, shape, cost):
    """At each timed shape ``forward_rounds`` picks the tile the card
    timed faster (192 rows at the LM and BERT, 64 at :predict's two) under
    the round costs measured for this design and under the committed
    ``FWD_ROUNDS`` (None), and the work list is that tile's: one item a
    q tile, each streaming its causal range of 64-key stages."""
    if cost is not None:
        monkeypatch.setattr(at, "FWD_ROUNDS", {192: (1, cost), 64: (2, 1.0)})
    B, S, H, causal = shape
    rows = at.flash_tile("flash_fwd", 64, torch.bfloat16, batch_heads=B * H,
                         seq=S, sms=132)[0]
    assert rows == TIMED_ROWS[shape]
    work = fa.wgmma_work("flash_fwd", S, causal, (rows, 64))
    assert len(work) == -(-S // rows)
    for tile, first, end in work:
        assert first == 0
        assert end == (min(-(-S // 64), (tile * rows + rows - 1) // 64 + 1)
                       if causal else -(-S // 64))


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


# ---------------------------------------------------------------------------
# The forward's block protocol (csrc flash_fwd_wgmma_kernel<64, NC>): a
# producer that takes items and fills a ring of FWD_STAGES stages, and NC
# consumer warpgroups that either hand an item off to the next (the next
# item's first S waited for while the last P.V's slot is still held) or
# drain it. Steps as in test_torch_flash_bwd_schedule.py's block model:
# ("wait", barrier, completion), ("arrive", barrier), or a record. An
# actor is an iterator of its steps.
# ---------------------------------------------------------------------------


FWD_STAGES = 4


def _fwd_item(entry, S, causal, kv_len, rows):
    """``csrc:fwd_item``: (q0, stages [lo, hi), trimmed) of one work-list
    entry for a batch row of length ``kv_len``."""
    tile, first, end = entry
    limit = S if kv_len is None else kv_len
    trim = causal and limit > 0
    return (tile * rows, first if trim else 0,
            end if trim else -(-S // 64), trim)


def _fwd_programs(items, S, causal, kv_len, nc, hand_off_any=False):
    """The producer and each consumer warpgroup of a block that takes
    ``items`` (work-list entries) in order, as the kernel orders its
    waits and releases; a consumer records ("s", item, stage) for each S
    it issues and ("out", item) for each epilogue. It hands off where its
    last stage is the item's; with ``hand_off_any`` also where its last
    stage comes before the item's (after releasing the stages past it),
    which the kernel does not do."""
    its = [_fwd_item(e, S, causal, kv_len, 64 * nc) for e in items]
    prod, it = [], 0
    for n in range(len(its) + 1):     # the last: "no more items"
        prod += [("wait", ("q_empty", n & 1), n >> 1),
                 ("arrive", ("q_full", n & 1))]
        if n == len(its):
            break
        for _ in range(its[n][1], its[n][2]):
            prod += [("wait", ("empty", it % FWD_STAGES), it // FWD_STAGES),
                     ("arrive", ("full", it % FWD_STAGES))]
            it += 1

    def full(r):
        return ("wait", ("full", r % FWD_STAGES), r // FWD_STAGES + 1)

    def empty(r):
        return ("arrive", ("empty", r % FWD_STAGES))

    def consumer(wg):
        def view(n):
            """(lo, hi, live_hi, rows) of item n, or None past the last."""
            if n == len(its):
                return None
            q0, lo, hi, trim = its[n]
            qw = q0 + 64 * wg
            live_hi = (lo if qw >= S else
                       min(hi, (qw + 63) // 64 + 1) if trim else hi)
            return lo, hi, live_hi, qw < S

        steps = [("wait", ("q_full", 0), 1)]
        carried, it0 = False, 0
        for n in range(len(its)):
            lo, hi, live_hi, rows = view(n)
            it_end = it0 + hi - lo
            nxt = ("wait", ("q_full", (n + 1) & 1), ((n + 1) >> 1) + 1)
            skip = [s for s in range(live_hi, hi) for s in (
                full(it0 + s - lo), empty(it0 + s - lo))]
            if lo < live_hi:
                assert rows
                if not carried:
                    steps += [full(it0), ("s", n, lo)]
                for j in range(lo, live_hi - 1):
                    r = it0 + j - lo
                    steps += [full(r + 1), ("s", n, j + 1), empty(r)]
                steps.append(("arrive", ("q_empty", n & 1)))
                last = empty(it0 + live_hi - 1 - lo)
                drains = live_hi < hi and not hand_off_any
                v = view(n + 1)
                carried = not drains and v is not None and v[0] < v[2]
                if drains:
                    steps += [last, *skip, ("out", n), nxt]
                elif carried:
                    steps += [*(skip if live_hi < hi else []), nxt,
                              full(it_end), ("s", n + 1, v[0]), last,
                              ("out", n)]
                else:
                    steps += [nxt, last, *skip, ("out", n)]
            else:             # no products and no rows of this item
                assert not rows
                steps += [("arrive", ("q_empty", n & 1)), *skip, nxt]
                carried = False
            it0 = it_end
        return iter(steps)

    return its, [iter(prod)] + [consumer(wg) for wg in range(nc)]


def _run_fwd_block(actors, nc, rng):
    """Runs the actors in a random interleaving; returns each consumer's
    records, or raises on a deadlock or a wait that finds its barrier
    past the completion it names."""
    bars = {("full", s): _Barrier(1) for s in range(FWD_STAGES)}
    bars.update({("empty", s): _Barrier(nc) for s in range(FWD_STAGES)})
    for qb in (0, 1):
        bars[("q_full", qb)] = _Barrier(1)
        bars[("q_empty", qb)] = _Barrier(nc)
    steps = [next(a, None) for a in actors]
    logs = [[] for _ in actors]
    while True:
        ready = []
        for a, step in enumerate(steps):
            if step is None:
                continue
            if step[0] == "wait":
                done = bars[step[1]].done
                assert done <= step[2], (
                    f"actor {a} waits for completion {step[2]} of "
                    f"{step[1]}, which has {done}: a parity misread")
                if done < step[2]:
                    continue
            ready.append(a)
        if not ready:
            break
        a = ready[rng.integers(len(ready))]
        step = steps[a]
        if step[0] == "arrive":
            bars[step[1]].arrive()
        elif step[0] != "wait":
            logs[a].append(step)
        steps[a] = next(actors[a], None)
    stuck = [a for a, step in enumerate(steps) if step is not None]
    if stuck:
        raise RuntimeError(f"deadlock: actors {stuck} stopped at "
                           f"{[steps[a] for a in stuck]}")
    return logs[1:]


# (S, causal, kv_len, rows an item, which of the head's work-list entries
# one block takes, in list order): the LM's heaviest and lightest items,
# a ragged causal S, BERT's items (the third with one warpgroup keyless),
# :predict's two-stage items at 64 rows, kv_len trimming nothing (0) or
# some keys
FWD_BLOCK_CASES = [(8192, True, None, 192, (0, 1, 41, 42)),
                   (1000, True, None, 192, (0, 1, 2, 3, 4, 5)),
                   (512, False, None, 192, (0, 1, 2)),
                   (128, False, None, 64, (0, 1)),
                   (512, False, None, 64, (0, 3, 5, 7)),
                   (1000, True, 0, 192, (0, 5)),
                   (1000, True, 937, 64, (0, 7, 15))]


@pytest.mark.parametrize("S,causal,kv_len,rows,picks", FWD_BLOCK_CASES)
def test_forward_hand_off_runs_every_stage_once(S, causal, kv_len, rows,
                                                picks):
    """Under random interleavings of one block's producer and consumer
    warpgroups, each warpgroup issues S once for each stage of each item
    it has live keys in, in order, and writes out each item it has rows
    in, in order; no wait deadlocks or finds its barrier a phase past the
    one its parity names (a hand-off holds the last stage's slot while it
    waits for the next item's first stage)."""
    nc = rows // 64
    work = fa.wgmma_work("flash_fwd", S, causal, (rows, 64))
    picked = [work[k] for k in picks]
    rng = np.random.default_rng(S + len(picks))
    for _ in range(8):
        its, actors = _fwd_programs(picked, S, causal, kv_len, nc)
        logs = _run_fwd_block(actors, nc, rng)
        for wg, log in enumerate(logs):
            want_s, want_out = [], []
            for n, (q0, lo, hi, trim) in enumerate(its):
                qw = q0 + 64 * wg
                if qw >= S:
                    continue
                live_hi = min(hi, (qw + 63) // 64 + 1) if trim else hi
                want_s += [("s", n, j) for j in range(lo, live_hi)]
                want_out.append(("out", n))
            assert [s for s in log if s[0] == "s"] == want_s
            assert [s for s in log if s[0] == "out"] == want_out


def test_forward_model_finds_a_hand_off_that_holds_the_ring(monkeypatch):
    """The model's check bites: at three ring stages a causal block of
    192-row items deadlocks if a warpgroup whose last stage comes before
    the item's hands off too (the lowest holds its last stage's slot
    while it waits for the next item's first stage, three stages on,
    which the producer can only load into that slot), and runs with the
    kernel's rule, where that warpgroup drains."""
    monkeypatch.setattr(sys.modules[__name__], "FWD_STAGES", 3)
    work = fa.wgmma_work("flash_fwd", 8192, True, (192, 64))
    _, actors = _fwd_programs(work[:3], 8192, True, None, 3,
                              hand_off_any=True)
    with pytest.raises(RuntimeError, match="deadlock"):
        _run_fwd_block(actors, 3, np.random.default_rng(0))
    _, actors = _fwd_programs(work[:3], 8192, True, None, 3)
    _run_fwd_block(actors, 3, np.random.default_rng(0))


# ---------------------------------------------------------------------------
# The forward's lse over a long causal row, summed as the kernel's stage
# softmax sums it.
# ---------------------------------------------------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "kubeflow_tpu_torch", "ops", "csrc", "flash_attention.cu")
# csrc kMaskRaw, kLog2e
MASK_RAW, LOG2E = -3.0e38, 1.4426950408889634


def _fma(a, b, c):
    """f32 fmaf: the product exact in f64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).float()


def kernel_softmax_lse(s: torch.Tensor, rows: torch.Tensor, scale: float,
                       causal: bool = True) -> torch.Tensor:
    """lse of q rows ``rows`` from their raw f32 products ``s`` (R, S) as
    one consumer warpgroup's threads make it (csrc ``fwd_softmax_at``):
    64-key stages, the running max on the raw products, alpha and each
    key's exponent by exp2 in f32, the exponent one FFMA (s c - m c) on a
    non-edge stage and (x - m) c on an edge stage, each of a quad's four
    threads summing its own keys (8 n + 2 t + {0, 1}) in key order into
    its l (l alpha + sum, one fmaf), then the quad sum and m scale +
    log l."""
    R, S = s.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((R,), MASK_RAW, dtype=torch.float32)
    ls = torch.zeros(R, 4, dtype=torch.float32)
    keys = torch.arange(S)
    live = (keys[None, :] <= rows[:, None]) if causal else torch.ones(
        R, S, dtype=torch.bool)
    # each thread's keys in the order it sums them (key order)
    cols = torch.tensor([[8 * n + 2 * t + e for n in range(8)
                          for e in (0, 1)] for t in range(4)])
    for k0 in range(0, S, 64):
        blk = s[:, k0:k0 + 64]
        lv = live[:, k0:k0 + 64]
        edge = not bool(lv.all())
        x = torch.where(lv, blk, torch.tensor(MASK_RAW))
        mn = torch.maximum(m, x.max(dim=1).values)
        alpha = torch.exp2((m - mn) * c)
        if edge:
            arg = (x - mn[:, None]) * c
        else:
            arg = _fma(blk, c.expand_as(blk), -(mn * c)[:, None].expand_as(
                blk))
        p = torch.exp2(arg)[:, cols]
        ps = torch.zeros(R, 4, dtype=torch.float32)
        for i in range(cols.shape[1]):
            ps = ps + p[:, :, i]
        ls = _fma(ls, alpha[:, None].expand_as(ls), ps)
        m = mn
    lc = (ls[:, 0] + ls[:, 1]) + (ls[:, 2] + ls[:, 3])
    return m * torch.tensor(scale, dtype=torch.float32) + torch.log(lc)


def test_long_causal_rows_lse_through_the_stage_softmax():
    """At the LM's S = 8192, causal, D = 64, rows that see 8192, 4097
    and 200 keys: lse summed as the kernel's stage softmax sums it is
    within phase 2's 1e-5 of the exact (f64) one."""
    rng = np.random.default_rng(25)
    S, D = 8192, 64
    rows = torch.tensor([8191, 4096, 199])
    q = torch.from_numpy(rng.standard_normal((3, D))).bfloat16().float()
    k = torch.from_numpy(rng.standard_normal((S, D))).bfloat16().float()
    s = (q.double() @ k.double().T).float()
    got = kernel_softmax_lse(s, rows, D ** -0.5)
    keys = torch.arange(S)
    want = torch.stack([torch.logsumexp(s[i, keys <= r].double() * D ** -0.5,
                                        0) for i, r in enumerate(rows)])
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("exp_spans", [False, True])
def test_timeline_stamps_find_the_forward(exp_spans):
    """``scripts/port_flash_fwd_timeline.py`` instruments the package's
    forward as the hand-off design: each of its anchors is found exactly
    once (in the kernel, and with ``exp_spans`` in the softmax too), so
    the timeline measures the kernel the package builds."""
    spec = importlib.util.spec_from_file_location(
        "port_flash_fwd_timeline",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "scripts", "port_flash_fwd_timeline.py"))
    timeline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timeline)
    with open(CSRC) as f:
        src = f.read()
    out = timeline.instrumented_source(src, exp_spans)
    # a span per anchor (its stage and item counts beside) and the
    # hand-off block's; with exp_spans one more in the softmax
    assert out.count("KFTPU_ADD(") > len(timeline.KERNEL_STAMPS.items)
    assert ("kftpu_gtime_after(mc" in out) == exp_spans
