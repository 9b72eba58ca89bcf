"""The host side of the wgmma flash kernels (``ops/flash_attention.py``)
and the schedule of the fused backward.

The bf16 D = 64 forward and the fused backward (dQ, dK and dV in one
kernel) walk work lists that the wrapper computes (:func:`wgmma_work`):
one item per 128-row block tile with the range of 64-row tiles it
streams. Here each item's range is held against the reference's causal
loop limits (``kubeflow_tpu/ops/attention.py`` ``_first_live_q`` and
``_last_live_kv``) at the same block sizes, the backward's list covers
every live (kv tile, q tile) pair once, and its order is dQ's add order.

Then a model of the persistent grid: workers take items from the list
in order, each tile costs its products, and a kv tile's add into a q
tile waits until every kv tile above it has added, as the kernel's
adder does (``csrc/flash_attention.cu:bwd_turn``). It must end without
deadlock and with every q tile's adds in descending kv tile.

Then the wrappers: with the library replaced by a fake, a stride or base
that a TMA map cannot encode is refused before any launch, a view of a
fused projection is handed to the library with the fused kernel's own
tile, list and buffers, the other routes launch the dQ and dK/dV
kernels, and CPU tensors take the plain path and count no launch.
"""

import heapq
import importlib.util
import os

import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.attention import _first_live_q, _last_live_kv
from kubeflow_tpu_torch.ops import autotune as at
from kubeflow_tpu_torch.ops import flash_attention as fa

LISTS = ("flash_fwd", "flash_bwd")
WRAPPERS = ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")
SEQS = [64, 128, 1000, 8192]
SMS = 132          # an H100's SMs: the persistent grid's workers


@pytest.mark.parametrize("kernel", LISTS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_work_list_ranges_match_the_reference(kernel, causal, S):
    """Each item's streamed range is the reference's at the kernel's
    block sizes: the backward from ``_first_live_q`` to the last q tile,
    the forward from 0 to ``_last_live_kv`` + 1 (every tile without
    causality)."""
    block_q, block_k = at.WGMMA_TILES[kernel]
    n_q, n_kv = -(-S // block_q), -(-S // block_k)
    for tile, first, end in fa.wgmma_work(kernel, S, causal):
        if kernel == "flash_bwd":
            want = (_first_live_q(tile, block_q, block_k) if causal else 0,
                    n_q)
        else:
            want = (0, min(n_kv, _last_live_kv(tile, block_q, block_k) + 1)
                    if causal else n_kv)
        assert (first, end) == want, (tile, first, end)
        assert 0 <= first < end


@pytest.mark.parametrize("kernel", LISTS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_work_list_holds_every_tile_once_heaviest_first(kernel, causal, S):
    """One item per block tile of the kernel's own size, none twice. The
    forward's in order of the tiles each streams (most first; ties by
    tile); the backward's in descending kv tile, the order in which its
    adds into each q tile land (which, causal, puts the lightest first:
    see ``test_heaviest_first_backward_list_can_deadlock``)."""
    block_q, block_k = at.WGMMA_TILES[kernel]
    own = block_k if kernel == "flash_bwd" else block_q
    work = fa.wgmma_work(kernel, S, causal)
    assert sorted(t for t, _, _ in work) == list(range(-(-S // own)))
    if kernel == "flash_bwd":
        assert [t for t, _, _ in work] == list(reversed(range(len(work))))
        return
    sizes = [end - first for _, first, end in work]
    assert sizes == sorted(sizes, reverse=True)
    for (t0, f0, e0), (t1, f1, e1) in zip(work, work[1:]):
        assert e0 - f0 > e1 - f1 or t0 < t1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_backward_list_covers_every_live_pair_once(causal, S):
    """The (kv tile, q tile) pairs the fused list walks are the live
    pairs of both reference passes at its tiles: the dK/dV pass's (q
    tiles from ``_first_live_q``) and the dQ pass's (kv tiles up to
    ``_last_live_kv``), each once."""
    block_q, block_k = at.WGMMA_TILES["flash_bwd"]
    n_q, n_kv = -(-S // block_q), -(-S // block_k)
    walked = [(j, i) for j, first, end in fa.wgmma_work("flash_bwd", S,
                                                        causal)
              for i in range(first, end)]
    assert len(walked) == len(set(walked))
    dkv = {(j, i) for j in range(n_kv)
           for i in range(_first_live_q(j, block_q, block_k) if causal
                          else 0, n_q)}
    dq = {(j, i) for i in range(n_q)
          for j in range(min(n_kv, _last_live_kv(i, block_q, block_k) + 1)
                         if causal else n_kv)}
    assert set(walked) == dkv == dq


def kernel_turn(j, i, S, trim):
    """``csrc/flash_attention.cu:bwd_turn``: the adds into q tile ``i``
    that land before kv tile ``j``'s, in descending kv tile from the last
    kv tile live for it."""
    block_q, block_k = at.WGMMA_TILES["flash_bwd"]
    n_kv = -(-S // block_k)
    last = (min(n_kv - 1, (i * block_q + block_q - 1) // block_k) if trim
            else n_kv - 1)
    return last - j


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
def test_kernel_turn_counts_the_kv_tiles_above(causal, S):
    """The kernel's turn for (kv tile j, q tile i) is the number of
    items of the list above j that walk q tile i."""
    work = fa.wgmma_work("flash_bwd", S, causal)
    for j, first, end in work:
        for i in range(first, end):
            above = sum(1 for j2, f2, e2 in work if j2 > j and f2 <= i < e2)
            assert kernel_turn(j, i, S, causal) == above, (j, i)


def _tile_cost(j, i, causal):
    """A tile's products: both warpgroups' (1), or only the lower
    warpgroup's on a causal kv tile's first q tile, where the upper
    warpgroup's keys all lie above the tile's rows (0.5)."""
    block_q, block_k = at.WGMMA_TILES["flash_bwd"]
    first = _first_live_q(j, block_q, block_k)
    upper_live = (j * block_k + 64) // block_q
    return 0.5 if causal and first <= i < upper_live else 1.0


def simulate(S, heads, workers, causal, per_head=None):
    """The persistent grid on a clock: ``workers`` take items from the
    list (``heads`` heads of ``per_head``, by default the kernel's list)
    in order as they come free, walk each item's q tiles in ascending
    order, and after a tile's products wait until the adds of the kv
    tiles above theirs have landed (:func:`kernel_turn`), then add at
    once: an add takes no time here, so its wait share speaks of tile
    order only. Returns ``(makespan, idle share, wait share, adds)``, ``adds``
    each (head, q tile)'s kv tiles in the order their adds landed, or
    raises ``RuntimeError`` if the workers stop with adds pending."""
    per_head = per_head or fa.wgmma_work("flash_bwd", S, causal)
    items = [(h, it) for h in range(heads) for it in per_head]
    nxt, seq, events = 0, 0, []
    landed, waiting, adds = {}, {}, {}
    busy = waited = end = 0.0
    state = {}

    def start_tile(w, t):
        nonlocal seq, busy
        h, (j, first, stop), i = state[w]
        cost = _tile_cost(j, i, causal)
        busy += cost
        heapq.heappush(events, (t + cost, seq, w))
        seq += 1

    def take(w, t):
        nonlocal nxt, end
        end = max(end, t)
        if nxt < len(items):
            h, it = items[nxt]
            nxt += 1
            state[w] = (h, it, it[1])
            start_tile(w, t)

    def add(w, t):
        nonlocal waited
        h, it, i = state[w]
        landed[(h, i)] = landed.get((h, i), 0) + 1
        adds.setdefault((h, i), []).append(it[0])
        if i + 1 < it[2]:
            state[w] = (h, it, i + 1)
            start_tile(w, t)
        else:
            take(w, t)
        nxt_w = waiting.pop((h, i, landed[(h, i)]), None)
        if nxt_w is not None:
            waited += t - nxt_w[1]
            add(nxt_w[0], t)

    for w in range(workers):
        take(w, 0.0)
    while events:
        t, _, w = heapq.heappop(events)
        h, (j, _, _), i = state[w]
        turn = kernel_turn(j, i, S, causal)
        if landed.get((h, i), 0) == turn:
            add(w, t)
        else:
            waiting[(h, i, turn)] = (w, t)
    if waiting or nxt < len(items):
        raise RuntimeError(f"deadlock: {len(waiting)} adds waiting, "
                           f"{len(items) - nxt} items never taken")
    return end, 1 - busy / (workers * end), waited / (workers * end), adds


# (S, heads, causal): the LM step's backward (B 2 x H 16), BERT-base's
# (16 x 12), and a ragged causal and non-causal S
SCHEDULES = [(8192, 32, True), (512, 192, False), (1000, 8, True),
             (1000, 8, False)]


@pytest.mark.parametrize("S,heads,causal", SCHEDULES)
def test_persistent_schedule_adds_in_descending_kv_tile(S, heads, causal):
    """132 workers on the kernel's list end without deadlock, every
    (head, q tile) gets one add from each live kv tile in descending kv
    tile, and no add waits. The model lands each add the moment it is
    made, so that last is a statement about tile order only (each kv
    tile reaches a q tile after the ones above it): it ignores the time
    an add takes, and on the card adds do wait (the source note of
    flash_attention.cu gives the reading). Prints the idle share at the
    shape."""
    makespan, idle, wait, adds = simulate(S, heads, SMS, causal)
    work = fa.wgmma_work("flash_bwd", S, causal)
    for (h, i), order in adds.items():
        want = [j for j, first, end in work if first <= i < end]
        assert order == sorted(want, reverse=True), (h, i, order)
    n_q = -(-S // at.WGMMA_TILES["flash_bwd"][0])
    assert len(adds) == heads * n_q
    assert wait == 0.0
    print(f"S={S} heads={heads} causal={causal}: makespan {makespan} "
          f"tiles, idle share {idle:.4f}")
    if (S, heads) == (8192, 32):
        # the LM shape: the tail of the last head's heavy kv tiles
        assert idle < 0.10


def test_heaviest_first_backward_list_can_deadlock():
    """The two-pass order (heaviest first: kv tile 0 first, causal) puts
    a kv tile before the ones it waits on. With fewer workers than a
    head's kv tiles every worker can hold an item that waits on one not
    yet taken; the kernel's list (descending kv tile) ends with the same
    workers."""
    S, workers = 8192, 16
    heavy = tuple(sorted(fa.wgmma_work("flash_bwd", S, True),
                         key=lambda it: (it[1] - it[2], it[0])))
    assert heavy[0][0] == 0
    with pytest.raises(RuntimeError, match="deadlock"):
        simulate(S, 2, workers, True, per_head=heavy)
    makespan, _, _, _ = simulate(S, 2, workers, True)
    assert makespan > 0


# The block's own protocol (csrc/flash_attention.cu,
# flash_bwd_wgmma_kernel): a producer fills a ring of STAGES stages; two
# consumer warpgroups walk the same q tiles of each item, q tile tq of the
# block's walk (tq counts over its items) owned by warpgroup tq & 1, which
# issues its dQ from dS^T buffer tq & 1 once the other warpgroup's half is
# in (ds_full) and frees the buffer when dQ has landed (ds_free), then
# hands the sum to adder tq % DQ_BUFS (dq_full / dq_empty). Each wait
# names the completion it needs, as the kernel's parity does: it passes
# when the barrier has completed that many phases, and a barrier found
# past it is a parity the hardware would misread.
STAGES, DQ_BUFS, WG_ROWS = 4, 3, 64


class _Barrier:
    def __init__(self, count):
        self.count, self.arrived, self.done = count, 0, 0

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.done = 0, self.done + 1


def _block_item(entry, S, causal, kv_len):
    """``csrc:bwd_item``: (kv tile, q tiles [lo, hi), trimmed) of one
    work-list entry for a batch row of length ``kv_len``."""
    j, first, end = entry
    limit = S if kv_len is None else kv_len
    trim = causal and limit > 0
    n_q = -(-S // WG_ROWS)
    return j, (first if trim else 0), (end if trim else n_q), trim


def _block_programs(items, S, causal, kv_len):
    """Each actor's steps for a block that takes ``items``: the producer,
    the two consumer warpgroups (the kernel's dead tiles, then its live
    ones) and the adders. A step is ("wait", barrier, completion),
    ("arrive", barrier) or ("dq", tq, warpgroup, q tile) / ("add", tq, q
    tile)."""
    walk = [(j, i) for j, lo, hi, _ in (_block_item(e, S, causal, kv_len)
                                         for e in items)
            for i in range(lo, hi)]
    prod = []
    for it in range(len(walk)):
        prod += [("wait", ("empty", it % STAGES), it // STAGES),
                 ("arrive", ("full", it % STAGES))]
    wgs = []
    for wg in (0, 1):
        steps, it = [], 0
        for e in items:
            j, lo, hi, trim = _block_item(e, S, causal, kv_len)
            kw = j * 2 * WG_ROWS + WG_ROWS * wg
            live_lo = hi if kw >= S else (max(lo, kw // WG_ROWS) if trim
                                          else lo)
            for i in range(lo, hi):
                tq, s, x = it, it % STAGES, it & 1
                own, buf = (tq & 1) == wg, tq % DQ_BUFS
                steps.append(("wait", ("full", s), it // STAGES + 1))
                if i < live_lo:             # dead: released at once
                    steps.append(("arrive", ("empty", s)))
                if not own:
                    steps += [("wait", ("ds_free", x), tq >> 1),
                              ("arrive", ("ds_full", x))]
                else:
                    steps += [("wait", ("ds_full", x), (tq >> 1) + 1),
                              ("dq", tq, wg, i)]
                if i >= live_lo:            # live: released after dK
                    steps.append(("arrive", ("empty", s)))
                if own:
                    steps += [("arrive", ("ds_free", x)),
                              ("wait", ("dq_empty", buf), tq // DQ_BUFS),
                              ("arrive", ("dq_full", buf))]
                it += 1
        wgs.append(steps)
    adders = [[step for tq, (j, i) in enumerate(walk) if tq % DQ_BUFS == b
               for step in (("wait", ("dq_full", b), tq // DQ_BUFS + 1),
                            ("add", tq, i),
                            ("arrive", ("dq_empty", b)))]
              for b in range(DQ_BUFS)]
    return walk, [prod] + wgs + adders


def _run_block(programs, rng):
    """Runs the actors in a random interleaving; returns the dQ issues
    and adds in the order they happened, or raises on a deadlock or on
    a wait that finds its barrier past the completion it names."""
    bars = {("full", s): _Barrier(1) for s in range(STAGES)}
    bars.update({("empty", s): _Barrier(2) for s in range(STAGES)})
    for x in (0, 1):
        bars[("ds_full", x)] = _Barrier(1)   # the other warpgroup
        bars[("ds_free", x)] = _Barrier(1)   # the owner
    for b in range(DQ_BUFS):
        bars[("dq_full", b)] = _Barrier(1)   # the owner
        bars[("dq_empty", b)] = _Barrier(1)  # the adder
    pcs, log = [0] * len(programs), []
    while True:
        ready = []
        for a, prog in enumerate(programs):
            if pcs[a] == len(prog):
                continue
            step = prog[pcs[a]]
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
        step = programs[a][pcs[a]]
        pcs[a] += 1
        if step[0] == "arrive":
            bars[step[1]].arrive()
        elif step[0] in ("dq", "add"):
            log.append(step)
    stuck = [a for a, prog in enumerate(programs) if pcs[a] < len(prog)]
    if stuck:
        raise RuntimeError(f"deadlock: actors {stuck} stopped at "
                           f"{[programs[a][pcs[a]] for a in stuck]}")
    return log


# (S, causal, kv_len, which of the head's work-list entries one block
# takes, in list order): the LM's highest and lowest kv tiles, a ragged
# S with the upper warpgroup of the last kv tile keyless, kv_len trimming
# nothing (0) or some keys, and BERT's non-causal items
BLOCK_CASES = [(8192, True, None, (0, 1, 62, 63)),
               (1000, True, None, (0, 1, 2, 6, 7)),
               (1000, False, None, (0, 3, 7)),
               (1000, True, 0, (0, 7)),
               (1000, True, 937, (0, 4, 7)),
               (512, False, None, (0, 1, 2, 3))]


@pytest.mark.parametrize("S,causal,kv_len,picks", BLOCK_CASES)
def test_dq_alternates_between_the_warpgroups(S, causal, kv_len, picks):
    """Under random interleavings of one block's producer, consumer
    warpgroups and adders, every q tile of its walk has its dQ issued
    exactly once, by warpgroup tq & 1 (so each warpgroup issues dQ on
    every other tile: 32 products a tile each, on average), the adds
    leave each adder in its tiles' order, and no wait deadlocks or finds
    its barrier a phase past the one its parity names."""
    work = fa.wgmma_work("flash_bwd", S, causal)
    items = [work[k] for k in picks]
    walk, programs = _block_programs(items, S, causal, kv_len)
    rng = np.random.default_rng(S + len(picks))
    for _ in range(8):
        log = _run_block(programs, rng)
        dq = [step for step in log if step[0] == "dq"]
        assert sorted(tq for _, tq, _, _ in dq) == list(range(len(walk)))
        for _, tq, wg, i in dq:
            assert wg == tq & 1 and i == walk[tq][1], (tq, wg, i)
        owners = [wg for _, _, wg, _ in sorted(dq, key=lambda d: d[1])]
        assert abs(owners.count(0) - owners.count(1)) <= 1
        for b in range(DQ_BUFS):
            adds = [step[1] for step in log
                    if step[0] == "add" and step[1] % DQ_BUFS == b]
            assert adds == list(range(b, len(walk), DQ_BUFS))

def _lead(programs, favour):
    """Run the block, always stepping actor ``favour`` when it can move
    (the rest in turn); returns the most dS^T halves handed on
    (ds_full arrivals) beyond the dQ issued that read them."""
    bars = {("full", s): _Barrier(1) for s in range(STAGES)}
    bars.update({("empty", s): _Barrier(2) for s in range(STAGES)})
    for x in (0, 1):
        bars[("ds_full", x)] = _Barrier(1)
        bars[("ds_free", x)] = _Barrier(1)
    for b in range(DQ_BUFS):
        bars[("dq_full", b)] = _Barrier(1)
        bars[("dq_empty", b)] = _Barrier(1)
    pcs, handed, issued, lead = [0] * len(programs), 0, 0, 0
    while True:
        for a in [favour] + [a for a in range(len(programs)) if a != favour]:
            if pcs[a] == len(programs[a]):
                continue
            step = programs[a][pcs[a]]
            if step[0] == "wait" and bars[step[1]].done < step[2]:
                continue
            pcs[a] += 1
            if step[0] == "arrive":
                bars[step[1]].arrive()
                handed += step[1][0] == "ds_full"
            issued += step[0] == "dq"
            lead = max(lead, handed - issued)
            break
        else:
            break
    assert all(pc == len(p) for pc, p in zip(pcs, programs))
    return lead


@pytest.mark.parametrize("S,causal,kv_len,picks", BLOCK_CASES)
def test_the_warpgroups_stay_within_a_tile(S, causal, kv_len, picks):
    """With dQ on alternate q tiles each warpgroup waits for the other's
    dS^T half every other tile, so whichever actor runs first (the
    producer, either consumer, an adder), no half is handed on more
    than one tile before the dQ that reads it: the two warpgroups run in
    phase. (Every dQ on one warpgroup let the other run two tiles ahead,
    out of phase, and read slower at the LM shape: PERF.md §6.)"""
    work = fa.wgmma_work("flash_bwd", S, causal)
    walk, programs = _block_programs([work[k] for k in picks], S, causal,
                                     kv_len)
    assert [_lead(programs, a) for a in range(len(programs))] == [1] * len(
        programs)


def test_block_model_finds_a_misread_parity():
    """The model's check bites: an owner that frees its dS^T buffer
    before its dQ is issued lets the other warpgroup run a phase ahead,
    which the model reports (or the block deadlocks), rather than
    passing."""
    work = fa.wgmma_work("flash_bwd", 1000, False)
    walk, programs = _block_programs(work[:2], 1000, False, None)
    for wg in (1, 2):
        prog = programs[wg]
        for k, step in enumerate(prog):
            if step[0] == "dq":
                free = next(m for m in range(k, len(prog))
                            if prog[m][0] == "arrive"
                            and prog[m][1][0] == "ds_free")
                prog.insert(k - 1, prog.pop(free))
                break
    caught = 0
    for seed in range(20):
        try:
            _run_block(programs, np.random.default_rng(seed))
        except (AssertionError, RuntimeError):
            caught += 1
    assert caught > 0


def test_timeline_stamps_find_the_kernel():
    """``scripts/port_flash_bwd_timeline.py`` instruments the package's
    fused backward: each of its anchors is found exactly once in
    ``csrc/flash_attention.cu``, so the timeline measures the kernel the
    package builds."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "port_flash_bwd_timeline",
        os.path.join(root, "scripts", "port_flash_bwd_timeline.py"))
    timeline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timeline)
    with open(os.path.join(root, "kubeflow_tpu_torch", "ops", "csrc",
                           "flash_attention.cu")) as f:
        src = f.read()
    out = timeline.instrumented_source(src)
    assert out.count("gtime()") > 2 * len(timeline.OWN)


@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_the_wrapper_runs_the_tile_the_table_resolves(kernel):
    """The tile a launch takes (``_wgmma_route`` of the fused backward)
    is what ``resolve_flash`` falls back to for each reference key: the
    fused kernel's tile for bf16 at D <= 64 (padded to 64), 64 x 64
    otherwise, where no list is made."""
    for D, dtype in ((64, torch.bfloat16), (32, torch.bfloat16),
                     (128, torch.bfloat16), (64, torch.float32)):
        with at.table_override(at.TileTable([], [])):
            cfg = at.resolve_flash(kernel, seq=512, head_dim=D, n_heads=4,
                                   n_kv_heads=4, dtype=dtype, causal=True,
                                   generation="sm_90")
        width = fa.padded_head_dim(D)
        tensors = [torch.zeros(1, 512, 4, width, dtype=dtype, device="meta")
                   for _ in range(4)]
        block_q, block_k, _, n_work = fa._wgmma_route("flash_bwd", tensors,
                                                      True)
        assert (cfg.source, cfg.block_q, cfg.block_k) == (
            "fallback", block_q, block_k)
        fused = dtype == torch.bfloat16 and D <= 64
        assert (n_work > 0) == fused == fa.fused_backward(tensors[0])


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
    arguments without its device check, the fake library, launch
    counters of their own, and an H100 SXM's ``SMS``."""
    lib = _FakeLib()
    monkeypatch.setattr(at, "sm_count", lambda device: SMS)
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
    stats = torch.zeros(q.shape[0], q.shape[2], q.shape[1],
                        dtype=torch.float32, device="meta")
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


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("view", sorted(BAD_VIEWS))
def test_wrapper_refuses_what_a_tma_map_cannot_encode(fake_lib, wrapper,
                                                      view):
    """A q a TMA map cannot describe raises before the library is
    called, and no launch is counted."""
    q = BAD_VIEWS[view]()
    with pytest.raises(ValueError, match="16 bytes"):
        _call(wrapper, q, *_bwd_inputs(q))
    assert fake_lib.calls == [] and not any(fa.launches.values())


def test_check_tma_refuses_a_base_off_16_bytes():
    """A base 2 bytes past a 16-byte boundary (a CPU tensor: meta
    tensors have no address) is refused by the check itself; the
    aligned tensor beside it passes."""
    flat = torch.zeros(2 * 64 * 2 * 64 + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    fa.check_tma([flat[:2 * 64 * 2 * 64].view(2, 64, 2, 64)])
    with pytest.raises(ValueError, match="16 bytes"):
        fa.check_tma([flat[1:1 + 2 * 64 * 2 * 64].view(2, 64, 2, 64)])


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("causal", [True, False])
def test_fused_projection_view_reaches_the_library(fake_lib, wrapper,
                                                   causal):
    """q, k and v as views of one (B, S, 3, H, D) tensor pass the checks
    and reach the fused kernel once, whichever wrapper is called, with
    its tile, its list, the counters (one item counter, then one a head
    and q tile) and the workspace; one launch of ``flash_bwd``."""
    qkv = torch.zeros(2, 1000, 3, 2, 64, dtype=torch.bfloat16,
                      device="meta")
    q, k, v = (qkv[:, :, i] for i in range(3))
    g = torch.zeros(2, 1000, 2, 64, dtype=torch.bfloat16, device="meta")
    stats = torch.zeros(2, 2, 1000, device="meta")
    seen = []
    real_zeros, real_empty = torch.zeros, torch.empty

    def zeros(*shape, **kw):
        seen.append(("zeros", shape, kw.get("dtype")))
        return real_zeros(*shape, **kw)

    def empty(*shape, **kw):
        seen.append(("empty", shape[0] if len(shape) == 1 else shape,
                     kw.get("dtype")))
        return real_empty(*shape, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "zeros", zeros)
        mp.setattr(torch, "empty", empty)
        _call(wrapper, q, k, v, g, stats, stats, causal=causal)
    (name, args), = fake_lib.calls
    assert name == "kftpu_flash_bwd"
    strides = list(args[10])
    assert strides[:3] == [1000 * 3 * 2 * 64, 3 * 2 * 64, 64]
    tail = args[14:21]   # B, H, S, D, n_work, block_q, block_k
    assert tail[:4] == (2, 2, 1000, 64)
    assert tail[4] == len(fa.wgmma_work("flash_bwd", 1000, causal))
    assert tuple(tail[5:7]) == at.WGMMA_TILES["flash_bwd"]
    assert ("zeros", (1 + 2 * 2 * 16,), torch.int32) in seen
    assert ("empty", (2, 1000, 2, 64), torch.float32) in seen
    assert fa.launches == dict(fa.launches, flash_bwd=1, flash_bwd_dq=0,
                               flash_bwd_dkv=0)


@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (64, torch.float32),
                                     (256, torch.bfloat16)])
def test_other_routes_launch_the_dq_and_dkv_kernels(fake_lib, D, dtype):
    """Past the fused kernel's route ``flash_bwd`` launches the dQ kernel
    and the dK/dV kernel, each counted under its own name, with no list
    and no workspace."""
    q = torch.zeros(1, 256, 2, D, dtype=dtype, device="meta")
    assert not fa.fused_backward(q)
    fa.flash_bwd(q, *_bwd_inputs(q))
    assert [name for name, _ in fake_lib.calls] == [
        "kftpu_flash_bwd_dq", "kftpu_flash_bwd_dkv"]
    assert fa.launches == dict(fa.launches, flash_bwd=0, flash_bwd_dq=1,
                               flash_bwd_dkv=1)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_cpu_tensors_take_the_plain_path_and_count_no_launch(fake_lib,
                                                             wrapper):
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 70, 2, 64))
                                   .astype(np.float32)).bfloat16()
                  for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(g, out)
    before = dict(fa.launches)
    got = _call(wrapper, q, k, v, g, lse, delta)
    assert fake_lib.calls == [] and fa.launches == before
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta))
    got = {"flash_bwd": got, "flash_bwd_dq": (got,)}.get(wrapper, got)
    part = {"flash_bwd": want, "flash_bwd_dq": want[:1]}.get(wrapper,
                                                              want[1:])
    for a, b in zip(got, part):
        assert torch.equal(a, b)
