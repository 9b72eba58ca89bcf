"""Continuous-batching decode engine over the dense or the paged KV cache.

PyTorch port of ``kubeflow_tpu/serving/engine.py``: one engine per
loaded LM version; concurrent generate requests share ONE decode step
over ``slots`` rows, forever. Idle rows decode garbage that nothing
reads.

Dense mode (the default, as in the reference): the cache is
``slots`` full-context rows (``models/transformer.py:DenseKVCache``).

- **admission** prefills the prompt at batch 1 into a fresh row (one
  power-of-two prompt bucket per shape) and copies the row into a free
  slot; a **burst** of pending requests sharing a prompt bucket prefills
  as ONE batch of up to ``admit_batch_max`` rows, then each row is
  copied into its slot. The batch prefill finishes (its tokens reach
  the host) before any copy, so its failure leaves the engine cache
  intact and the members retry on the row path; a failed copy has
  half-written the cache, fails the chunk and closes the engine;
- a **prefix LRU**, budgeted in bytes, keeps prefilled prompt prefixes
  as 1-row caches; a hit continues a COPY of the stored row by the
  suffix, so a stored entry never changes.

Paged mode (``paged=True`` / ``KFTPU_PAGED=1``):

- **admission** is page-map surgery: reserve the request's worst case
  in the page pool (``serving/kvpool.py``), map shared prefix pages
  (copy-on-write split of a partial boundary page), arm the slot's row;
  requests that cannot reserve yet hold the strict-FIFO head of line;
- **chunked prefill** feeds the prompt into the pool one fixed-width
  chunk per scheduler cycle, interleaved with co-tenant decode steps,
  so a long admission never stalls decode for more than one chunk;
- **retirement** frees the slot's pages and disarms its row.

Both modes:

- **step**: every slot advances ``steps_per_sync`` tokens per host
  round-trip; an all-greedy batch takes the argmax step and skips the
  sampler; otherwise rows sample through the configured sampler with
  Gumbel noise keyed on ``(seed, step)`` alone, so a request's tokens
  never depend on its co-tenants or its row;
- **recovery**: a failed device call (paged admission, prefill chunks
  and retirement; the step in both modes) rebuilds a zeroed cache (and
  a fresh page pool) and replays every in-flight stream, prompt plus
  emitted tokens, sampling on at its preserved step index, up to
  ``recoveries`` times; then the engine closes.

Tracing and the request ledger, as in the reference: ``submit``
captures the caller's span context (the serving handler's span, which
continues the request's ``traceparent``), and the engine parents its
spans on it: ``engine.queue_wait``, ``engine.admit`` with its
``engine.prefill`` (or, paged, one ``engine.prefill_chunk`` a chunk),
``engine.first_token``, ``engine.decode``, and, paged, one
``engine.step`` a shared step. Every request is one
``RequestLedger`` record keyed by its trace id; its phase marks ride
the clock reads the engine already takes, and the per-token emit reads
no clock (one timestamp a sync batch).

Over a mesh (``mesh=``: the reference's multi-chip serving), the model
is built over it (``Transformer(config, mesh=)``, each rank its block of
every split leaf) and the cache is created split: each rank's rows or
pages hold its kv heads (``KH/tp``, or all of them where ``tp`` does
not divide them), so a rank's pool is ``1/tp`` of the unsplit one's
bytes. The page allocator, the prefix stores and the page tables are
host state, the same on every rank. Over ``dp`` or ``pp`` > 1 every rank
of those axes runs the whole batch on the same rows: the model keeps
every block (a served model is not pipelined) and its MoE experts stay
split over ``dp`` (``models/transformer.py:MoeMlp._serve``). The
reference's engine declares its cache split over the kv heads alone
(``kubeflow_tpu/serving/engine.py:714-733``: the slot axis replicated
over ``dp``, as here), and feeds each step host arrays; XLA's
partitioner then lays the dense cache's slot axis and the positions
over ``dp`` on the first step's output. The tokens are the same either
way. Two ways to drive it:

- **SPMD**: every rank builds the engine and makes the same calls
  (``submit``, ``run_once``) in the same order;
- **lockstep** (``link=``, ``serving/lockstep.py``): rank 0 schedules;
  before each device program (a ``_program`` method: a row, prefix or
  batch prefill, a prefill chunk, a decode round, a row copy, a page
  write, a cache rebuild) it sends the program's plan, and each
  follower's twin engine runs the same program through :meth:`follow`.
  A program works on its engine's own cache and its last prefilled row,
  prefix row and batch, so its arguments are the rank 0 scheduler's
  decisions alone. The request ledger and the ``engine.*`` spans stay
  on rank 0.

Environment switches (as in the reference): ``KFTPU_PAGED`` (default
0), ``KFTPU_ADMIT_BATCH`` (8), ``KFTPU_ENGINE_RECOVERIES`` (2),
``KFTPU_PREFIX_CACHE_BYTES``, ``KFTPU_PAGED_ATTN``,
``KFTPU_SAMPLER_IMPL``, ``KFTPU_SAMPLER_BOUND``, ``KFTPU_KV_PAGE_SIZE``,
``KFTPU_KV_PAGES``, ``KFTPU_PREFILL_CHUNK``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import os
import queue
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models.decode import (
    arm_slot,
    copy_page,
    decode_step,
    init_cache,
    prefill,
    prefill_chunk,
    prefill_continue,
    sample_logits,
)
from kubeflow_tpu_torch.models.transformer import DenseKVCache, Transformer
from kubeflow_tpu_torch.obs import requests as reqobs
from kubeflow_tpu_torch.obs.trace import (
    SpanContext,
    Tracer,
    current_context,
    profiler_annotator,
)
from kubeflow_tpu_torch.ops.sampling import fused_sample, gumbel_noise
from kubeflow_tpu_torch.serving.kvpool import (
    OutOfPages,
    PagePool,
    PrefixPageStore,
)
from kubeflow_tpu_torch.utils import DEFAULT_REGISTRY
from kubeflow_tpu_torch.utils.clock import Clock
from kubeflow_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_steps_total = DEFAULT_REGISTRY.counter(
    "kftpu_engine_steps_total", "shared decode steps executed")
_tokens_total = DEFAULT_REGISTRY.counter(
    "kftpu_engine_tokens_total", "tokens produced by the decode engine")
_occupancy = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_active_slots", "active slots in the decode batch")
_slots_g = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_slots",
    "decode-slot capacity of the engine (static; scrapers read it so "
    "queue depth can be priced in slot units without a config hint)")
_queue_depth = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_pending_requests", "requests waiting for a slot")
_prefix_hits = DEFAULT_REGISTRY.counter(
    "kftpu_engine_prefix_hits_total", "prefix-cache hits at admission")
_prefix_misses = DEFAULT_REGISTRY.counter(
    "kftpu_engine_prefix_misses_total", "prefix-cache misses at admission")
_prefix_bytes_g = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_prefix_cache_bytes",
    "HBM bytes held by cached prompt-prefix KV rows")
_prefix_budget_g = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_prefix_cache_budget_bytes",
    "prefix-cache byte budget (entries evict LRU to stay under it)")
_queue_wait_h = DEFAULT_REGISTRY.histogram(
    "engine_queue_wait_seconds",
    "time a generate request waits for a decode slot")
_kv_pages_g = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_kv_pages_in_use",
    "physical KV pages allocated out of the paged engine's pool")
_kv_pages_free_g = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_kv_pages_free",
    "unallocated KV pages left in the paged engine's pool (the "
    "engine-pages-exhausted alert rule watches this)")
_kv_pages_evictable_g = DEFAULT_REGISTRY.gauge(
    "kftpu_engine_kv_pages_evictable",
    "prefix-store pages no live slot shares: reclaimable cache, not "
    "load — occupancy/pressure consumers (autoscaler, fleet-edge "
    "admission gate) subtract these from the in-use count")
_prefill_chunks_c = DEFAULT_REGISTRY.counter(
    "kftpu_engine_prefill_chunks_total",
    "prompt chunks prefilled by the paged engine's interleaved scheduler")
_prefix_pages_shared_c = DEFAULT_REGISTRY.counter(
    "kftpu_engine_prefix_pages_shared_total",
    "KV pages mapped from the prefix trie into admitted slots "
    "(full shared pages + COW boundary pages)")
_cow_splits_c = DEFAULT_REGISTRY.counter(
    "kftpu_engine_cow_splits_total",
    "copy-on-write splits of shared boundary pages (one device-side "
    "page copy each, in place of a boundary re-prefill)")

_END = object()  # per-request stream sentinel


class EngineClosed(RuntimeError):
    """The engine was shut down (version rollover) — retryable."""


class _CacheInvalidated(RuntimeError):
    """A burst's row copy failed after half-writing the engine cache: no
    row-path retry can succeed against it. Raised through ``run_once``
    so the loop closes the engine."""


def pow2_bucket(n: int, cap: int) -> int:
    """Round ``n`` up to a power of two, capped at ``cap`` (itself a
    bucket even when not a power of two); ``n <= 0`` buckets to 1. The
    shared prompt bucketing of the unary path and engine admission."""
    if cap < 1:
        raise ValueError(f"pow2_bucket cap must be >= 1, got {cap}")
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class _Request:
    prompt: np.ndarray           # (S,) int32, true length
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    eos_id: Optional[int]
    prefix_len: int = 0          # leading prompt tokens to share
    # the submitting thread's span context: engine spans parent on it
    ctx: Optional[SpanContext] = None
    t_submit: float = 0.0
    # the ledger key: the propagated trace id, else a synthetic one
    rid: str = ""
    # the queue wait is observed once: a failed burst retries its
    # members on the row path
    _wait_noted: bool = False
    out: "queue.Queue[Any]" = dataclasses.field(default_factory=queue.Queue)
    error: Optional[Exception] = None
    _seen: List[int] = dataclasses.field(default_factory=list)
    _done: bool = False

    def stream(self):
        """Yield token ids as the engine produces them (replayable)."""
        yield from list(self._seen)
        while not self._done:
            tok = self.out.get()
            if tok is _END:
                self._done = True
                if self.error is not None:
                    raise self.error
                return
            self._seen.append(tok)
            yield tok
        if self.error is not None:
            raise self.error

    def result(self) -> List[int]:
        return list(self.stream())


@dataclasses.dataclass
class _Slot:
    req: _Request
    produced: int = 0
    t_decode0: float = 0.0       # the decode span's start
    # every token emitted, in order: a recovery replays prompt + these
    emitted: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PrefillJob:
    """A slot mid-chunked-prefill (paged mode)."""

    req: _Request
    slot: int
    tokens: np.ndarray        # the token sequence to prefill
    next: int                 # next position to feed
    t_admit: float = 0.0      # the chunked admit span's start
    chunks: int = 0
    # a recovery replay resumes a live stream: its sample continues at
    # the preserved step index and delivery count
    fold0: int = 0
    produced0: int = 0
    store_prefix: int = 0     # prefix tokens to pin in the trie after
    last_tok: int = 0         # sampled next token, set by the final chunk


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw else default


def _host(x):
    """A program argument as a lockstep plan carries it: a tensor as
    host numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


# the engine's device programs, by name (:meth:`DecodeEngine.follow`)
_PROGRAMS = set()
# the programs that sample: they return their tokens
_SAMPLES = {"_step", "_step_greedy", "_prefill", "_continue",
            "_prefill_batch", "_chunk"}


def _program(fn):
    """A device program of the engine: it works on the engine's own
    cache, rows and batch, so its arguments are host values or tensors.
    Over a lockstep link (``serving/lockstep.py``) the leader sends its
    name and host arguments before it runs, and :meth:`DecodeEngine.
    follow` runs it on the other ranks. With ``token_log`` set, the
    tokens it samples are logged (on every rank: the lockstep tests
    compare them)."""
    name = fn.__name__
    _PROGRAMS.add(name)

    @functools.wraps(fn)
    def run(self, *args):
        with (self._link(name, *map(_host, args)) if self._link is not None
              else contextlib.nullcontext()):
            out = fn(self, *args)
        if (self.token_log is not None and name in _SAMPLES
                and out is not None):
            self.token_log.append((name, out.cpu().numpy().copy()))
        return out

    return run


class DecodeEngine:
    """One engine per loaded transformer model version.

    ``params`` is a port :class:`Transformer` already on ``device``, or a
    JAX-layout param tree (nested or flat numpy; ``models/convert.py``).
    ``submit()`` is thread-safe and returns a handle whose ``stream()``
    yields tokens as steps complete; ``close()`` drains the engine.
    ``precompile=True`` runs both step paths once at construction (on
    the card: the sampler's build and the first GEMM setups), so the
    first greedy/sampled switch never pauses live streams. ``tracer``
    (default: one on the engine's clock, into the process collector)
    and ``request_ledger`` (default :data:`~kubeflow_tpu_torch.obs.
    requests.DEFAULT_LEDGER`) receive the spans and the records.
    """

    def __init__(self, config, params, *, slots: int = 8,
                 steps_per_sync: int = 1,
                 prefix_cache_entries: int = 4,
                 prefix_cache_bytes: Optional[int] = None,
                 sampler_bound: Optional[int] = None,
                 sampler_impl: Optional[str] = None,
                 admit_batch_max: Optional[int] = None,
                 paged: Optional[bool] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 paged_attention_impl: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_chunks_per_cycle: int = 1,
                 recoveries: Optional[int] = None,
                 precompile: bool = False,
                 autostart: bool = True, name: str = "",
                 clock: Optional[Clock] = None,
                 tracer: Optional[Tracer] = None,
                 request_ledger: Optional[reqobs.RequestLedger] = None,
                 device=None, mesh=None, link=None) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
        self._link = link
        self.token_log: Optional[list] = None
        if paged is None:
            paged = os.environ.get("KFTPU_PAGED", "0") not in ("0", "")
        self.paged = bool(paged)
        if recoveries is None:
            recoveries = _env_int("KFTPU_ENGINE_RECOVERIES", 2)
        self._recoveries_left = max(0, int(recoveries))
        self.config = config
        self.slots = slots
        self.clock: Clock = clock if clock is not None else time.monotonic
        # spans on the engine's clock, mirrored onto the profiler's host
        # timeline while one records
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self.clock, annotator=profiler_annotator())
        self.rledger = (request_ledger if request_ledger is not None
                        else reqobs.DEFAULT_LEDGER)
        if sampler_bound is None:
            sampler_bound = _env_int("KFTPU_SAMPLER_BOUND", 64)
        self.sampler_bound = int(sampler_bound)
        if sampler_impl is None:
            sampler_impl = os.environ.get("KFTPU_SAMPLER_IMPL", "auto")
        if sampler_impl == "auto":
            sampler_impl = "bounded" if self.sampler_bound > 0 else "fused"
        if sampler_impl not in ("bounded", "exact_sort", "fused"):
            raise ValueError(
                f"unknown sampler_impl {sampler_impl!r}; valid: auto, "
                "bounded, exact_sort, fused")
        self.sampler_impl = sampler_impl
        Smax = config.max_seq_len
        if self.paged:
            # page size = largest power-of-two divisor of max_seq_len up
            # to 64; the pool defaults to full provisioning
            if kv_page_size is None:
                kv_page_size = _env_int("KFTPU_KV_PAGE_SIZE", 0)
            if not kv_page_size:
                kv_page_size = 1
                while kv_page_size < 64 and Smax % (kv_page_size * 2) == 0:
                    kv_page_size *= 2
            self.kv_page_size = int(kv_page_size)
            self._n_logical = Smax // self.kv_page_size
            if kv_pages is None:
                kv_pages = _env_int("KFTPU_KV_PAGES",
                                    slots * self._n_logical)
            self.kv_pages = int(kv_pages)
            if prefill_chunk_tokens is None:
                prefill_chunk_tokens = _env_int("KFTPU_PREFILL_CHUNK",
                                                min(256, Smax))
            self.prefill_chunk_tokens = max(1, int(prefill_chunk_tokens))
            self.prefill_chunks_per_cycle = max(
                1, int(prefill_chunks_per_cycle))
            if paged_attention_impl is None:
                paged_attention_impl = os.environ.get("KFTPU_PAGED_ATTN",
                                                      "auto")
            self.paged_attention_impl = paged_attention_impl
            self._cfg = dataclasses.replace(
                config, kv_page_size=self.kv_page_size,
                kv_pages=self.kv_pages,
                paged_attention_impl=paged_attention_impl)
            self._cfg.validate()
        else:
            self.kv_page_size = 0
            self.kv_pages = 0
            self.paged_attention_impl = "gather"
            self._cfg = dataclasses.replace(config, kv_page_size=0,
                                            kv_pages=0)
        # burst admission: same-bucket pending requests prefill as ONE
        # batch of up to this many rows (<= 1: every request takes the
        # row path)
        if admit_batch_max is None:
            admit_batch_max = _env_int("KFTPU_ADMIT_BATCH", 8)
        self.admit_batch_max = int(admit_batch_max)
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.name = name or "model"
        _slots_g.set(self.slots, model=self.name)

        if isinstance(params, Transformer):
            if params.mesh is not mesh:
                raise ValueError("the engine's mesh is not the one the "
                                 "model was built over")
            self._model = params
        else:
            self._model = convert.to_module(config, params,
                                            device=self.device, mesh=mesh)
        self._cache = self._new_cache(slots)
        # the last prefilled row, prefix row and batch (the programs'
        # hand-offs)
        self._row = self._prefix_row = self._batch = None

        itemsize = torch.finfo(self._cfg.dtype).bits // 8
        kv_row = (2 * config.n_layers * config.n_kv_heads
                  * config.head_dim * itemsize)
        if self.paged:
            self._page_bytes = kv_row * self.kv_page_size
            self._prefix_row_bytes = self._page_bytes * self._n_logical
        else:
            # a stored prefix row is a 1-row cache: K/V over the whole
            # context plus an int32 position a layer (the reference's
            # cache leaves)
            self._prefix_row_bytes = kv_row * Smax + 4 * config.n_layers
        if prefix_cache_bytes is None:
            env = os.environ.get("KFTPU_PREFIX_CACHE_BYTES")
            prefix_cache_bytes = (int(env) if env else
                                  max(0, int(prefix_cache_entries))
                                  * self._prefix_row_bytes)
        self._prefix_budget_bytes = max(0, int(prefix_cache_bytes))
        _prefix_budget_g.set(self._prefix_budget_bytes, model=self.name)
        # dense prefix LRU: (len, token bytes) -> 1-row cache
        self._prefix_store: "collections.OrderedDict[Any, DenseKVCache]" \
            = collections.OrderedDict()
        self.prefix_cache_bytes = 0

        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._active: List[Optional[_Slot]] = [None] * slots
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # host-side per-slot sampling state
        self._tokens = np.zeros((slots,), np.int32)
        self._seeds = np.zeros((slots,), np.int64)
        self._stepidx = np.zeros((slots,), np.int64)
        self._temps = np.zeros((slots,), np.float32)
        self._topk = np.zeros((slots,), np.int32)
        self._topp = np.ones((slots,), np.float32)
        self.steps_total = 0
        self.tokens_total = 0
        self.greedy_steps = 0
        self.batch_prefills = 0
        self.prefill_chunks = 0
        self.recoveries = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_pages_shared = 0
        self.cow_splits = 0
        # paged mode's scheduler state (empty in dense mode)
        self._prefilling: "collections.OrderedDict[int, _PrefillJob]" = \
            collections.OrderedDict()
        self._waiting: "collections.deque[_Request]" = collections.deque()
        if self.paged:
            self._pool = PagePool(self.kv_pages, self.kv_page_size, slots,
                                  self._n_logical)
            self._prefix_pages = PrefixPageStore(
                self._pool,
                self._prefix_budget_bytes // max(1, self._page_bytes))
            # host-authoritative per-slot position (device values drift
            # for idle and mid-prefill rows by design)
            self._pos_host = np.zeros((slots,), np.int64)
            self._slot_budget = np.zeros((slots,), np.int64)
        if precompile:
            self._precompile_steps()
        if autostart:
            self.start()

    @_program
    def _fresh_cache(self) -> None:
        """A zeroed engine cache (paged: every row disarmed), holding
        this rank's kv heads on a split model."""
        self._cache = self._new_cache(self.slots)

    def _new_cache(self, rows: int):
        return init_cache(self._cfg, rows, device=self.device,
                          kv_heads=self._model.cache_kv_heads)

    def settings(self) -> dict:
        """The resolved constructor arguments that shape the engine's
        programs: a follower rank builds its twin from them."""
        return {"slots": self.slots, "steps_per_sync": self.steps_per_sync,
                "prefix_cache_bytes": self._prefix_budget_bytes,
                "sampler_bound": self.sampler_bound,
                "sampler_impl": self.sampler_impl,
                "admit_batch_max": self.admit_batch_max,
                "paged": self.paged, "kv_page_size": self.kv_page_size,
                "kv_pages": self.kv_pages,
                "paged_attention_impl": self.paged_attention_impl,
                "prefill_chunk_tokens": getattr(
                    self, "prefill_chunk_tokens", None),
                "prefill_chunks_per_cycle": getattr(
                    self, "prefill_chunks_per_cycle", 1),
                "recoveries": self._recoveries_left, "name": self.name}

    @torch.no_grad()
    def follow(self, op: str, args) -> None:
        """Run the leader's program ``op`` with its plan's host
        arguments on this rank's shard."""
        if op not in _PROGRAMS:
            raise ValueError(f"unknown engine program {op!r}")
        getattr(self, op)(*args)

    @torch.no_grad()
    def _precompile_steps(self) -> None:
        """Run both step paths once on the empty batch; the junk lands in
        rows admission overwrites (dense) or writes nowhere (paged rows
        are disarmed)."""
        B = self.slots
        toks = torch.zeros((B,), dtype=torch.int32, device=self.device)
        zeros = np.zeros((B,), np.int64)
        self._step_greedy(toks)
        self._step(toks, zeros, zeros, np.ones((B,), np.float32),
                   np.zeros((B,), np.int32), np.ones((B,), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- sampling ----------------------------------------------------------

    def _sampling(self, temps, tks, tps):
        """The rows that sample, and the per-row settings on the device."""
        dev = self.device
        return ([i for i, t in enumerate(temps) if t > 0.0],
                torch.as_tensor(np.asarray(temps, np.float32), device=dev),
                torch.as_tensor(np.asarray(tks, np.int32), device=dev),
                torch.as_tensor(np.asarray(tps, np.float32), device=dev))

    def _sample_rows(self, logits, seeds, folds, temps, tks, tps, *,
                     settings=None):
        """Per-row sampling under the ``(seed, step)`` contract; (B, V)
        logits in, (B,) int32 tokens out. Noise is drawn only for rows
        that sample (greedy rows never read it). ``settings`` is
        :meth:`_sampling` of the same rows, made once for many steps."""
        rows, temp_t, tk_t, tp_t = (settings if settings is not None
                                    else self._sampling(temps, tks, tps))
        B, V = logits.shape
        dev = logits.device
        drawn = iter(gumbel_noise([seeds[i] for i in rows],
                                  [folds[i] for i in rows], V, device=dev)
                     if rows else ())
        zero = torch.zeros((V,), dtype=torch.float32, device=dev)
        # rows stacked in order: a host-side row index would be a
        # blocking copy to the card (a sync) every step
        sampled = set(rows)
        noise = torch.stack([next(drawn) if i in sampled else zero
                             for i in range(B)])
        if self.sampler_impl == "fused":
            return fused_sample(logits.float().contiguous(), noise, temp_t,
                                tk_t, tp_t)
        bound = (self.sampler_bound if self.sampler_impl == "bounded"
                 and self.sampler_bound > 0 else None)
        return sample_logits(logits, noise, temperature=temp_t, top_k=tk_t,
                             top_p=tp_t, bound=bound)

    # -- device programs (instance attributes, so tests inject faults) -----
    # Each works on the engine's cache (and on its last prefilled row,
    # prefix row or batch), so a follower rank runs the leader's plan as
    # it comes: ``getattr(engine, op)(*args)``.

    @_program
    def _step(self, tokens, seeds, step_idx, temps, top_k, top_p):
        """``steps_per_sync`` sampled decode steps from ``(B,)`` tokens;
        returns the ``(K, B)`` int32 tokens on the device."""
        settings = self._sampling(temps, top_k, top_p)
        tokens = torch.as_tensor(tokens, device=self.device)
        outs = []
        for t in range(self.steps_per_sync):
            logits, self._cache = decode_step(self._model, self._cache,
                                              tokens)
            tokens = self._sample_rows(logits, seeds, step_idx + t, temps,
                                       top_k, top_p, settings=settings)
            outs.append(tokens)
        return torch.stack(outs)

    @_program
    def _step_greedy(self, tokens):
        """The all-greedy step: argmax only, no sampler."""
        tokens = torch.as_tensor(tokens, device=self.device)
        outs = []
        for _ in range(self.steps_per_sync):
            logits, self._cache = decode_step(self._model, self._cache,
                                              tokens)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(tokens)
        return torch.stack(outs)

    @_program
    def _prefill(self, prompt, true_len, temperature, top_k, top_p, seed,
                 fold):
        """Row prefill of a padded ``(1, S)`` prompt into a fresh 1-row
        cache (``self._row``), and its next token sampled at ``(seed,
        fold)``."""
        cache = self._new_cache(1)
        logits, self._row = prefill(self._model, cache, self._on(prompt),
                                    [int(true_len)])
        return self._sample_rows(logits, [seed], [fold], [temperature],
                                 [top_k], [top_p])

    @_program
    def _continue(self, suffix, suffix_len, total_len, temperature, top_k,
                  top_p, seed):
        """The prefix row (``self._prefix_row``) continued by a padded
        ``(1, S)`` suffix into ``self._row``, and the first token at
        ``(seed, 0)``. Continues a COPY: stored prefix rows never
        change."""
        p = self._prefix_row
        row = DenseKVCache(k=p.k.clone(), v=p.v.clone(),
                           positions=p.positions.clone())
        logits, self._row = prefill_continue(
            self._model, row, self._on(suffix), [int(suffix_len)],
            [int(total_len)])
        return self._sample_rows(logits, [seed], [0], [temperature],
                                 [top_k], [top_p])

    @_program
    def _prefill_batch(self, prompts, true_lens, temps, top_ks, top_ps,
                       seeds):
        """Burst admission: same-bucket prompts ``(B, S)`` prefill
        together with ragged lengths into ``self._batch``; each row's
        first token at ``(seed, 0)``, as the row path samples it."""
        cache = self._new_cache(prompts.shape[0])
        logits, self._batch = prefill(self._model, cache, self._on(prompts),
                                      self._on(true_lens))
        return self._sample_rows(logits, seeds, np.zeros_like(seeds), temps,
                                 top_ks, top_ps)

    @_program
    def _insert(self, slot: int) -> None:
        """Copy the prefilled row into ``slot`` of the engine cache."""
        row, cache = self._row, self._cache
        cache.k[:, slot] = row.k[:, 0]
        cache.v[:, slot] = row.v[:, 0]
        cache.positions[slot] = row.positions[0]

    @_program
    def _insert_rows(self, slot_ids, valid) -> None:
        """Copy every valid row of the prefilled batch into its slot at
        once (pad rows stay out)."""
        rows = np.flatnonzero(valid)
        src = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        dst = torch.as_tensor(np.asarray(slot_ids)[rows], dtype=torch.long,
                              device=self.device)
        batch, cache = self._batch, self._cache
        cache.k[:, dst] = batch.k[:, src]
        cache.v[:, dst] = batch.v[:, src]
        cache.positions[dst] = batch.positions[src]

    @_program
    def _arm(self, slot: int, start: int, page_row) -> None:
        """Point one paged row at its pages (``arm_slot``)."""
        arm_slot(self._cache, slot, start, page_row)

    @_program
    def _copy_page(self, src: int, dst: int) -> None:
        """The copy-on-write split of one page (``copy_page``)."""
        copy_page(self._cache, src, dst)

    @_program
    def _chunk(self, tokens, slot: int, start: int, n: int, sample):
        """One padded ``(1, C)`` prompt chunk into ``slot``'s pages from
        ``start`` (``n`` real tokens). With ``sample`` = (seed, step
        index, temperature, top-k, top-p), the token after it ``(1,)``;
        else None."""
        logits, self._cache = prefill_chunk(
            self._model, self._cache, self._on(tokens), slot, start, n)
        if sample is None:
            return None
        seed, fold, temp, tk, tp = sample
        return self._sample_rows(logits, [seed], [fold], [temp], [tk], [tp])

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    # -- public API --------------------------------------------------------

    def submit(self, prompt, *, max_new: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_id: Optional[int] = None,
               prefix_len: int = 0) -> _Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + max_new > self.config.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new} exceeds "
                f"context {self.config.max_seq_len}")
        if self.paged:
            # a request past the whole pool could never reserve: it would
            # wedge the FIFO head of line forever
            need = self._pool.pages_needed(prompt.size + max_new)
            if need > self._pool.pages_total:
                raise ValueError(
                    f"prompt {prompt.size} + max_new {max_new} needs "
                    f"{need} KV pages but the pool holds only "
                    f"{self._pool.pages_total} — raise kv_pages or shrink "
                    f"the request")
        prefix_len = int(prefix_len)
        if prefix_len and not 0 < prefix_len < prompt.size:
            raise ValueError(
                f"prefix_len {prefix_len} must be in (0, prompt length "
                f"{prompt.size}) — the suffix may not be empty")
        if (not self.paged
                and self._prefix_budget_bytes < self._prefix_row_bytes):
            # one full-context row alone busts the byte budget: serve
            # the full prefill
            prefix_len = 0
        req = _Request(prompt=prompt, max_new=max_new,
                       temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), seed=int(seed), eos_id=eos_id,
                       prefix_len=prefix_len, ctx=current_context(),
                       t_submit=self.clock())
        # the record opens BEFORE the queue put: the engine thread may
        # admit the request at once, and its marks must find it
        req.rid = (req.ctx.trace_id if req.ctx is not None
                   else reqobs.synthetic_rid())
        self.rledger.start(req.rid, t=req.t_submit, model=self.name)
        with self._lock:
            if self._stop.is_set():
                self.rledger.finish(req.rid, req.t_submit)
                raise EngineClosed("decode engine closed")
            self._pending.put(req)
        _queue_depth.set(self._pending.qsize(), model=self.name)
        return req

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"decode-engine-{self.name}")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fail_all(EngineClosed("decode engine closed"))
        link, self._link = self._link, None
        if link is not None:        # the followers drop their twin
            with link("close"):
                pass

    def _fail_all(self, error: Exception) -> None:
        with self._lock:
            failed = [s.req for s in self._active if s is not None]
            self._active = [None] * self.slots
            failed.extend(j.req for j in self._prefilling.values())
            self._prefilling.clear()
            failed.extend(self._waiting)
            self._waiting.clear()
            while True:
                try:
                    failed.append(self._pending.get_nowait())
                except queue.Empty:
                    break
        t_fail = self.clock()
        for req in failed:
            req.error = error
            req.out.put(_END)
            self.rledger.finish(req.rid, t_fail)

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    @property
    def active_count(self) -> int:
        """Slots serving a stream: decoding plus mid-prefill."""
        with self._lock:
            n = sum(s is not None for s in self._active)
        return n + len(self._prefilling)

    @property
    def pending_count(self) -> int:
        return self._pending.qsize() + len(self._waiting)

    def snapshot(self) -> dict:
        """Occupancy snapshot (the reference's keys; paged mode adds the
        page pool's)."""
        snap = {"active_slots": self.active_count,
                "pending": self.pending_count,
                "slots": self.slots,
                "closed": self.closed}
        if self.paged:
            snap.update({
                "paged": True,
                "page_size": self.kv_page_size,
                "pages_total": self._pool.pages_total,
                "pages_free": self._pool.pages_free,
                "pages_in_use": self._pool.pages_in_use,
                "pages_reserved": self._pool.reserved_total,
                "pages_evictable": self._prefix_pages.pages_evictable,
                "prefill_slots": len(self._prefilling),
                "paged_attention_impl": self.paged_attention_impl,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_pages_shared": self.prefix_pages_shared,
                "cow_splits": self.cow_splits})
        return snap

    # -- the scheduler cycle -------------------------------------------------

    def _emit(self, slot: _Slot, token: int, t: float) -> None:
        """The per-token hot path. ``t`` is a timestamp the caller
        already read (``run_once`` stamps every token of a sync batch
        with one step-end time); neither this method nor the ledger
        reads a clock here."""
        slot.produced += 1
        slot.emitted.append(token)
        self.tokens_total += 1
        _tokens_total.inc(model=self.name)
        self.rledger.emit(slot.req.rid, t)
        slot.req.out.put(token)

    def _finished(self, slot: _Slot, token: int, t: float) -> bool:
        done = (slot.produced >= slot.req.max_new or
                (slot.req.eos_id is not None and token == slot.req.eos_id))
        if done:
            slot.req.out.put(_END)
            # the last token: fold the record on the same timestamp
            self.rledger.finish(slot.req.rid, t)
        return done

    def _note_queue_wait(self, req: _Request) -> float:
        """Close the request's queue phase (once: a failed burst retries
        its members on the row path): the histogram with the trace as
        exemplar, the ``engine.queue_wait`` span, and the ledger's mark
        of admission, all on one timestamp. Returns now."""
        now = self.clock()
        if req._wait_noted:
            return now
        req._wait_noted = True
        _queue_wait_h.observe(
            max(0.0, now - req.t_submit),
            exemplar_trace_id=(req.ctx.trace_id
                               if req.ctx is not None else None),
            model=self.name)
        self.tracer.record("engine.queue_wait", start=req.t_submit,
                           end=now, parent=req.ctx,
                           attrs={"model": self.name})
        self.rledger.mark(req.rid, reqobs.ADMISSION, now)
        return now

    @torch.no_grad()
    def run_once(self, timeout: float = 0.1) -> bool:
        """One admit + prefill-chunk + step cycle; True if work happened.
        The background loop calls this forever; tests call it directly
        (``autostart=False``) for deterministic schedules. A failed
        device call is recovered in place while the budget lasts."""
        if self.paged:
            try:
                worked = self._admit_paged(timeout)
                worked = self._prefill_tick() or worked
            except Exception:  # noqa: BLE001 — the cache may be half-written
                log.exception("paged admission/prefill failed")
                if self._maybe_recover("paged admission/prefill"):
                    return True
                raise
        else:
            worked = self._admit_dense(timeout)
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._active)
                      if s is not None]
        if not active:
            return worked
        # greedy rows ignore seeds and filters, so an all-greedy batch
        # takes the argmax step, bit-identical, without the sampler
        all_greedy = all(s.req.temperature <= 0.0 for _, s in active)
        t_step0 = self.clock()
        try:
            if self.paged:
                self._ensure_pages(i for i, _ in active)
            tokens = torch.as_tensor(self._tokens, device=self.device)
            if all_greedy:
                toks = self._step_greedy(tokens)
            else:
                toks = self._step(tokens, self._seeds, self._stepidx,
                                  self._temps, self._topk, self._topp)
            # (K, B): one host sync a round-trip; it also surfaces a
            # device failure while recovery can still replay
            toks = toks.cpu().numpy()
        except Exception:  # noqa: BLE001
            log.exception("decode step failed")
            if self._maybe_recover("decode step"):
                return True
            raise
        # one clock read a sync batch, after the host copy: when every
        # token of it became visible. The emits below all ride it
        t_step_end = self.clock()
        K = toks.shape[0]
        self.steps_total += K
        if all_greedy:
            self.greedy_steps += K
        _steps_total.inc(K, model=self.name)
        self._stepidx += K
        self._tokens = toks[-1].copy()
        if self.paged:
            self._pos_host[[i for i, _ in active]] += K
            # one span a shared step: chunk spans between step spans
            # bound any decode stall
            self.tracer.record(
                "engine.step", start=t_step0, end=t_step_end,
                attrs={"model": self.name, "rows": len(active), "k": K})
        retired: List[int] = []
        for i, slot in active:
            for t in range(K):
                tok = int(toks[t, i])
                self._emit(slot, tok, t_step_end)
                if self._finished(slot, tok, t_step_end):
                    # tokens past EOS or the budget are discarded
                    with self._lock:
                        self._active[i] = None
                    retired.append(i)
                    self.tracer.record(
                        "engine.decode", start=slot.t_decode0,
                        end=t_step_end, parent=slot.req.ctx,
                        attrs={"model": self.name,
                               "tokens": slot.produced})
                    break
        if self.paged and retired:
            # after the emit loop, so a failure here replays streams
            # whose accounting is complete
            try:
                for i in retired:
                    self._retire_paged(i)
            except Exception:  # noqa: BLE001
                log.exception("paged retirement failed")
                if not self._maybe_recover("paged retirement"):
                    raise
        _occupancy.set(self.active_count, model=self.name)
        return True

    # -- dense admission ---------------------------------------------------

    def _admit_dense(self, timeout: float) -> bool:
        """Move pending requests into free slots. A burst sharing a prompt
        bucket admits through one batch prefill; singletons and prefix
        requests take the row path."""
        admitted = False
        with self._lock:
            free = [i for i, s in enumerate(self._active) if s is None]
            block = len(free) == self.slots
        batchable: List[tuple] = []
        for slot in free:
            try:
                req = self._pending.get(block=block and not admitted,
                                        timeout=timeout)
            except queue.Empty:
                break
            admitted = True
            if req.prefix_len or self.admit_batch_max <= 1:
                self._admit_row_safe(req, slot)
            else:
                batchable.append((req, slot))
        groups: dict = {}
        for req, slot in batchable:
            b = pow2_bucket(req.prompt.size, self.config.max_seq_len)
            groups.setdefault(b, []).append((req, slot))
        chunks = [(bucket, members[i:i + self.admit_batch_max])
                  for bucket, members in groups.items()
                  for i in range(0, len(members), self.admit_batch_max)]
        for n, (bucket, chunk) in enumerate(chunks):
            if len(chunk) == 1:
                self._admit_row_safe(*chunk[0])
                continue
            try:
                self._admit_batch(bucket, chunk)
            except _CacheInvalidated:
                # the later chunks are off the queue and in no slot, so
                # the loop's _fail_all cannot reach them
                t_fail = self.clock()
                for _, rest in chunks[n + 1:]:
                    for req, _slot in rest:
                        req.error = EngineClosed(
                            "engine cache invalidated during admission")
                        req.out.put(_END)
                        self.rledger.finish(req.rid, t_fail)
                raise
            except Exception:  # noqa: BLE001
                # the engine cache is intact (the prefill finished
                # before any copy): each member retries alone
                log.exception("batched admission failed; retrying %d "
                              "request(s) individually", len(chunk))
                for req, slot in chunk:
                    self._admit_row_safe(req, slot)
        _queue_depth.set(self._pending.qsize(), model=self.name)
        _occupancy.set(self.active_count, model=self.name)
        return admitted

    def _admit_row_safe(self, req: _Request, slot: int) -> None:
        """Row-path admission whose failure reaches THIS request only."""
        try:
            self._admit_one(req, slot)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            req.error = e
            req.out.put(_END)
            self.rledger.finish(req.rid, self.clock())

    def _admit_one(self, req: _Request, slot: int) -> None:
        """Prefill the request's prompt (through the prefix LRU when it
        names a prefix) and copy the row into ``slot``."""
        self._note_queue_wait(req)
        S = req.prompt.size
        Smax = self.config.max_seq_len
        with self.tracer.span("engine.admit", parent=req.ctx, attrs={
                "model": self.name, "slot": slot,
                "prompt_tokens": int(S), "batched": False}):
            # the prefill phase opens here (a prefix row's prefill is
            # prefill work too)
            self.rledger.mark(req.rid, reqobs.PREFILL, self.clock())
            if req.prefix_len:
                N = req.prefix_len
                self._prefix_cache_row(req.prompt[:N])
                suf = S - N
                sbucket = pow2_bucket(suf, Smax)
                if N + sbucket > Smax:
                    # a padded suffix would pass the context end and
                    # clamp its write start: serve the exact length
                    sbucket = suf
                padded = np.zeros((1, sbucket), np.int32)
                padded[0, :suf] = req.prompt[N:]
                with self.tracer.span("engine.prefill", attrs={
                        "prompt_tokens": int(S), "prefix_len": int(N)}):
                    tok = self._continue(padded, suf, S, req.temperature,
                                         req.top_k, req.top_p, req.seed)
            else:
                bucket = pow2_bucket(S, Smax)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :S] = req.prompt
                with self.tracer.span("engine.prefill", attrs={
                        "prompt_tokens": int(S), "bucket": bucket}):
                    tok = self._prefill(padded, S, req.temperature,
                                        req.top_k, req.top_p, req.seed, 0)
            self._insert(slot)
        self._finalize_admission(req, slot, int(tok[0]))

    @_program
    def _prefix_cache_row(self, prefix: np.ndarray) -> None:
        """The 1-row cache holding this prefilled prefix into
        ``self._prefix_row`` (LRU, byte budget)."""
        key = (prefix.size, prefix.tobytes())
        cached = self._prefix_store.get(key)
        if cached is not None:
            self._prefix_store.move_to_end(key)
            self.prefix_hits += 1
            _prefix_hits.inc(model=self.name)
            self._prefix_row = cached
            return
        self.prefix_misses += 1
        _prefix_misses.inc(model=self.name)
        N = prefix.size
        padded = np.zeros((1, pow2_bucket(N, self.config.max_seq_len)),
                          np.int32)
        padded[0, :N] = prefix
        self._prefill(padded, N, 0.0, 0, 1.0, 0, 0)
        pcache = self._prefix_row = self._row
        # evict LRU until the new row fits (submit() routed away prefixes
        # that never can)
        while (self._prefix_store and self.prefix_cache_bytes
               + self._prefix_row_bytes > self._prefix_budget_bytes):
            self._prefix_store.popitem(last=False)
            self.prefix_cache_bytes -= self._prefix_row_bytes
        if (self.prefix_cache_bytes + self._prefix_row_bytes
                <= self._prefix_budget_bytes):
            self._prefix_store[key] = pcache
            self.prefix_cache_bytes += self._prefix_row_bytes
        _prefix_bytes_g.set(self.prefix_cache_bytes, model=self.name)

    def _admit_batch(self, bucket: int, members: List[tuple]) -> None:
        """One prefill for same-bucket requests, then the rows' copies
        into their slots. Rows pad to a power-of-two batch; pad rows are
        length-1 junk nothing copies. Token-identical to the row path:
        the same ragged lengths and ``(seed, 0)`` sampling."""
        k = len(members)
        t0 = self.clock()
        for req, _slot in members:
            self._note_queue_wait(req)
        bb = pow2_bucket(k, min(self.slots, self.admit_batch_max))
        prompts = np.zeros((bb, bucket), np.int32)
        lens = np.ones((bb,), np.int32)
        temps = np.zeros((bb,), np.float32)
        tks = np.zeros((bb,), np.int32)
        tps = np.ones((bb,), np.float32)
        seeds = np.zeros((bb,), np.int64)
        slot_ids = np.zeros((bb,), np.int64)
        valid = np.zeros((bb,), bool)
        for i, (req, slot) in enumerate(members):
            S = req.prompt.size
            prompts[i, :S] = req.prompt
            lens[i] = S
            temps[i] = req.temperature
            tks[i] = req.top_k
            tps[i] = req.top_p
            seeds[i] = req.seed
            slot_ids[i] = slot
            valid[i] = True
        # the shared prefill is annotated on the profiler's timeline
        # here and recorded below as a child of each member's admit span
        # (a live span would be an orphan root: the engine thread has no
        # active span)
        ann = (self.tracer.annotator("engine.prefill")
               if self.tracer.annotator is not None
               else contextlib.nullcontext())
        p0 = self.clock()
        for req, _slot in members:
            self.rledger.mark(req.rid, reqobs.PREFILL, p0)
        with ann:
            toks = self._prefill_batch(prompts, lens, temps, tks, tps,
                                       seeds)
            # the host copy finishes the prefill BEFORE any row lands in
            # the engine cache: its failure surfaces here, the cache
            # intact
            toks = toks.cpu().numpy()
        p1 = self.clock()
        try:
            self._insert_rows(slot_ids, valid)
        except Exception as e:  # noqa: BLE001 — the cache is half-written
            t_fail = self.clock()
            for req, _ in members:
                req.error = EngineClosed(
                    "engine cache invalidated during admission")
                req.out.put(_END)
                self.rledger.finish(req.rid, t_fail)
            raise _CacheInvalidated(str(e)) from e
        self.batch_prefills += 1
        t1 = self.clock()
        # every member's first token reaches its queue before any
        # member's spans and step state: the ledger stamps them all t1,
        # so the 32nd member's token must not wait on 31 members'
        # bookkeeping
        states = [self._emit_first(req, int(toks[i]), t1)
                  for i, (req, _slot) in enumerate(members)]
        for i, (req, slot) in enumerate(members):
            adm = self.tracer.record(
                "engine.admit", start=t0, end=t1, parent=req.ctx,
                attrs={"model": self.name, "slot": slot,
                       "prompt_tokens": int(lens[i]), "batched": True,
                       "batch": k})
            self.tracer.record(
                "engine.prefill", start=p0, end=p1, parent=adm,
                attrs={"prompt_tokens": int(lens[i]), "bucket": bucket,
                       "batched": True, "batch": k})
            self._arm_admitted(states[i], slot, int(toks[i]), t1)

    def _finalize_admission(self, req: _Request, slot: int, first: int,
                            t: Optional[float] = None) -> None:
        """Emit the prefill-sampled first token and arm the slot's
        host-side step state (row and batch paths alike). ``t`` is the
        caller's timestamp (the batch path stamps its members once); the
        row path reads its own."""
        t = t if t is not None else self.clock()
        self._arm_admitted(self._emit_first(req, first, t), slot, first, t)

    def _emit_first(self, req: _Request, first: int, t: float) -> _Slot:
        """Put the prefill-sampled first token on the request's queue,
        stamped ``t``; returns the slot state it starts."""
        st = _Slot(req=req, t_decode0=t)
        self._emit(st, first, t)
        return st

    def _arm_admitted(self, st: _Slot, slot: int, first: int,
                      t: float) -> None:
        """The first token's span, then the slot's host-side step state
        unless that token finished the request."""
        req = st.req
        # the TTFT span: one a request
        self.tracer.record(
            "engine.first_token", start=req.t_submit, end=t,
            parent=req.ctx,
            attrs={"model": self.name,
                   "ttft_ms": round((t - req.t_submit) * 1000.0, 3)})
        if not self._finished(st, first, t):
            with self._lock:
                self._active[slot] = st
        self._arm_host(slot, req, first, fold=1)

    def _arm_host(self, slot: int, req: _Request, token: int,
                  fold: int) -> None:
        self._tokens[slot] = token
        self._seeds[slot] = req.seed
        self._stepidx[slot] = fold
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p

    # -- paged admission and chunked prefill ---------------------------------

    def _admit_paged(self, timeout: float) -> bool:
        """Place pending requests into free slots, strict FIFO: a request
        that cannot reserve pages yet holds the line."""
        admitted = False
        with self._lock:
            busy = {i for i, s in enumerate(self._active) if s is not None}
        busy |= set(self._prefilling)
        free = [i for i in range(self.slots) if i not in busy]
        block = not busy and not self._waiting
        for slot in free:
            if not self._waiting:
                try:
                    self._waiting.append(self._pending.get(
                        block=block and not admitted, timeout=timeout))
                except queue.Empty:
                    break
            if not self._place_paged(self._waiting[0], slot):
                break
            self._waiting.popleft()
            admitted = True
        _queue_depth.set(self.pending_count, model=self.name)
        _occupancy.set(self.active_count, model=self.name)
        return admitted

    def _place_paged(self, req: _Request, slot: int) -> bool:
        """Reserve + map pages for a request and arm its slot; False when
        the pool cannot cover it yet. The COW split of a shared boundary
        page runs BEFORE the slot is armed: the shared decode step
        writes through every armed row."""
        S = req.prompt.size
        pool, store = self._pool, self._prefix_pages
        match = (store.match(req.prompt, req.prefix_len)
                 if req.prefix_len else None)
        shared = match.pages if match else []
        n_res = pool.pages_needed(S + req.max_new) - len(shared)
        protect = set(shared)
        if match is not None and match.tail_page is not None:
            protect.add(match.tail_page)
        while not pool.can_reserve(n_res) and store.evict_lru(
                protect=protect):
            pass
        if not pool.can_reserve(n_res):
            return False
        pool.reserve(slot, n_res)
        if req.prefix_len:
            if match.hit:
                self.prefix_hits += 1
                _prefix_hits.inc(model=self.name)
                n_shared = len(shared) + (match.tail_page is not None)
                self.prefix_pages_shared += n_shared
                _prefix_pages_shared_c.inc(n_shared, model=self.name)
            else:
                self.prefix_misses += 1
                _prefix_misses.inc(model=self.name)
        for logical, page in enumerate(shared):
            pool.map_shared(slot, logical, page)
        start = len(shared) * self.kv_page_size
        if match is not None and match.tail_page is not None:
            logical = len(shared)
            pool.map_cow(slot, logical, match.tail_page)
            src, dst = pool.cow_split(slot, logical)
            self._copy_page(src, dst)
            self.cow_splits += 1
            _cow_splits_c.inc(model=self.name)
            start += match.tail_len
        pool.ensure(slot, S)  # prompt pages; decode pages grow lazily
        now = self._note_queue_wait(req)
        self._arm(slot, start, pool.table_row(slot))
        self._prefilling[slot] = _PrefillJob(
            req=req, slot=slot, tokens=req.prompt, next=start,
            t_admit=now, store_prefix=req.prefix_len)
        self._pos_host[slot] = start
        self._slot_budget[slot] = S + req.max_new
        self._export_page_gauges()
        _prefix_bytes_g.set(store.pages_held * self._page_bytes,
                            model=self.name)
        return True

    def _prefill_tick(self) -> bool:
        """With decode in flight, at most ``prefill_chunks_per_cycle``
        chunks run before the next shared step; on an idle engine the
        oldest job runs to completion first."""
        if not self._prefilling:
            return False
        with self._lock:
            has_active = any(s is not None for s in self._active)
        budget = self.prefill_chunks_per_cycle if has_active else None
        for slot in list(self._prefilling):
            job = self._prefilling[slot]
            while True:
                done = self._run_chunk(job)
                if budget is not None:
                    budget -= 1
                if done:
                    del self._prefilling[slot]
                    self._finalize_paged(job)
                    break
                if budget is not None and budget <= 0:
                    return True
            if budget is None or budget <= 0:
                return True
        return True

    def _run_chunk(self, job: _PrefillJob) -> bool:
        """One chunk for one slot; True when the job's tokens are in the
        pool (``job.last_tok`` then holds the sampled next token)."""
        req = job.req
        C = self.prefill_chunk_tokens
        total = int(job.tokens.size)
        n = min(C, total - job.next)
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = job.tokens[job.next:job.next + n]
        final = job.next + n >= total
        t0 = self.clock()
        if job.chunks == 0:
            # the record's prefill phase runs from the first chunk to
            # the first token
            self.rledger.mark(req.rid, reqobs.PREFILL, t0)
        tok = self._chunk(padded, job.slot, job.next, n, (
            req.seed, job.fold0, req.temperature, req.top_k, req.top_p)
            if final else None)
        if final:
            job.last_tok = int(tok[0])
        job.next += n
        job.chunks += 1
        self.prefill_chunks += 1
        _prefill_chunks_c.inc(model=self.name)
        self.rledger.note_chunk(req.rid)
        self.tracer.record(
            "engine.prefill_chunk", start=t0, end=self.clock(),
            parent=req.ctx,
            attrs={"model": self.name, "slot": job.slot,
                   "tokens": int(n), "final": final})
        return final

    def _finalize_paged(self, job: _PrefillJob) -> None:
        """Prompt fully in the pool: emit the sampled token, arm the
        slot's host-side decode state, pin shareable prefix pages."""
        req, slot = job.req, job.slot
        now = self.clock()
        if job.store_prefix:
            self._prefix_pages.store(req.prompt, job.store_prefix, slot)
            _prefix_bytes_g.set(
                self._prefix_pages.pages_held * self._page_bytes,
                model=self.name)
        self.tracer.record(
            "engine.admit", start=job.t_admit, end=now, parent=req.ctx,
            attrs={"model": self.name, "slot": slot,
                   "prompt_tokens": int(req.prompt.size),
                   "chunked": True, "chunks": job.chunks})
        st = _Slot(req=req, produced=job.produced0, t_decode0=now,
                   emitted=[int(t) for t in job.tokens[req.prompt.size:]])
        if job.produced0 == 0:
            # a recovery replay's first token reached its client long ago
            self.tracer.record(
                "engine.first_token", start=req.t_submit, end=now,
                parent=req.ctx,
                attrs={"model": self.name,
                       "ttft_ms": round((now - req.t_submit) * 1000.0, 3)})
        self._emit(st, job.last_tok, now)
        self._arm_host(slot, req, job.last_tok, fold=job.fold0 + 1)
        self._pos_host[slot] = job.tokens.size
        if self._finished(st, job.last_tok, now):
            self._retire_paged(slot)
        else:
            with self._lock:
                self._active[slot] = st

    def _ensure_pages(self, slots) -> None:
        """Map pages covering the next K decode writes of each active
        slot, re-arming rows whose tables changed."""
        K = self.steps_per_sync
        Smax = self.config.max_seq_len
        for i in slots:
            need = min(int(self._pos_host[i]) + K,
                       int(self._slot_budget[i]), Smax)
            if self._pool.ensure(i, need):
                # page growth stalls this stream's decode: clock reads on
                # growth only, never on the per-token emit path
                t0 = self.clock()
                self._arm(i, int(self._pos_host[i]),
                          self._pool.table_row(i))
                self._export_page_gauges()
                with self._lock:
                    st = self._active[i]
                if st is not None:
                    self.rledger.stall(st.req.rid, reqobs.KV_FAULT, t0,
                                       self.clock())

    def _export_page_gauges(self) -> None:
        _kv_pages_g.set(self._pool.pages_in_use, model=self.name)
        _kv_pages_free_g.set(self._pool.pages_free, model=self.name)
        _kv_pages_evictable_g.set(self._prefix_pages.pages_evictable,
                                  model=self.name)

    def _retire_paged(self, slot: int) -> None:
        """Free the slot's pages and disarm its row, so later idle-row
        writes drop instead of landing in reallocated pages."""
        self._pool.release_slot(slot)
        self._arm(slot, self.config.max_seq_len,
                  self._pool.table_row(slot))
        self._pos_host[slot] = 0
        self._slot_budget[slot] = 0
        self._export_page_gauges()

    # -- cache recovery ----------------------------------------------------

    def _maybe_recover(self, where: str) -> bool:
        """A device call failed mid-way and may have half-written the
        cache. While the budget lasts, rebuild it from zeros and replay
        every in-flight stream; False once the budget is spent or the
        rebuild itself fails."""
        if self._recoveries_left <= 0:
            return False
        self._recoveries_left -= 1
        try:
            self._rebuild_and_replay()
        except Exception:  # noqa: BLE001 — recovery itself failed
            log.exception("cache recovery after %s failure failed; "
                          "closing engine", where)
            return False
        self.recoveries += 1
        log.warning("recovered engine cache after %s failure (%d "
                    "recover(s) left)", where, self._recoveries_left)
        return True

    def _rebuild_and_replay(self) -> None:
        with self._lock:
            live = [(i, s) for i, s in enumerate(self._active)
                    if s is not None]
            self._active = [None] * self.slots
        # a new cache: the failed call may have half-written the old one
        self._fresh_cache()
        replays = [(i, st.req,
                    np.concatenate([st.req.prompt,
                                    np.asarray(st.emitted, np.int32)]),
                    st.produced, int(self._stepidx[i])) for i, st in live]
        if not self.paged:
            for args in replays:
                self._replay_dense(*args)
            return
        # the old pool mapped the old cache and its prefix pages died
        # with it; interrupted prefill jobs restart from token 0
        jobs = list(self._prefilling.values())
        self._prefilling = collections.OrderedDict()
        self._pool = PagePool(self.kv_pages, self.kv_page_size, self.slots,
                              self._n_logical)
        self._prefix_pages = PrefixPageStore(
            self._pool, self._prefix_pages.budget_pages)
        self._pos_host[:] = 0
        self._slot_budget[:] = 0
        self._export_page_gauges()
        for args in replays + [(j.slot, j.req, j.tokens, j.produced0,
                                j.fold0) for j in jobs]:
            try:
                self._replay_paged(*args)
            except OutOfPages:
                # replays reserve without prefix sharing: a load that only
                # fit shared fails just the streams that no longer fit
                log.warning("slot %d replay does not fit the rebuilt pool; "
                            "failing it retryably", args[0])
                args[1].error = EngineClosed(
                    "engine cache recovered; stream evicted — retry")
                args[1].out.put(_END)
                self.rledger.finish(args[1].rid, self.clock())

    def _replay_paged(self, slot: int, req: _Request, tokens: np.ndarray,
                      produced: int, fold: int) -> None:
        pool = self._pool
        budget = req.prompt.size + req.max_new
        pool.reserve(slot, pool.pages_needed(budget))
        pool.ensure(slot, int(tokens.size))
        self._arm(slot, 0, pool.table_row(slot))
        self._prefilling[slot] = _PrefillJob(
            req=req, slot=slot, tokens=tokens, next=0,
            t_admit=self.clock(), fold0=fold, produced0=produced)
        self._pos_host[slot] = 0
        self._slot_budget[slot] = budget
        self._export_page_gauges()

    def _replay_dense(self, slot: int, req: _Request, tokens: np.ndarray,
                      produced: int, fold: int) -> None:
        """One bucketed prefill of (prompt + emitted) refills the row and
        samples the stream's next token at the preserved step index."""
        L = int(tokens.size)
        padded = np.zeros((1, pow2_bucket(L, self.config.max_seq_len)),
                          np.int32)
        padded[0, :L] = tokens
        tok = self._prefill(padded, L, req.temperature, req.top_k,
                            req.top_p, req.seed, fold)
        self._insert(slot)
        tok = int(tok[0])
        t_now = self.clock()
        st = _Slot(req=req, produced=produced, t_decode0=t_now,
                   emitted=[int(t) for t in tokens[req.prompt.size:]])
        self._emit(st, tok, t_now)
        self._arm_host(slot, req, tok, fold=fold + 1)
        if not self._finished(st, tok, t_now):
            with self._lock:
                self._active[slot] = st

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                # the recovery budget is spent (or a burst's copies
                # half-wrote the cache): close the engine; every request
                # fails retryably and the repository builds a fresh
                # engine on the next request
                log.exception("decode engine step failed; closing engine")
                self._stop.set()
                self._fail_all(EngineClosed("decode engine step failed"))
                return
