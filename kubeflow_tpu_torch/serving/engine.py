"""Continuous-batching decode engine over the paged KV cache.

PyTorch port of ``kubeflow_tpu/serving/engine.py`` (its paged mode): one
engine per loaded LM version; concurrent generate requests share ONE
decode step over ``slots`` rows, forever.

- **admission** is page-map surgery: reserve the request's worst case
  in the page pool (``serving/kvpool.py``), map shared prefix pages
  (copy-on-write split of a partial boundary page), arm the slot's row;
  requests that cannot reserve yet hold the strict-FIFO head of line;
- **chunked prefill** feeds the prompt into the pool one fixed-width
  chunk per scheduler cycle, interleaved with co-tenant decode steps,
  so a long admission never stalls decode for more than one chunk;
- **step**: every slot advances ``steps_per_sync`` tokens per host
  round-trip; an all-greedy batch takes the argmax step and skips the
  sampler; otherwise rows sample through the configured sampler with
  Gumbel noise keyed on ``(seed, step)`` alone, so a request's tokens
  never depend on its co-tenants;
- **retirement** frees the slot's pages and disarms its row.

Left for later slices (ROADMAP.md): the dense cache, burst batch
prefill, the dense prefix LRU, cache recovery, mesh/TP serving, tracing
spans and the request ledger.

Environment switches (as in the reference): ``KFTPU_PAGED`` (the port
defaults it to 1 — the dense mode is not ported, and 0 raises),
``KFTPU_PAGED_ATTN``, ``KFTPU_SAMPLER_IMPL``, ``KFTPU_SAMPLER_BOUND``,
``KFTPU_KV_PAGE_SIZE``, ``KFTPU_KV_PAGES``, ``KFTPU_PREFILL_CHUNK``.
"""

from __future__ import annotations

import collections
import dataclasses
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
    prefill_chunk,
    sample_logits,
)
from kubeflow_tpu_torch.models.transformer import Transformer
from kubeflow_tpu_torch.ops.sampling import fused_sample, gumbel_noise
from kubeflow_tpu_torch.serving.kvpool import PagePool, PrefixPageStore
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


@dataclasses.dataclass
class _Request:
    prompt: np.ndarray           # (S,) int32, true length
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    eos_id: Optional[int]
    prefix_len: int = 0          # leading prompt tokens to share as pages
    t_submit: float = 0.0
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


@dataclasses.dataclass
class _PrefillJob:
    """A slot mid-chunked-prefill."""

    req: _Request
    slot: int
    next: int                 # next prompt position to feed
    chunks: int = 0
    last_tok: int = 0         # sampled next token, set by the final chunk


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw else default


class DecodeEngine:
    """One engine per loaded transformer model version.

    ``params`` is a port :class:`Transformer` already on ``device``, or a
    JAX-layout param tree (nested or flat numpy; ``models/convert.py``).
    ``submit()`` is thread-safe and returns a handle whose ``stream()``
    yields tokens as steps complete; ``close()`` drains the engine.
    """

    def __init__(self, config, params, *, slots: int = 8,
                 steps_per_sync: int = 1,
                 prefix_cache_entries: int = 4,
                 prefix_cache_bytes: Optional[int] = None,
                 sampler_bound: Optional[int] = None,
                 sampler_impl: Optional[str] = None,
                 paged: Optional[bool] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 paged_attention_impl: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefill_chunks_per_cycle: int = 1,
                 autostart: bool = True, name: str = "",
                 clock: Optional[Clock] = None,
                 device=None) -> None:
        self.device = resolve_device(device)
        if paged is None:
            paged = os.environ.get("KFTPU_PAGED", "1") not in ("0", "")
        if not paged:
            raise NotImplementedError(
                "the dense decode engine is not ported to "
                "kubeflow_tpu_torch yet (ROADMAP.md Queue A); use paged")
        self.paged = True
        self.config = config
        self.slots = slots
        self.clock: Clock = clock if clock is not None else time.monotonic
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
        # paged geometry: page size = largest power-of-two divisor of
        # max_seq_len up to 64; the pool defaults to full provisioning
        Smax = config.max_seq_len
        if kv_page_size is None:
            kv_page_size = _env_int("KFTPU_KV_PAGE_SIZE", 0)
        if not kv_page_size:
            kv_page_size = 1
            while kv_page_size < 64 and Smax % (kv_page_size * 2) == 0:
                kv_page_size *= 2
        self.kv_page_size = int(kv_page_size)
        self._n_logical = Smax // self.kv_page_size
        if kv_pages is None:
            kv_pages = _env_int("KFTPU_KV_PAGES", slots * self._n_logical)
        self.kv_pages = int(kv_pages)
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = _env_int("KFTPU_PREFILL_CHUNK",
                                            min(256, Smax))
        self.prefill_chunk_tokens = max(1, int(prefill_chunk_tokens))
        self.prefill_chunks_per_cycle = max(1, int(prefill_chunks_per_cycle))
        if paged_attention_impl is None:
            paged_attention_impl = os.environ.get("KFTPU_PAGED_ATTN", "auto")
        self.paged_attention_impl = paged_attention_impl
        self._cfg = dataclasses.replace(
            config, kv_page_size=self.kv_page_size, kv_pages=self.kv_pages,
            paged_attention_impl=paged_attention_impl)
        self._cfg.validate()
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.name = name or "model"
        _slots_g.set(self.slots, model=self.name)

        if isinstance(params, Transformer):
            self._model = params
        else:
            self._model = convert.to_module(config, params,
                                            device=self.device)
        self._cache = init_cache(self._cfg, slots, device=self.device)
        # test hooks, as in the reference: device-side page surgery
        self._arm = arm_slot
        self._copy_page = copy_page

        itemsize = torch.finfo(self._cfg.dtype).bits // 8
        self._page_bytes = (2 * config.n_layers * self.kv_page_size
                            * config.n_kv_heads * config.head_dim * itemsize)
        self._prefix_row_bytes = self._page_bytes * self._n_logical
        if prefix_cache_bytes is None:
            env = os.environ.get("KFTPU_PREFIX_CACHE_BYTES")
            prefix_cache_bytes = (int(env) if env else
                                  max(0, int(prefix_cache_entries))
                                  * self._prefix_row_bytes)
        self._prefix_budget_bytes = max(0, int(prefix_cache_bytes))
        _prefix_budget_g.set(self._prefix_budget_bytes, model=self.name)

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
        self.prefill_chunks = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_pages_shared = 0
        self.cow_splits = 0
        self._pool = PagePool(self.kv_pages, self.kv_page_size, slots,
                              self._n_logical)
        self._prefix_pages = PrefixPageStore(
            self._pool, self._prefix_budget_bytes // max(1, self._page_bytes))
        self._prefilling: "collections.OrderedDict[int, _PrefillJob]" = \
            collections.OrderedDict()
        self._waiting: "collections.deque[_Request]" = collections.deque()
        # host-authoritative per-slot position (device values drift for
        # idle and mid-prefill rows by design)
        self._pos_host = np.zeros((slots,), np.int64)
        self._slot_budget = np.zeros((slots,), np.int64)
        if autostart:
            self.start()

    # -- sampling ----------------------------------------------------------

    def _sample_rows(self, logits, seeds, folds, temps, tks, tps):
        """Per-row sampling under the ``(seed, step)`` contract; (B, V)
        logits in, (B,) int32 tokens out. Noise is drawn only for rows
        that sample (greedy rows never read it)."""
        B, V = logits.shape
        dev = logits.device
        noise = torch.zeros((B, V), dtype=torch.float32, device=dev)
        rows = [i for i in range(B) if temps[i] > 0.0]
        if rows:
            noise[rows] = gumbel_noise([seeds[i] for i in rows],
                                       [folds[i] for i in rows], V,
                                       device=dev)
        temp_t = torch.as_tensor(temps, dtype=torch.float32, device=dev)
        tk_t = torch.as_tensor(tks, dtype=torch.int32, device=dev)
        tp_t = torch.as_tensor(tps, dtype=torch.float32, device=dev)
        if self.sampler_impl == "fused":
            return fused_sample(logits.float().contiguous(), noise, temp_t,
                                tk_t, tp_t)
        bound = (self.sampler_bound if self.sampler_impl == "bounded"
                 and self.sampler_bound > 0 else None)
        return sample_logits(logits, noise, temperature=temp_t, top_k=tk_t,
                             top_p=tp_t, bound=bound)

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
        need = self._pool.pages_needed(prompt.size + max_new)
        if need > self._pool.pages_total:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new} needs {need} KV "
                f"pages but the pool holds only {self._pool.pages_total} — "
                f"raise kv_pages or shrink the request")
        prefix_len = int(prefix_len)
        if prefix_len and not 0 < prefix_len < prompt.size:
            raise ValueError(
                f"prefix_len {prefix_len} must be in (0, prompt length "
                f"{prompt.size}) — the suffix may not be empty")
        req = _Request(prompt=prompt, max_new=max_new,
                       temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), seed=int(seed), eos_id=eos_id,
                       prefix_len=prefix_len, t_submit=self.clock())
        with self._lock:
            if self._stop.is_set():
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
        for req in failed:
            req.error = error
            req.out.put(_END)

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
        """Occupancy snapshot (same keys as the reference's paged engine)."""
        return {"active_slots": self.active_count,
                "pending": self.pending_count,
                "slots": self.slots,
                "closed": self.closed,
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
                "cow_splits": self.cow_splits}

    # -- the scheduler cycle -------------------------------------------------

    def _emit(self, slot: _Slot, token: int) -> None:
        slot.produced += 1
        self.tokens_total += 1
        _tokens_total.inc(model=self.name)
        slot.req.out.put(token)

    def _finished(self, slot: _Slot, token: int) -> bool:
        done = (slot.produced >= slot.req.max_new or
                (slot.req.eos_id is not None and token == slot.req.eos_id))
        if done:
            slot.req.out.put(_END)
        return done

    @torch.no_grad()
    def run_once(self, timeout: float = 0.1) -> bool:
        """One admit + prefill-chunk + step cycle; True if work happened.
        The background loop calls this forever; tests call it directly
        (``autostart=False``) for deterministic schedules."""
        worked = self._admit_paged(timeout)
        worked = self._prefill_tick() or worked
        with self._lock:
            active = [(i, s) for i, s in enumerate(self._active)
                      if s is not None]
        if not active:
            return worked
        # greedy rows ignore seeds and filters, so an all-greedy batch
        # takes the argmax step, bit-identical, without the sampler
        all_greedy = all(s.req.temperature <= 0.0 for _, s in active)
        self._ensure_pages(i for i, _ in active)
        K = self.steps_per_sync
        tokens = torch.as_tensor(self._tokens, device=self.device)
        outs = []
        for t in range(K):
            logits, _ = decode_step(self._model, self._cache, tokens)
            if all_greedy:
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                tokens = self._sample_rows(
                    logits, self._seeds, self._stepidx + t, self._temps,
                    self._topk, self._topp)
            outs.append(tokens)
        toks = torch.stack(outs).cpu().numpy()  # (K, B): one host sync
        self.steps_total += K
        if all_greedy:
            self.greedy_steps += K
        _steps_total.inc(K, model=self.name)
        self._stepidx += K
        self._tokens = toks[-1].copy()
        self._pos_host[[i for i, _ in active]] += K
        retired: List[int] = []
        for i, slot in active:
            for t in range(K):
                tok = int(toks[t, i])
                self._emit(slot, tok)
                if self._finished(slot, tok):
                    with self._lock:
                        self._active[i] = None
                    retired.append(i)
                    break
        for i in retired:
            self._retire_paged(i)
        _occupancy.set(self.active_count, model=self.name)
        return True

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
            self._copy_page(self._cache, src, dst)
            self.cow_splits += 1
            _cow_splits_c.inc(model=self.name)
            start += match.tail_len
        pool.ensure(slot, S)  # prompt pages; decode pages grow lazily
        _queue_wait_h.observe(max(0.0, self.clock() - req.t_submit),
                              model=self.name)
        self._arm(self._cache, slot, start, pool.table_row(slot))
        self._prefilling[slot] = _PrefillJob(req=req, slot=slot, next=start)
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
        """One chunk for one slot; True when the prompt is in the pool
        (``job.last_tok`` then holds the sampled next token)."""
        req = job.req
        C = self.prefill_chunk_tokens
        total = int(req.prompt.size)
        n = min(C, total - job.next)
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = req.prompt[job.next:job.next + n]
        final = job.next + n >= total
        logits, _ = prefill_chunk(
            self._model, self._cache,
            torch.as_tensor(padded, device=self.device), job.slot,
            job.next, n)
        if final:
            job.last_tok = int(self._sample_rows(
                logits, [req.seed], [0], [req.temperature], [req.top_k],
                [req.top_p])[0])
        job.next += n
        job.chunks += 1
        self.prefill_chunks += 1
        _prefill_chunks_c.inc(model=self.name)
        return final

    def _finalize_paged(self, job: _PrefillJob) -> None:
        """Prompt fully in the pool: emit the sampled token, arm the
        slot's host-side decode state, pin shareable prefix pages."""
        req, slot = job.req, job.slot
        if req.prefix_len:
            self._prefix_pages.store(req.prompt, req.prefix_len, slot)
            _prefix_bytes_g.set(
                self._prefix_pages.pages_held * self._page_bytes,
                model=self.name)
        st = _Slot(req=req)
        self._emit(st, job.last_tok)
        self._tokens[slot] = job.last_tok
        self._seeds[slot] = req.seed
        self._stepidx[slot] = 1
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._pos_host[slot] = req.prompt.size
        if self._finished(st, job.last_tok):
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
                self._arm(self._cache, i, int(self._pos_host[i]),
                          self._pool.table_row(i))
                self._export_page_gauges()

    def _export_page_gauges(self) -> None:
        _kv_pages_g.set(self._pool.pages_in_use, model=self.name)
        _kv_pages_free_g.set(self._pool.pages_free, model=self.name)
        _kv_pages_evictable_g.set(self._prefix_pages.pages_evictable,
                                  model=self.name)

    def _retire_paged(self, slot: int) -> None:
        """Free the slot's pages and disarm its row, so later idle-row
        writes drop instead of landing in reallocated pages."""
        self._pool.release_slot(slot)
        self._arm(self._cache, slot, self.config.max_seq_len,
                  self._pool.table_row(slot))
        self._pos_host[slot] = 0
        self._slot_budget[slot] = 0
        self._export_page_gauges()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                # no cache recovery in this slice: a failed step closes
                # the engine, every request fails retryably, and the
                # repository builds a fresh engine on the next request
                log.exception("decode engine step failed; closing engine")
                self._stop.set()
                self._fail_all(EngineClosed("decode engine step failed"))
                return
