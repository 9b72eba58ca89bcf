"""Host-side page allocator for the paged decode KV cache.

A verbatim copy of ``kubeflow_tpu/serving/kvpool.py`` (numpy only): the
port imports nothing of the JAX package, so it carries its own.

The device side is a pool of ``pages_total`` HBM blocks of
``page_size`` tokens (``models/transformer.py:_paged_decode_attend``);
everything about WHO owns a page lives here, on the host, as plain
integers — slot admission/retirement is page-map surgery on a table
the engine ships to the device as one tiny int32 array, never a
whole-row KV copy.

Ownership model:

- every physical page has a refcount; 0 = free (on the free list);
- a slot's page-table row maps logical pages (position // page_size)
  to physical ids, ``SENTINEL`` (== pages_total) for unmapped entries
  — the model drops writes through the sentinel;
- prefix sharing is refcounting: a stored prompt prefix pins its pages
  (one ref for the store), and every slot serving that prefix adds a
  ref to each shared page. **Exactly one slot may ever write a page**
  (its allocator-recorded *writer*): pages a slot allocates are its
  own; pages mapped via :meth:`map_shared` or :meth:`map_cow` are
  read-only for the mapper. Shared full prefix pages sit below every
  sharer's start position, so the read-only rule costs nothing; a
  shared PARTIAL boundary page (copy-on-write, :meth:`map_cow`) must
  be :meth:`cow_split` into a fresh writable copy before the sharer's
  first write can land in it;
- admission RESERVES the slot's worst case up front
  (``ceil((prompt + max_new)/page_size)`` minus fully-shared pages —
  a COW boundary page is NOT subtracted, its split draws a fresh page)
  and allocation draws the reservation down as the sequence actually
  grows — ``pages_in_use`` tracks live tokens, while the reservation
  guarantees a slot admitted can always finish (no mid-decode
  out-of-pages deadlock to preempt around).

Deterministic by design: the free list hands out ascending ids from a
fixed initial order, so tests can assert exact page maps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    """An allocation exceeded the slot's reservation or the pool —
    an engine accounting bug, never a load condition (admission gates
    on :meth:`PagePool.can_reserve`)."""


@dataclasses.dataclass
class _SlotState:
    reserved: int = 0        # pages promised but not yet allocated
    mapped: List[int] = dataclasses.field(default_factory=list)
    owned: List[int] = dataclasses.field(default_factory=list)
    # logical page -> shared physical page the slot maps read-only and
    # must cow_split before writing
    cow: Dict[int, int] = dataclasses.field(default_factory=dict)


class PagePool:
    """Refcounted page allocator + per-slot page tables."""

    def __init__(self, pages_total: int, page_size: int, slots: int,
                 pages_per_slot: int) -> None:
        if pages_total < 1:
            raise ValueError("pages_total must be >= 1")
        self.pages_total = int(pages_total)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.pages_per_slot = int(pages_per_slot)
        self.sentinel = self.pages_total
        # pop() hands out ascending ids: 0, 1, 2, ...
        self._free: List[int] = list(range(self.pages_total - 1, -1, -1))
        self.ref = np.zeros((self.pages_total,), np.int32)
        # store-side pins (PrefixPageStore), counted separately so the
        # invariant ref == table references + pins is checkable
        self.pins = np.zeros((self.pages_total,), np.int32)
        self.tables = np.full((self.slots, self.pages_per_slot),
                              self.sentinel, np.int32)
        self._slot = [_SlotState() for _ in range(self.slots)]
        # page -> the ONE slot allowed to write it (docstring invariant)
        self._writer: Dict[int, int] = {}
        self.reserved_total = 0
        self.cow_splits = 0

    # -- capacity ----------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.pages_total - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-max(0, int(tokens)) // self.page_size)

    def can_reserve(self, n: int) -> bool:
        """True when ``n`` more pages can be promised without risking a
        mid-decode allocation failure for any already-admitted slot."""
        return len(self._free) - self.reserved_total >= n

    # -- slot lifecycle ----------------------------------------------------

    def reserve(self, slot: int, n: int) -> None:
        if not self.can_reserve(n):
            raise OutOfPages(
                f"reserve({n}) with {len(self._free)} free / "
                f"{self.reserved_total} already promised")
        self._slot[slot].reserved += n
        self.reserved_total += n

    def map_shared(self, slot: int, logical: int, page_id: int) -> None:
        """Point a slot's logical page at an existing (prefix) page —
        read-only for this slot (it is below the slot's start)."""
        assert self.tables[slot, logical] == self.sentinel
        self.ref[page_id] += 1
        self.tables[slot, logical] = page_id
        self._slot[slot].mapped.append(page_id)

    def map_cow(self, slot: int, logical: int, page_id: int) -> None:
        """Share a PARTIAL boundary page copy-on-write: the slot maps it
        read-only (taking a ref that outlives any store eviction racing
        the placement) and must :meth:`cow_split` before its first
        write into the page can land."""
        self.map_shared(slot, logical, page_id)
        self._slot[slot].cow[logical] = page_id

    def cow_split(self, slot: int, logical: int) -> Tuple[int, int]:
        """Split a COW mapping: allocate a fresh writable page for the
        slot (drawing its reservation down) and drop the read-only ref
        on the shared one. Returns ``(src, dst)`` — the caller must
        copy the page device-side BEFORE any write lands in ``dst``
        (the split itself moves no KV bytes)."""
        st = self._slot[slot]
        src = st.cow.pop(logical)
        assert self.tables[slot, logical] == src, "cow map out of sync"
        self.tables[slot, logical] = self.sentinel
        dst = self.alloc(slot, logical)
        st.mapped.remove(src)
        self._unref(src)
        self.cow_splits += 1
        return src, dst

    def alloc(self, slot: int, logical: int) -> int:
        """Allocate a fresh writable page for a slot's logical page,
        drawing down its reservation."""
        st = self._slot[slot]
        if st.reserved <= 0:
            raise OutOfPages(f"slot {slot} exhausted its reservation")
        if not self._free:
            raise OutOfPages("free list empty despite reservation")
        page = self._free.pop()
        assert page not in self._writer, (
            f"free page {page} still has writer {self._writer[page]}")
        st.reserved -= 1
        self.reserved_total -= 1
        self.ref[page] = 1
        self.tables[slot, logical] = page
        st.mapped.append(page)
        st.owned.append(page)
        self._writer[page] = slot
        return page

    def ensure(self, slot: int, tokens: int) -> bool:
        """Map every logical page covering positions [0, tokens);
        returns True when the table row changed (the engine must re-arm
        the device copy)."""
        changed = False
        for logical in range(self.pages_needed(tokens)):
            if self.tables[slot, logical] == self.sentinel:
                self.alloc(slot, logical)
                changed = True
        return changed

    def release_slot(self, slot: int) -> None:
        """Retire a slot: unref every mapped page (pages reaching 0 go
        back on the free list) and return its unused reservation."""
        st = self._slot[slot]
        for page in st.owned:
            # the page may outlive the slot (store pin / other sharers)
            # but nobody writes it anymore
            self._writer.pop(page, None)
        for page in st.mapped:
            self._unref(page)
        st.mapped = []
        st.owned = []
        st.cow.clear()
        self.reserved_total -= st.reserved
        st.reserved = 0
        self.tables[slot, :] = self.sentinel

    def table_row(self, slot: int) -> np.ndarray:
        return self.tables[slot].copy()

    # -- prefix sharing ----------------------------------------------------

    def pin_one(self, slot: int, logical: int) -> int:
        """Take a store-side reference on ONE of a slot's mapped pages
        — the prefix store's claim, which outlives the slot."""
        page = int(self.tables[slot, logical])
        assert page != self.sentinel
        self.ref[page] += 1
        self.pins[page] += 1
        return page

    def unpin(self, pages: List[int]) -> None:
        for p in pages:
            assert self.pins[p] > 0, f"unpin of never-pinned page {p}"
            self.pins[p] -= 1
            self._unref(p)

    def _unref(self, page: int) -> None:
        assert self.ref[page] > 0, f"double free of page {page}"
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self._writer.pop(page, None)
            self._free.append(page)

    def writer_of(self, page: int) -> Optional[int]:
        """The one slot allowed to write ``page`` (None = read-only
        everywhere: freed, store-only, or every mapper is a sharer)."""
        return self._writer.get(page)

    def check_invariants(self) -> None:
        """Assert the full ownership model (property-test hook):

        - every non-sentinel table entry references a live page;
        - ``ref`` == table references + store pins, per page;
        - free-list pages have ref 0 and no writer;
        - at most ONE slot may write any page, and that slot actually
          maps it — every other mapper is read-only (their mapping came
          from map_shared/map_cow, i.e. is not in their ``owned``).
        """
        table_refs = np.zeros_like(self.ref)
        for s in range(self.slots):
            for page in self.tables[s]:
                if page != self.sentinel:
                    assert self.ref[page] > 0, (
                        f"slot {s} maps dead page {page}")
                    table_refs[page] += 1
        if not (self.ref == table_refs + self.pins).all():
            bad = np.flatnonzero(self.ref != table_refs + self.pins)
            raise AssertionError(
                f"refcount drift on pages {bad.tolist()}: ref "
                f"{self.ref[bad].tolist()} != table {table_refs[bad].tolist()}"
                f" + pins {self.pins[bad].tolist()}")
        for page in self._free:
            assert self.ref[page] == 0 and page not in self._writer
        owners: Dict[int, Set[int]] = {}
        for s, st in enumerate(self._slot):
            for page in st.owned:
                owners.setdefault(page, set()).add(s)
        for page, slots in owners.items():
            assert len(slots) == 1, (
                f"page {page} writable by slots {sorted(slots)}")
            (s,) = slots
            assert self._writer.get(page) == s
            assert page in self.tables[s], (
                f"writer slot {s} no longer maps page {page}")
        for page, s in self._writer.items():
            assert page in self._slot[s].owned

    def check_idle(self) -> None:
        """Assert the pool is fully reclaimed (smoke-gate invariant)."""
        if self.pages_in_use or self.reserved_total:
            raise AssertionError(
                f"pool not idle: {self.pages_in_use} pages in use, "
                f"{self.reserved_total} reserved; refs "
                f"{np.flatnonzero(self.ref).tolist()}")
        assert not self._writer and not self.pins.any()


@dataclasses.dataclass
class PrefixMatch:
    """A prefix-trie lookup result: the longest stored chain of full
    pages matching the request's page-aligned prefix, plus (when the
    WHOLE aligned prefix matched) an optional copy-on-write candidate
    for the partial boundary page."""

    pages: List[int]                 # full pages, logical order
    tail_page: Optional[int] = None  # boundary page to map COW
    tail_len: int = 0                # boundary tokens it carries

    @property
    def hit(self) -> bool:
        return bool(self.pages) or self.tail_page is not None


class _TrieNode:
    __slots__ = ("page", "children", "tails", "parent", "key", "tick")

    def __init__(self, page: Optional[int], parent: "Optional[_TrieNode]",
                 key: bytes, tick: int) -> None:
        self.page = page             # None only for the root
        self.children: Dict[bytes, _TrieNode] = {}
        self.tails: Dict[bytes, _Tail] = {}
        self.parent = parent
        self.key = key
        self.tick = tick


class _Tail:
    __slots__ = ("page", "node", "key", "tick")

    def __init__(self, page: int, node: _TrieNode, key: bytes,
                 tick: int) -> None:
        self.page = page
        self.node = node
        self.key = key
        self.tick = tick


class PrefixPageStore:
    """Page-granular prefix **trie**, budgeted in PAGES.

    Each node is ONE full page of prompt tokens, keyed by its token
    content and chained under its predecessor page — the per-page
    content-hash chain (python's bytes hashing; keys compare exact, so
    a hash collision can never alias two different pages). A lookup
    walks the request's prefix page by page and shares the LONGEST
    stored chain: any page-aligned common prefix hits, not just exact
    full-prefix matches (the pre-trie store keyed on the entire aligned
    prefix, so two prompts sharing their first page but not their
    second shared nothing).

    Boundary pages: the page straddling the prefix/suffix boundary
    holds ``prefix_len % page_size`` shareable tokens plus per-request
    suffix garbage. It hangs off the last full-page node as a *tail*
    keyed by the boundary tokens, and is shared **copy-on-write**
    (`PagePool.map_cow`): the sharer maps it read-only, and the engine
    splits it into a fresh writable copy before the sharer's first
    write — one device-side page copy instead of re-prefilling up to
    ``page_size − 1`` tokens through every model layer.

    Entries hold store-side refs on their pages (``PagePool.pin_one``);
    eviction (leaf-first LRU — an interior page is only evictable once
    nothing chains below it) unpins, and pages free once the last
    sharing slot retires.
    """

    def __init__(self, pool: PagePool, budget_pages: int) -> None:
        self.pool = pool
        self.budget_pages = max(0, int(budget_pages))
        self._root = _TrieNode(None, None, b"", 0)
        self._tick = 0
        # flat view of held page ids for cross-thread reads
        # (pages_evictable runs on the autoscaler's snapshot() poll
        # thread; ``list()`` of a list is a GIL-atomic copy)
        self._held: List[int] = []

    @property
    def pages_held(self) -> int:
        return len(self._held)

    @property
    def pages_evictable(self) -> int:
        """Store-held pages no live slot shares (refcount 1 = only the
        store's pin): reclaimable cache, not load — the autoscaler must
        not hold replicas for them. One vectorized probe over the held
        ids: this also runs from the engine's per-admit/retire gauge
        export now, not just the autoscaler's snapshot() poll, so a
        Python-loop scan of a thousand-page trie would tax the decode
        host thread."""
        held = list(self._held)  # GIL-atomic copy (cross-thread read)
        if not held:
            return 0
        return int((self.pool.ref[np.asarray(held)] == 1).sum())

    def aligned_len(self, prefix_len: int) -> int:
        return (int(prefix_len) // self.pool.page_size
                ) * self.pool.page_size

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: np.ndarray, prefix_len: int) -> PrefixMatch:
        """Longest stored page chain for ``tokens[:prefix_len]``
        (LRU-touches the path). Hit/miss accounting is the caller's:
        placement can retry the same request several cycles while pages
        free up, and only the admission that LANDS should count."""
        ps = self.pool.page_size
        prefix_len = min(int(prefix_len), int(tokens.size))
        aligned = self.aligned_len(prefix_len)
        self._tick += 1
        node = self._root
        pages: List[int] = []
        for i in range(aligned // ps):
            child = node.children.get(tokens[i * ps:(i + 1) * ps]
                                      .tobytes())
            if child is None:
                break
            child.tick = self._tick
            pages.append(child.page)
            node = child
        tail_len = prefix_len - aligned
        if tail_len and len(pages) == aligned // ps:
            tail = node.tails.get(tokens[aligned:prefix_len].tobytes())
            if tail is not None:
                tail.tick = self._tick
                return PrefixMatch(pages, tail.page, tail_len)
        return PrefixMatch(pages)

    # -- insertion ---------------------------------------------------------

    def store(self, tokens: np.ndarray, prefix_len: int,
              slot: int) -> None:
        """Pin a slot's prefix pages into the trie (idempotent: pages
        whose content chain is already stored are only LRU-touched —
        on a full hit the slot's pages ARE the stored ones). The chain
        truncates at the page budget; a partial boundary page registers
        as a COW tail on the last full node."""
        if self.budget_pages <= 0:
            return
        ps = self.pool.page_size
        prefix_len = min(int(prefix_len), int(tokens.size))
        aligned = self.aligned_len(prefix_len)
        self._tick += 1
        node = self._root
        path_pages: Set[int] = set()
        for i in range(aligned // ps):
            key = tokens[i * ps:(i + 1) * ps].tobytes()
            child = node.children.get(key)
            if child is None:
                if not self._make_room(path_pages):
                    return
                child = _TrieNode(self.pool.pin_one(slot, i), node, key,
                                  self._tick)
                node.children[key] = child
                self._held.append(child.page)
            child.tick = self._tick
            path_pages.add(child.page)
            node = child
        tail_len = prefix_len - aligned
        if not tail_len:
            return
        key = tokens[aligned:prefix_len].tobytes()
        if key in node.tails:
            node.tails[key].tick = self._tick
            return
        if not self._make_room(path_pages):
            return
        tail = _Tail(self.pool.pin_one(slot, aligned // ps), node, key,
                     self._tick)
        node.tails[key] = tail
        self._held.append(tail.page)

    def _make_room(self, protect: Set[int]) -> bool:
        while self.pages_held + 1 > self.budget_pages:
            if not self.evict_lru(protect=protect):
                return False
        return True

    # -- eviction ----------------------------------------------------------

    def _evictable(self, protect: Optional[Set[int]]):
        """Leaf-first candidates: tails, and nodes nothing chains
        under. ``protect`` excludes pages an in-flight admission is
        about to share (evicting them would free pages out from under
        the slot being placed)."""
        def walk(node: _TrieNode):
            for tail in node.tails.values():
                if not protect or tail.page not in protect:
                    yield tail
            for child in node.children.values():
                if (not child.children and not child.tails
                        and (not protect or child.page not in protect)):
                    yield child
                yield from walk(child)

        return walk(self._root)

    def evict_lru(self, protect: Optional[Set[int]] = None) -> bool:
        """Evict the least-recently-used evictable LEAF (tail pages
        and chain ends — an interior node's page is meaningless without
        its parent chain, so eviction never orphans a descendant).
        Returns False when nothing is evictable."""
        victim = min(self._evictable(protect),
                     key=lambda n: n.tick, default=None)
        if victim is None:
            return False
        if isinstance(victim, _Tail):
            del victim.node.tails[victim.key]
        else:
            del victim.parent.children[victim.key]
        self._held.remove(victim.page)
        self.pool.unpin([victim.page])
        return True

    def clear(self) -> None:
        while self.evict_lru():
            pass

    def __len__(self) -> int:
        """Stored pages (nodes + tails) — the budget's unit."""
        return self.pages_held
