"""Host-side page-table allocator for the paged KV cache (port of
``repro/serve/pager.py``, a copy: the module is numpy and Python only).

The engine's resident cache stores k/v in fixed-size **pages**: per layer,
a pool tensor ``(num_pages, page_size, ...)`` replaces the per-slot
contiguous ``(batch_slots, max_len, ...)`` rows.  This module owns every
*allocation* decision on the host — which physical page backs which
logical page of which slot — while the device side (models/attention.py)
only ever sees the resulting ``(batch_slots, pages_per_slot)`` table.
Cache memory therefore scales with the tokens actually resident, not with
``batch_slots × max_len`` worst case.

Layout contract:
  * physical page 0 is ``SCRATCH``: never allocated, pinned forever.  Freed
    slots keep re-decoding idempotently (the engine's fixed batch), so
    their writes need a sink — every retired/unallocated table entry
    points here.  Scratch content is garbage by design (but finite); the
    attention masks (``pos_ids`` / ``length``) keep it unread.
  * a page's refcount = (#slot tables pointing at it) + (1 if the prefix
    cache pins it).  Pages are read-shared; a write requires refcount 1.
    ``fault_in`` enforces that with **copy-on-write**: the writer gets a
    fresh page, the shared original stays frozen for its other readers.

Prefix reuse is **token-granular**: the cache registers each admitted
prompt (token ids + its pages, including the partial last page) and a new
prompt matching ``l`` leading tokens shares every fully-covered page and
gathers the partial one, re-prefilling only the tail.  Divergent writes
inside a partially-shared page are merged at admission (the row already
holds shared + new content, scattered into a fresh page); later decode
writes into a still-shared page (e.g. the registered partial last prompt
page) hit the COW path.  Eviction is LRU and automatic on allocation
pressure.

``Pager.faults`` is an inert hook: ``fault_in`` reads it, and nothing in
the port arms it yet.  ``snapshot``/``restore`` round-trip the tables, the
pool and the prefix cache, with the geometry checked.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

SCRATCH = 0          # reserved physical page: write sink, never allocated


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — caller must retire/preempt."""


class PagerAuditError(ValueError):
    """The refcount audit found a leaked or over-referenced page.

    ``page`` is the offending physical page id (or -1 for a free-list
    inconsistency); ``expected``/``actual`` are the refcounts the table +
    prefix pins imply vs what the pool carries."""

    def __init__(self, msg: str, *, page: int = -1,
                 expected: int = -1, actual: int = -1):
        super().__init__(msg)
        self.page = page
        self.expected = expected
        self.actual = actual


class PagePool:
    """Refcounted fixed-size page allocator (page 0 reserved)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 scratch + 1 usable), "
                             f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.refs = np.zeros(num_pages, np.int64)
        self.refs[SCRATCH] = 1                     # pinned forever
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> page 1 first

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Allocated pages, scratch excluded."""
        return self.num_pages - 1 - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted("page pool exhausted")
        pid = self._free.pop()
        self.refs[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        assert pid != SCRATCH and self.refs[pid] > 0, f"incref of dead {pid}"
        self.refs[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert pid != SCRATCH and self.refs[pid] > 0, f"decref of dead {pid}"
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self._free.append(pid)
            return True
        return False

    def snapshot(self) -> dict:
        return {"refs": self.refs.tolist(), "free": list(self._free)}

    def restore(self, snap: dict) -> None:
        self.refs = np.asarray(snap["refs"], np.int64)
        self._free = list(snap["free"])


class PrefixCache:
    """LRU registry prompt-tokens -> page chain (token-granular matching).

    Registered pages are pinned (one refcount each) until eviction; the
    chain covers ``ceil(len(tokens)/page_size)`` pages, the last possibly
    partial — its tail positions hold the registrant's later data and are
    masked out by any sharer's per-slot bookkeeping.
    """

    def __init__(self, pool: PagePool, max_entries: int = 64):
        self.pool = pool
        self.max_entries = max_entries
        self._entries: OrderedDict[bytes, dict] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, tokens: np.ndarray) -> tuple[int, list[int]]:
        """Longest common prefix over registered prompts.

        Returns ``(n_tok, pages)``: ``n_tok`` matched tokens and the
        ``ceil(n_tok/page_size)`` pages holding them (last one possibly
        partially valid).
        """
        ps = self.pool.page_size
        tokens = np.asarray(tokens, np.int32)
        best_l, best_pages = 0, []
        for entry in self._entries.values():
            et = entry["tokens"]
            n = min(len(et), len(tokens))
            if n <= best_l:
                continue
            neq = np.nonzero(et[:n] != tokens[:n])[0]
            l = int(neq[0]) if len(neq) else n
            if l > best_l:
                best_l = l
                best_pages = entry["pages"][: -(-l // ps)]
                best_key = entry["key"]
        if best_l:
            self._entries.move_to_end(best_key)          # LRU touch
        return best_l, list(best_pages)

    def register(self, tokens: np.ndarray, pages: list[int]) -> bool:
        """Pin ``pages`` as the chain for ``tokens``; no-op if present."""
        tokens = np.asarray(tokens, np.int32)
        key = tokens.tobytes()
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        for pid in pages:
            self.pool.incref(pid)
        self._entries[key] = {"key": key, "tokens": tokens,
                              "pages": list(pages)}
        while len(self._entries) > self.max_entries:
            self.evict_one()
        return True

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry; returns False when empty."""
        if not self._entries:
            return False
        _, entry = self._entries.popitem(last=False)
        for pid in entry["pages"]:
            self.pool.decref(pid)
        return True

    def snapshot(self) -> list[dict]:
        return [{"tokens": e["tokens"].tolist(), "pages": list(e["pages"])}
                for e in self._entries.values()]

    def restore(self, snap: list[dict]) -> None:
        self._entries.clear()
        for e in snap:
            tokens = np.asarray(e["tokens"], np.int32)
            self._entries[tokens.tobytes()] = {
                "key": tokens.tobytes(), "tokens": tokens,
                "pages": list(e["pages"])}


@dataclasses.dataclass
class AdmitPlan:
    """Device work implied by one admission (all host ints)."""
    start: int                 # first token position the row prefill computes
    n_shared_tok: int          # tokens covered by the shared-page gather
    gather_pids: list[int]     # pages to copy into the row head (may be [])
    fresh_lps: list[int]       # logical pages to scatter from the row...
    fresh_pids: list[int]      # ...into these freshly-allocated pool pages


class Pager:
    """Per-engine page tables + allocation policy.

    The engine drives: ``admit`` on prompt arrival, ``fault_in`` before
    every decode write, ``register`` after prefill, ``retire`` on
    completion/preemption.  ``table`` is the host-authoritative
    (batch_slots, pages_per_slot) map the engine mirrors to the device
    whenever ``dirty``.
    """

    def __init__(self, *, batch_slots: int, pages_per_slot: int,
                 num_pages: int, page_size: int, prefix_reuse: bool = True,
                 max_prefix_entries: int = 64):
        self.pool = PagePool(num_pages, page_size)
        self.pages_per_slot = pages_per_slot
        self.table = np.full((batch_slots, pages_per_slot), SCRATCH, np.int32)
        self.prefix = (PrefixCache(self.pool, max_prefix_entries)
                       if prefix_reuse else None)
        self.dirty = True
        # fault injection hook: an object with ``fire(site)``; None (the
        # port arms nothing yet) costs one attribute load in fault_in
        self.faults = None

    # ------------------------------------------------------------ alloc
    def _alloc(self) -> int:
        """Allocate, evicting LRU prefix entries under pressure."""
        while True:
            try:
                return self.pool.alloc()
            except PoolExhausted:
                if self.prefix is None or not self.prefix.evict_one():
                    raise

    # ------------------------------------------------------------ admission
    def match(self, tokens) -> tuple[int, list[int]]:
        if self.prefix is None:
            return 0, []
        return self.prefix.match(tokens)

    def admit(self, slot: int, tokens: np.ndarray) -> AdmitPlan:
        """Build the slot's page-table row for a prompt of S tokens.

        Pages fully inside the shared prefix (and untouched by the tail
        prefill) are pointed at shared and increfed; every other prompt
        page gets a fresh allocation the engine scatters row content into
        (this is where a partially-shared page's divergence merges).
        Raises PoolExhausted with **no state change** when the pool can't
        cover the fresh pages — the caller re-queues and waits/preempts.
        """
        tokens = np.asarray(tokens, np.int32)
        S = len(tokens)
        ps = self.pool.page_size
        n_pages = -(-S // ps)
        assert n_pages <= self.pages_per_slot, "submit() must bound prompts"
        n_tok, shared = self.match(tokens)
        n_tok = min(n_tok, S)
        # full match still re-decodes the last prompt token for its logits
        start = n_tok if n_tok < S else S - 1
        keep_pages = min(n_tok, start) // ps
        fresh_lps = list(range(keep_pages, n_pages))
        # pin the kept shared pages BEFORE allocating: _alloc may evict
        # prefix entries under pressure, and an unpinned kept page whose
        # only reference was the evicted entry would be freed & re-issued
        # as one of our own fresh pages (table aliasing corruption)
        for pid in shared[:keep_pages]:
            self.pool.incref(pid)
        fresh_pids: list[int] = []
        try:
            for _ in fresh_lps:
                fresh_pids.append(self._alloc())
        except PoolExhausted:
            for pid in fresh_pids:
                self.pool.decref(pid)
            for pid in shared[:keep_pages]:
                self.pool.decref(pid)
            raise
        row = np.full(self.pages_per_slot, SCRATCH, np.int32)
        row[:keep_pages] = shared[:keep_pages]
        row[keep_pages:n_pages] = fresh_pids
        self.table[slot] = row
        self.dirty = True
        return AdmitPlan(start=start, n_shared_tok=n_tok,
                         gather_pids=shared[: -(-n_tok // ps)] if n_tok else [],
                         fresh_lps=fresh_lps, fresh_pids=fresh_pids)

    def register(self, slot: int, tokens: np.ndarray) -> None:
        """Pin the slot's prompt pages in the prefix cache."""
        if self.prefix is None:
            return
        tokens = np.asarray(tokens, np.int32)
        n_pages = -(-len(tokens) // self.pool.page_size)
        self.prefix.register(tokens, self.table[slot, :n_pages].tolist())

    # ------------------------------------------------------------ decode
    def fault_in(self, slot: int, pos: int) -> list[tuple[int, int]]:
        """Make the page holding ``pos`` privately writable for ``slot``.

        Returns device copy ops [(src, dst)] — non-empty exactly when a
        shared page was COW'd.  Unallocated -> fresh page (decode writes
        start at the page head, so stale content stays masked).  Raises
        PoolExhausted with no state change.
        """
        if self.faults is not None and \
                self.faults.fire("pager_fault_in") is not None:
            # a long enough burst outlasts the engine's preempt-and-retry
            # loop and escapes to the caller as a real exhaustion
            raise PoolExhausted(
                f"injected fault: page pool exhausted faulting in slot "
                f"{slot} pos {pos}")
        lp = pos // self.pool.page_size
        assert lp < self.pages_per_slot, f"pos {pos} beyond slot capacity"
        pid = int(self.table[slot, lp])
        if pid == SCRATCH:
            self.table[slot, lp] = self._alloc()
            self.dirty = True
            return []
        if self.pool.refs[pid] > 1:
            try:
                fresh = self._alloc()             # may raise; state untouched
            except PoolExhausted:
                # _alloc's prefix eviction may have dropped the entry that
                # shared this page — if we now own it outright, no COW needed
                if self.pool.refs[pid] == 1:
                    return []
                raise
            self.pool.decref(pid)
            self.table[slot, lp] = fresh
            self.dirty = True
            return [(pid, fresh)]
        return []

    def retire(self, slot: int) -> None:
        """Release every page the slot holds; row becomes all-scratch."""
        for pid in self.table[slot]:
            if pid != SCRATCH:
                self.pool.decref(int(pid))
        self.table[slot] = SCRATCH
        self.dirty = True

    # ------------------------------------------------------------ auditing
    def check(self) -> None:
        """Audit the refcount/free-list invariants.

        Raises :class:`PagerAuditError` naming the leaked / over-referenced
        page.  ``ServeConfig(debug_checks=True)`` runs it after every
        continuous step."""
        want = np.zeros(self.pool.num_pages, np.int64)
        want[SCRATCH] = 1
        for pid in self.table.ravel():
            if pid != SCRATCH:
                want[pid] += 1
        if self.prefix is not None:
            for e in self.prefix._entries.values():
                for pid in e["pages"]:
                    want[pid] += 1
        free = set(self.pool._free)
        if len(free) != len(self.pool._free):
            dup = [p for p in free if self.pool._free.count(p) > 1]
            raise PagerAuditError(
                f"free list holds duplicate page(s) {dup}", page=dup[0])
        for pid in range(self.pool.num_pages):
            if pid in free:
                if want[pid] or self.pool.refs[pid]:
                    raise PagerAuditError(
                        f"page {pid} is on the free list but still "
                        f"referenced (table/prefix refs {int(want[pid])}, "
                        f"pool refs {int(self.pool.refs[pid])})",
                        page=pid, expected=0,
                        actual=int(self.pool.refs[pid]))
            elif self.pool.refs[pid] != want[pid]:
                kind = ("leaked" if self.pool.refs[pid] > want[pid]
                        else "over-referenced")
                raise PagerAuditError(
                    f"page {pid} {kind}: pool refcount "
                    f"{int(self.pool.refs[pid])} != {int(want[pid])} "
                    f"references held by slot tables + prefix pins",
                    page=pid, expected=int(want[pid]),
                    actual=int(self.pool.refs[pid]))
        live = int((want[1:] > 0).sum())
        if live != self.pool.used_pages:
            raise PagerAuditError(
                f"pool accounting drift: {self.pool.used_pages} pages "
                f"allocated but {live} referenced",
                expected=live, actual=self.pool.used_pages)

    # ------------------------------------------------------------ ckpt
    def snapshot(self) -> dict:
        return {
            "table": self.table.copy(),
            "geometry": {"page_size": self.pool.page_size,
                         "num_pages": self.pool.num_pages,
                         "pages_per_slot": self.pages_per_slot,
                         "batch_slots": int(self.table.shape[0])},
            "pool": self.pool.snapshot(),
            "prefix": (self.prefix.snapshot()
                       if self.prefix is not None else None),
        }

    def restore(self, snap: dict) -> None:
        table = np.asarray(snap["table"], np.int32)
        if table.shape != self.table.shape:
            raise ValueError(
                f"pager snapshot table {table.shape} does not match engine "
                f"geometry {self.table.shape}")
        # geometry must match exactly: a table of page ids from a different
        # (page_size, num_pages, pages_per_slot) world silently mis-indexes
        # this pool (same-shape tables can still disagree on page_size)
        want = {"page_size": self.pool.page_size,
                "num_pages": self.pool.num_pages,
                "pages_per_slot": self.pages_per_slot,
                "batch_slots": int(self.table.shape[0])}
        geom = snap.get("geometry", want)   # pre-geometry snapshots: shape
        for key, val in want.items():       # + pool-size checks still apply
            if geom.get(key, val) != val:
                raise ValueError(
                    f"pager snapshot {key}={geom[key]} does not match "
                    f"engine {key}={val} — restoring would mis-index the "
                    f"page pool")
        if len(snap["pool"]["refs"]) != self.pool.num_pages:
            raise ValueError(
                f"pager snapshot has {len(snap['pool']['refs'])} pages, "
                f"engine pool has {self.pool.num_pages}")
        self.table = table.copy()
        self.pool.restore(snap["pool"])
        if self.prefix is not None and snap["prefix"] is not None:
            self.prefix.restore(snap["prefix"])
        elif self.prefix is not None:
            self.prefix.restore([])
        self.dirty = True
