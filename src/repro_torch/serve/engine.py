"""Batched serving engine — continuous (slot-level) batching over fixed
slots and a contiguous or paged resident KV cache (port of
``repro/serve/engine.py``, continuous scheduler, greedy decoding).

Every slot carries its own position, so requests of any length decode packed
in one (B_slots, 1) step.  A queued request is admitted into a free slot by
prefilling it at B=1 into a fresh single-row cache — a sequential decode
over the prompt, as the JAX engine prefills — and the row is then written
into its slot of the resident cache in place.  A finished slot is freed and
re-admits from the queue before the next step.  Idle slots keep re-decoding
their last token at a frozen position: the writes land on their own row
only (a recurrent row — Mamba, xLSTM state — advances, and is rewritten
whole at the next admission), so each active row's tokens are those of
serving it alone at B=1.  On the card that holds up to rounding: its
batch-shaped kernels (cuBLAS, reductions) round a row of a B=4 step and
of a B=1 step differently, so a near-tie in the logits may fall either
way.
In an MoE layer the idle rows route through ``moe_ffn`` like the others.
That holds the B=1 equivalence only while no expert overflows: a token
takes at most one slot per expert, so an expert holds at most B rows, and
the capacity is at least 8 — with B ≤ 8 slots nothing is dropped.  Above
8 slots a batch-mate (idle or not) can push a row's assignment past the
capacity, as in the JAX engine.

Paged mode (``ServeConfig.paged``): the full-attention layers' caches
become page pools shared by every slot (``models/attention.py``), and the
host-side ``serve/pager.Pager`` decides which page backs which logical page
of which slot.  A new prompt shares the pages of the longest registered
prompt it starts with (token-granular prefix reuse, off for windowed
models) and prefills only its tail; before every decode step each active
slot's write page is made its own (a fresh page on a page boundary, a copy
of a shared one); when the pool runs out the most recently admitted slot
is preempted and re-queued at the front, and resumes by re-prefilling
its prompt and the tokens it had emitted.  Greedy tokens are those of the
contiguous engine.

Compressed weights: params whose pruned linears are ``NmCompressed``
(``serve/compressed.py``) stay compressed-resident — no
``decompress_params`` — and every pruned linear of prefill and decode runs
through ``kernels/ops.nm_matmul`` (K2 on the card); an expert stack is one
``NmStackedCompressed`` leaf through ``ops.nm_matmul_stacked`` (K3).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ops import NmKernelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.serve.pager import SCRATCH, Pager, PoolExhausted


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any              # (S,) int token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 512
    # n:m compressed-matmul impl (kernels/ops.NmKernelConfig: auto | ref |
    # kernel); auto = K2 on a card, the plain version on the CPU
    nm_impl: str = "auto"
    # paged KV cache (serve/pager.py): cache rows become page pools shared
    # across slots; memory scales with resident tokens, not slots × max_len
    paged: bool = False
    page_size: int = 16      # tokens per page; must divide max_len
    num_pages: int = 0       # 0 = auto: 1 + batch_slots · max_len/page_size
    prefix_reuse: bool = True  # share prompt pages across requests (COW)
    # run the pager's refcount audit after every continuous step
    debug_checks: bool = False

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {self.batch_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.paged:
            if self.page_size < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {self.page_size}")
            if self.max_len % self.page_size:
                raise ValueError(
                    f"page_size={self.page_size} must divide "
                    f"max_len={self.max_len} so the paged logical row and "
                    f"the contiguous row have identical length (bit-parity)")
            pps = self.max_len // self.page_size
            if self.num_pages and self.num_pages < 1 + pps:
                raise ValueError(
                    f"num_pages={self.num_pages} < {1 + pps} (scratch + one "
                    f"full slot) cannot guarantee forward progress")


# --------------------------------------------------------------------------
# paged-cache device helpers over the per-layer cache dict: paged layers use
# the pool scatter/gather of models/attention.py, ring layers the whole-row
# copy.  Page vectors have a fixed length, padded with page 0 (scratch).
# --------------------------------------------------------------------------
def _write_row(full, one, slot: int) -> None:
    """Copy a B=1 contiguous cache into row ``slot`` of ``full``, in place
    — the whole row, so a stale tail is re-zeroed.  Every tensor field of
    every contiguous kind (GQA k/v and positions, MLA latents and lengths,
    Mamba and xLSTM state) is batch-leading.  A dict of caches (the
    hybrid's {"mamba": {i}, "shared": {j}}) is written leaf by leaf."""
    if isinstance(full, dict):
        for k, layer in full.items():
            _write_row(layer, one[k], slot)
        return
    for f in dataclasses.fields(full):
        dst = getattr(full, f.name)
        if isinstance(dst, torch.Tensor):
            dst[slot] = getattr(one, f.name)[0]


def _admit_write_fn(cache: dict, row: dict, slot: int, lps, pids) -> None:
    """Admission: scatter a B=1 row cache into the resident paged cache.
    Row logical page ``lps[i]`` lands in pool page ``pids[i]``; the kept
    shared pages are absent from the vectors and stay untouched."""
    for i, layer in cache.items():
        if A.is_paged(layer):
            A.paged_write_row(layer, row[i], slot, lps, pids)
        else:
            _write_row(layer, row[i], slot)


def _prefix_row_fn(cache: dict, row: dict, pids, n_tok: int) -> None:
    """Materialize a shared prefix (pool pages ``pids``, the first ``n_tok``
    tokens valid) into a fresh B=1 row cache ahead of the tail prefill."""
    for i, layer in cache.items():
        if A.is_paged(layer):
            A.paged_prefix_to_row(layer, row[i], pids, n_tok)


def _copy_pages_fn(cache: dict, src, dst) -> None:
    """Copy-on-write service: pool[dst[i]] = pool[src[i]] on paged layers."""
    for layer in cache.values():
        if A.is_paged(layer):
            A.paged_copy_pages(layer, src, dst)


class ServingEngine:
    def __init__(self, model, params, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.params = params         # NmCompressed leaves stay compressed
        self.nm_kernel = NmKernelConfig(impl=cfg.nm_impl)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        # vtime: work units (1 a decode step, the tokens a prefill computes)
        self.stats = {"decode_steps": 0, "busy_slot_steps": 0,
                      "prefills": 0, "prefill_tokens": 0, "vtime": 0,
                      "preemptions": 0, "page_faults": 0, "cow_copies": 0,
                      "prefix_hit_tokens": 0, "pages_hwm": 0}
        self._slots: list[Request | None] = [None] * cfg.batch_slots
        self._cache = None
        self._tokens = np.zeros((cfg.batch_slots, 1), np.int64)
        self._pos = np.zeros((cfg.batch_slots,), np.int64)
        # admission order per slot: preemption victims are LIFO
        self._seq = 0
        self._slot_seq = [0] * cfg.batch_slots
        self.pager: Pager | None = None
        if cfg.paged:
            if not hasattr(model, "init_paged_cache"):
                raise ValueError(
                    f"model {type(model).__name__} has no init_paged_cache — "
                    f"paged serving covers the transformer families")
            self._pps = cfg.max_len // cfg.page_size
            self._num_pages = cfg.num_pages or 1 + cfg.batch_slots * self._pps
            # prefix reuse is unsound across sliding-window rings (a sharer
            # would miss the ring history of the skipped positions), so it
            # is off for windowed models
            prefix = cfg.prefix_reuse and not model.cfg.sliding_window
            self.pager = Pager(
                batch_slots=cfg.batch_slots, pages_per_slot=self._pps,
                num_pages=self._num_pages, page_size=cfg.page_size,
                prefix_reuse=prefix)

    # ----------------------------------------------------------- helpers
    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.int64)).to(self.model.device)

    def _absorb(self, req: Request, token: int) -> None:
        """Record one sampled token for ``req`` unless it already finished."""
        if req.done or len(req.out) >= req.max_new:
            req.done = True
            return
        req.out.append(token)
        if len(req.out) >= req.max_new:
            req.done = True

    # ----------------------------------------------------------- main loop
    def submit(self, req: Request) -> None:
        if len(req.prompt) + 1 > self.cfg.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} does "
                f"not fit max_len={self.cfg.max_len} (need prompt + 1)")
        self.queue.append(req)

    def idle(self) -> bool:
        """No queued requests and no slot mid-generation."""
        return not self.queue and all(s is None for s in self._slots)

    def pump(self) -> bool:
        """One scheduling quantum: admissions + one decode step.  Returns
        False when there is nothing to do."""
        with torch.no_grad(), L.nm_kernel_scope(self.nm_kernel):
            return self._continuous_step()

    def run(self, *, max_steps: int = 100_000) -> list[Request]:
        """Drain queue and slots; returns finished requests in uid order.
        Requests still in flight when ``max_steps`` runs out come back too,
        with ``done=False`` and their partial ``out``."""
        steps = 0
        while steps < max_steps and self.pump():
            steps += 1
        done, self.finished = self.finished, []
        if not self.idle():
            done += [r for r in self._slots if r is not None]
            done += list(self.queue)
        return sorted(done, key=lambda r: r.uid)

    # ------------------------------------------------- continuous scheduler
    def _ensure_state(self) -> None:
        if self._cache is None:
            if self.cfg.paged:
                self._cache = self.model.init_paged_cache(
                    self.cfg.batch_slots, num_pages=self._num_pages,
                    page_size=self.cfg.page_size, pages_per_slot=self._pps)
            else:
                self._cache = self.model.init_cache(self.cfg.batch_slots,
                                                    self.cfg.max_len)

    def _retire(self, slot: int) -> None:
        self.finished.append(self._slots[slot])
        self._slots[slot] = None
        if self.pager is not None:
            self.pager.retire(slot)
        # _pos[slot] keeps its last (< max_len) value: the freed slot keeps
        # re-decoding idempotently until the next admission overwrites it
        # (paged: its table row points at the scratch page, a write sink)

    def _prefill(self, row: dict, tokens: np.ndarray, start: int = 0):
        """Sequential decode at B=1 over positions [start, S) of ``tokens``
        into the row cache ``row`` (positions below ``start`` are already
        there: a shared prefix) → (row cache, last logits (1, V))."""
        toks = self._device(tokens.reshape(1, -1))
        logits = None
        for i in range(start, toks.shape[1]):
            logits, row = self.model.decode_step(self.params, row,
                                                 toks[:, i:i + 1], i)
        return row, logits[:, -1, :]

    def _write_slot(self, row: dict, slot: int) -> None:
        """Copy a B=1 row cache into row ``slot`` of the resident
        contiguous cache, in place."""
        _write_row(self._cache, row, slot)

    def _pages(self, vals, fill: int) -> torch.Tensor:
        """A page vector padded to pages_per_slot, on the device."""
        out = np.full(self._pps, fill, np.int64)
        out[:len(vals)] = vals
        return self._device(out)

    def _admit_into(self, slot: int) -> bool:
        """Prefill the queue head into ``slot``.  Returns False — leaving
        the request queued — when the paged pool cannot cover its pages.

        A request with a partial ``out`` is a preemption resume: the engine
        re-prefills prompt + out (positions [0, S)), skips sampling, and
        re-enters decode at pos = S - 1 feeding the last emitted token; the
        next decode step rewrites that position with identical k/v, so the
        continuation is that of never having been preempted."""
        req = self.queue[0]
        self._ensure_state()
        prompt = np.asarray(req.prompt, np.int64)
        resumed = len(req.out) > 0
        tokens_all = (np.concatenate([prompt, np.asarray(req.out, np.int64)])
                      if resumed else prompt)
        S = len(tokens_all)
        plan = None
        if self.pager is not None:
            try:
                plan = self.pager.admit(slot, tokens_all)
            except PoolExhausted:
                return False
        self.queue.pop(0)
        row = self.model.init_cache(1, self.cfg.max_len)
        start = 0
        if plan is not None:
            start = plan.start
            if plan.n_shared_tok:
                _prefix_row_fn(self._cache, row,
                               self._pages(plan.gather_pids, SCRATCH),
                               plan.n_shared_tok)
                self.stats["prefix_hit_tokens"] += plan.n_shared_tok
        row, last = self._prefill(row, tokens_all, start)
        if plan is not None:
            _admit_write_fn(self._cache, row, slot,
                            self._pages(plan.fresh_lps, 0),
                            self._pages(plan.fresh_pids, SCRATCH))
            self.pager.register(slot, prompt)
        else:
            self._write_slot(row, slot)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += S - start
        self.stats["vtime"] += S - start
        self._slots[slot] = req
        self._slot_seq[slot] = self._seq
        self._seq += 1
        if resumed:
            self._tokens[slot, 0] = int(tokens_all[-1])
            self._pos[slot] = S - 1     # re-decode the last emitted token
            return True
        tok = int(torch.argmax(last, dim=-1)[0])
        self._absorb(req, tok)
        self._tokens[slot, 0] = tok
        self._pos[slot] = S
        if req.done or S + 1 >= self.cfg.max_len:
            req.done = True
            self._retire(slot)          # freed — the caller retries the queue
        return True

    def _admit(self) -> bool:
        """Fill free slots from the queue before the next decode step;
        stops at the first request the paged pool cannot hold."""
        admitted = False
        for slot in range(self.cfg.batch_slots):
            while self._slots[slot] is None and self.queue:
                if not self._admit_into(slot):
                    return admitted     # pool exhausted — wait for retires
                admitted = True
        return admitted

    # ------------------------------------------------------- paged plumbing
    def _preempt(self, slot: int) -> None:
        """Evict an active slot to free its pages: the request re-queues at
        the front with its partial output and resumes via ``_admit_into``."""
        req = self._slots[slot]
        self.pager.retire(slot)
        self._slots[slot] = None
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1

    def _victim(self, exclude: int) -> int | None:
        """Most recently admitted active slot other than ``exclude`` (LIFO:
        the oldest requests keep their pages and finish first)."""
        cands = [s for s in range(self.cfg.batch_slots)
                 if s != exclude and self._slots[s] is not None]
        return max(cands, key=lambda s: self._slot_seq[s], default=None)

    def _fault_active(self) -> None:
        """Make every active slot's write page its own before the decode
        step: allocate on page boundaries, copy shared pages, preempting
        LIFO victims under pool pressure."""
        ps = self.cfg.page_size
        copies: list[tuple[int, int, int, int]] = []   # (slot, lp, src, dst)
        for slot in range(self.cfg.batch_slots):
            if self._slots[slot] is None:
                continue
            pos = int(self._pos[slot])
            was_scratch = self.pager.table[slot, pos // ps] == SCRATCH
            while True:
                try:
                    copies.extend((slot, pos // ps, s, d)
                                  for s, d in self.pager.fault_in(slot, pos))
                    break
                except PoolExhausted:
                    victim = self._victim(exclude=slot)
                    if victim is None:
                        raise          # impossible: num_pages >= 1 + pps
                    self._preempt(victim)
            if was_scratch:
                self.stats["page_faults"] += 1
        # a preemption later in the loop may have freed (and re-allocated)
        # an earlier slot's copy destination: keep only copies whose slot
        # is still active and whose destination is still mapped there
        copies = [(slot, lp, s, d) for slot, lp, s, d in copies
                  if self._slots[slot] is not None
                  and self.pager.table[slot, lp] == d]
        if copies:
            # at most one copy a slot a step → (B,) vectors padded with
            # (scratch, scratch)
            src = np.zeros(self.cfg.batch_slots, np.int64)
            dst = np.zeros(self.cfg.batch_slots, np.int64)
            for j, (_, _, s, d) in enumerate(copies):
                src[j], dst[j] = s, d
            _copy_pages_fn(self._cache, self._device(src), self._device(dst))
            self.stats["cow_copies"] += len(copies)

    def _sync_tables(self) -> None:
        """Mirror the host's page table to the device: one copy a dirty
        step, one tensor shared by every paged layer."""
        if not self.pager.dirty:
            return
        table = self._device(self.pager.table)
        for layer in self._cache.values():
            if A.is_paged(layer):
                layer.table = table
        self.pager.dirty = False

    def _continuous_step(self) -> bool:
        admitted = self._admit()
        active = [s for s in self._slots if s is not None]
        if not active:
            return admitted
        if self.pager is not None:
            self._fault_active()
            self._sync_tables()
            active = [s for s in self._slots if s is not None]  # preemptions
            if not active:
                return admitted
            used = self.pager.pool.used_pages
            if used > self.stats["pages_hwm"]:
                self.stats["pages_hwm"] = used
        logits, self._cache = self.model.decode_step(
            self.params, self._cache, self._device(self._tokens),
            self._device(self._pos))
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["busy_slot_steps"] += len(active)
        self.stats["vtime"] += 1
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            self._absorb(req, int(nxt[slot]))
            self._tokens[slot, 0] = nxt[slot]
            # the last decode position is max_len - 2
            if not req.done and self._pos[slot] + 2 >= self.cfg.max_len:
                req.done = True              # slot cache region exhausted
            if req.done:
                self._retire(slot)
            else:
                self._pos[slot] += 1
        if self.cfg.debug_checks and self.pager is not None:
            self.pager.check()
        return True
