"""Batched serving engine — continuous (slot-level) or wave batching over
fixed slots and a contiguous or paged resident KV cache (port of
``repro/serve/engine.py``).

**Continuous scheduler** (``ServeConfig.scheduler="continuous"``, default).
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

**Wave scheduler** (``scheduler="wave"``, the correctness oracle).  Up to
``batch_slots`` same-length prompts prefill together, then decode in lock
step at one scalar position until every request of the wave is finished.

Decoding is greedy (argmax) or, with ``greedy=False``, categorical at
``temperature`` from an explicit ``torch.Generator`` (Gumbel-max: the
argmax of logits/T plus Gumbel noise drawn from the generator), so a
sampled run is reproducible from its seed.  A request stops at
``max_new`` tokens, at ``eos_id``, at the end of its cache region, at its
``deadline_s`` (``error="deadline"``) or when cancelled.

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

Compiled step (the port of JAX's ``_model_jits``): every model step is
``_decode_fn`` over static buffers — a (B, 1) token and a (B,) position
tensor filled in place before the step, and a cache the step writes in
place: the resident cache (continuous decode at B = batch_slots), one
B = 1 row cache that each admission resets from a template and prefills,
and, for the wave scheduler, one B = batch_slots wave cache reset the same
way.  On a card each of those steps is captured once as a CUDA graph
(``_Step``): its first call runs eagerly on a side stream — the warm-up
PyTorch asks for before a capture, and a real step — then the step is
captured in thread-local mode (the SSE front end drives the engine from
its own thread) into one memory pool the engine's graphs share, and every
later call replays the graph.  A continuous engine holds at most two
graphs, a wave engine one.  On the CPU the same step runs eagerly.  There
is no switch and no fallback: a capture that fails raises.  Sampling, the
fault hooks, the watchdog and the admission's scatter, prefix gather and
copy-on-write stay eager, outside the graphs; the paged layers share one
table tensor that ``_sync_tables`` copies the pager's table into, and
``restore`` copies into the live cache, so a replay never reads a stale
buffer.

Fault tolerance: ``snapshot()`` captures the whole engine — **host copies**
of the resident cache, the tokens, the positions and the generator state
(the live cache is written in place by every step, so a snapshot holding
references would "restore" the faulted state), plus the request
bookkeeping — and ``restore()`` rebuilds it on a fresh or faulted engine,
which then continues bit-identically.  ``arm_faults`` arms a
``serve/faults.FaultPlan``: the ``prefill`` site raises ``DeviceOom`` at
admission before any state changes, ``decode_stall`` sleeps after a decode
step, ``decode_logits`` turns its logits into NaN, and the paged pager's
``pager_fault_in`` raises ``PoolExhausted``.  With ``watch_logits`` the
step raises ``NonFiniteLogits`` before any token is absorbed
(``serve/supervisor.py`` rolls back and replays).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ops import NmKernelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.serve.faults import (DeviceOom, FaultPlan, NonFiniteLogits,
                                      QueueFull)
from repro_torch.serve.pager import SCRATCH, Pager, PoolExhausted
from repro_torch.util import graphs
from repro_torch.util.tree import data_ptrs, fill_, flatten, rebuild


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any              # (S,) int token ids
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # serving telemetry (time.perf_counter seconds; < 0 = not yet)
    t_submit: float = -1.0
    t_first: float = -1.0
    t_done: float = -1.0
    # wall-clock budget from t_submit (0 = none); an expired request
    # finishes with error="deadline" and the tokens it produced
    deadline_s: float = 0.0
    error: str = ""          # "" = clean; "deadline" / "cancelled" / …
    # streaming hook: on_token(req, token) after each absorbed token (the
    # front end's SSE push); not part of a snapshot
    on_token: Any = dataclasses.field(default=None, repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 512
    greedy: bool = True
    temperature: float = 1.0
    eos_id: int = -1         # < 0 = no stop token
    scheduler: str = "continuous"   # "continuous" | "wave" (the oracle)
    # n:m compressed-matmul impl (kernels/ops.NmKernelConfig: auto | ref |
    # kernel); auto = K2 on a card, the plain version on the CPU
    nm_impl: str = "auto"
    # paged KV cache (serve/pager.py): cache rows become page pools shared
    # across slots; memory scales with resident tokens, not slots × max_len
    paged: bool = False
    page_size: int = 16      # tokens per page; must divide max_len
    num_pages: int = 0       # 0 = auto: 1 + batch_slots · max_len/page_size
    prefix_reuse: bool = True  # share prompt pages across requests (COW)
    # admission control: > 0 bounds the request queue — submit() raises
    # QueueFull past it (the front end answers 503 + Retry-After)
    max_queued: int = 0
    # run the pager's refcount audit after every continuous step
    debug_checks: bool = False

    def __post_init__(self):
        if self.max_queued < 0:
            raise ValueError(f"max_queued must be >= 0 (0 = unbounded), "
                             f"got {self.max_queued}")
        if not (math.isfinite(self.temperature) and self.temperature > 0):
            raise ValueError(
                f"temperature must be a finite positive float, got "
                f"{self.temperature!r} — <= 0 turns categorical sampling "
                f"into NaN/garbage silently")
        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {self.batch_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.paged:
            if self.scheduler != "continuous":
                raise ValueError("paged=True requires the continuous "
                                 "scheduler (wave allocates per-wave caches)")
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


def _copy_tree(tree, device):
    """Deep copy of a cache tree (dicts of cache dataclasses) with every
    tensor copied to ``device`` — never an alias, also where the tensor is
    already there."""
    leaves, skel = flatten(tree)
    return rebuild(skel, [t.detach().to(device, copy=True) for t in leaves])


def _decode_fn(model, params, cache, tokens, pos) -> torch.Tensor:
    """The captured step: one decode of ``tokens`` (B, 1) at positions
    ``pos`` (B,), written into ``cache`` in place → the logits (B, V)."""
    logits, _ = model.decode_step(params, cache, tokens, pos)
    return logits[:, -1, :]


class _Step:
    """One batch size's model step over one static cache (an entry of
    JAX's ``_model_jits``): static ``tokens`` (B, 1) and ``pos`` (B,) that
    the caller fills in place, and ``_decode_fn`` writing ``cache`` in
    place → the logits (B, V).

    On the CPU every call runs the step eagerly.  On a card the first call
    runs it eagerly on the thread's side stream and checks that it wrote
    its cache in place (a rebound tensor would leave a graph writing stale
    buffers), then captures it as a CUDA graph in ``pool``
    (``util.graphs.Graph``); every later call replays the graph.  The
    logits a replay returns live in the pool: consume or copy them before
    any graph of the pool replays again."""

    def __init__(self, model, params, cache, batch: int, pool):
        dev = model.device
        self.model, self.params, self.cache, self.pool = (model, params,
                                                          cache, pool)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self.graph: "graphs.Graph | None" = None
        self.calls = 0           # model steps run, eager or replayed
        self.capture_s = 0.0     # the warm-up step and the capture
        self.pool_bytes = 0      # what the capture added to the reserve

    @property
    def replays(self) -> int:
        return 0 if self.graph is None else self.graph.replays

    def _captured_step(self) -> torch.Tensor:
        return _decode_fn(self.model, self.params, self.cache, self.tokens,
                          self.pos)

    def run(self) -> torch.Tensor:
        self.calls += 1
        if self.graph is not None:
            return self.graph.replay()
        dev = self.tokens.device
        if dev.type != "cuda":
            return self._captured_step()
        t0 = time.perf_counter()
        ptrs = data_ptrs(self.cache)
        logits = graphs.run_on_side(self._captured_step, dev)
        graphs.check_in_place(ptrs, self.cache, self.model)
        reserved = graphs.settled_reserve(dev)
        self.graph = graphs.Graph(self._captured_step, dev, self.pool)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        return logits


class ServingEngine:
    def __init__(self, model, params, cfg: ServeConfig, *,
                 gen: "torch.Generator | None" = None):
        """``gen`` draws the sampled tokens (``greedy=False``); the default
        is a generator on the model's device seeded with 0."""
        if cfg.scheduler not in ("continuous", "wave"):
            raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
        self.model = model
        self.cfg = cfg
        self.params = params         # NmCompressed leaves stay compressed
        self.nm_kernel = NmKernelConfig(impl=cfg.nm_impl)
        self.gen = (gen if gen is not None else
                    torch.Generator(device=model.device).manual_seed(0))
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        # vtime: work units (1 a decode step, the tokens a prefill computes)
        self.stats = {"decode_steps": 0, "busy_slot_steps": 0,
                      "prefills": 0, "prefill_tokens": 0, "vtime": 0,
                      "preemptions": 0, "page_faults": 0, "cow_copies": 0,
                      "prefix_hit_tokens": 0, "pages_hwm": 0}
        self._slots: list[Request | None] = [None] * cfg.batch_slots
        self._cache = None
        # the compiled steps ("decode", "row", "wave"), their graphs' pool
        # (on a card), the B = 1 cache template the static caches are reset
        # from, and the table tensor every paged layer shares
        self._steps: dict[str, _Step] = {}
        self._pool = None
        self._tmpl = None
        self._table: torch.Tensor | None = None
        self._tokens = np.zeros((cfg.batch_slots, 1), np.int64)
        self._pos = np.zeros((cfg.batch_slots,), np.int64)
        # admission order per slot: preemption victims are LIFO
        self._seq = 0
        self._slot_seq = [0] * cfg.batch_slots
        # fault injection + watchdog: off until armed (one attribute load
        # a step)
        self.faults: FaultPlan | None = None
        self.watch_logits = False
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

    def arm_faults(self, plan: FaultPlan | None) -> None:
        """Arm (or disarm with None) a fault plan on the engine and, when
        paged, on the pager's fault-in path."""
        self.faults = plan
        if self.pager is not None:
            self.pager.faults = plan

    # ----------------------------------------------------------- helpers
    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.int64)).to(self.model.device)

    def _step(self, kind: str, cache, batch: int) -> _Step:
        """The compiled step ``kind`` over ``cache`` at batch ``batch``,
        made at its first use."""
        step = self._steps.get(kind)
        if step is None:
            if self._pool is None and self.model.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            step = self._steps[kind] = _Step(self.model, self.params, cache,
                                             batch, self._pool)
        return step

    def _static_cache(self, kind: str, batch: int) -> _Step:
        """The step over the static cache ``kind`` ("row" at B = 1, "wave"
        at B = batch_slots), its cache reset in place from the template."""
        if self._tmpl is None:
            self._tmpl = self.model.init_cache(1, self.cfg.max_len)
        step = self._steps.get(kind)
        if step is None:
            return self._step(kind, self.model.init_cache(
                batch, self.cfg.max_len), batch)
        fill_(step.cache, self._tmpl)
        return step

    def graph_stats(self) -> dict:
        """The engine's compiled steps: ``steps`` model steps run (eager or
        replayed), ``graphs`` captured, their ``replays``, the seconds of
        the warm-ups and captures (``capture_s``) and the bytes the
        captures added to the card's reserve (``pool_bytes``).  Counters
        of the process, not serving state: ``restore`` leaves them."""
        steps = list(self._steps.values())
        return {"steps": sum(s.calls for s in steps),
                "graphs": sum(s.graph is not None for s in steps),
                "replays": sum(s.replays for s in steps),
                "capture_s": sum(s.capture_s for s in steps),
                "pool_bytes": sum(s.pool_bytes for s in steps)}

    def _select(self, logits: torch.Tensor) -> np.ndarray:
        """(B, V) logits → (B,) int64 tokens on the host: argmax, or a
        categorical draw at ``temperature`` from ``self.gen``."""
        if not self.cfg.greedy:
            noise = torch.empty(logits.shape, dtype=torch.float32,
                                device=logits.device)
            noise.exponential_(generator=self.gen)     # −log U ~ Exp(1)
            logits = (logits.to(torch.float32) / self.cfg.temperature
                      - torch.log(noise))              # + Gumbel noise
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _absorb(self, req: Request, token: int) -> None:
        """Record one sampled token for ``req`` unless it already finished."""
        if req.done or len(req.out) >= req.max_new:
            req.done = True
            return
        req.out.append(token)
        if req.t_first < 0:
            req.t_first = time.perf_counter()
        if token == self.cfg.eos_id or len(req.out) >= req.max_new:
            req.done = True
            req.t_done = time.perf_counter()
        if req.on_token is not None:
            req.on_token(req, token)

    # ----------------------------------------------------------- main loop
    def submit(self, req: Request, *, force: bool = False) -> None:
        """Queue ``req``; past ``max_queued`` raise ``QueueFull`` unless
        ``force`` (the supervisor's replays)."""
        if len(req.prompt) + 1 > self.cfg.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} does "
                f"not fit max_len={self.cfg.max_len} (need prompt + 1)")
        if (not force and self.cfg.max_queued
                and len(self.queue) >= self.cfg.max_queued):
            # ~one queue drain per resident generation as the backoff hint
            raise QueueFull(
                f"request {req.uid} rejected: queue at max_queued="
                f"{self.cfg.max_queued}",
                retry_after_s=max(1.0, 0.1 * len(self.queue)))
        if req.t_submit < 0:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    def idle(self) -> bool:
        """No queued requests and no slot mid-generation."""
        return not self.queue and all(s is None for s in self._slots)

    def cancel(self, uid: int, *, error: str = "cancelled") -> bool:
        """Abort a queued or in-flight request: it joins ``finished`` with
        ``done=True``, its partial tokens and ``error`` set.  False when the
        uid is not resident (finished already, or unknown)."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                req.done, req.error = True, error
                if req.t_done < 0:
                    req.t_done = time.perf_counter()
                self.queue.pop(i)
                self.finished.append(req)
                return True
        for slot, req in enumerate(self._slots):
            if req is not None and req.uid == uid:
                req.done, req.error = True, error
                self._retire(slot)
                return True
        return False

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        expired = [req.uid
                   for req in (*self.queue,
                               *(r for r in self._slots if r is not None))
                   if not req.done and req.deadline_s > 0
                   and req.t_submit >= 0
                   and now - req.t_submit > req.deadline_s]
        for uid in expired:
            self.cancel(uid, error="deadline")

    def pump(self) -> bool:
        """One scheduling quantum — admissions + one decode step
        (continuous) or one whole wave (wave).  Returns False when there is
        nothing to do."""
        self._expire_deadlines()
        with torch.no_grad(), L.nm_kernel_scope(self.nm_kernel):
            if self.cfg.scheduler == "wave":
                wave = self._next_wave()
                if not wave:
                    return False
                self._serve_wave(wave)
                now = time.perf_counter()
                for req in wave:
                    req.done = True
                    if req.t_done < 0:
                        req.t_done = now
                    self.finished.append(req)
                return True
            return self._continuous_step()

    def run(self, *, max_steps: int = 100_000) -> list[Request]:
        """Drain queue and slots; returns finished requests in uid order.
        Requests still in flight when ``max_steps`` runs out come back too,
        with ``done=False`` and their partial ``out``; they stay resident,
        and a later ``pump``/``run`` continues them."""
        steps = 0
        while steps < max_steps and self.pump():
            steps += 1
        done, self.finished = self.finished, []
        if not self.idle():
            done += [r for r in self._slots if r is not None]
            done += list(self.queue)
        return sorted(done, key=lambda r: r.uid)

    # ------------------------------------------------- continuous scheduler
    def _new_cache(self) -> dict:
        """A fresh resident cache: page pools when paged."""
        if self.cfg.paged:
            return self.model.init_paged_cache(
                self.cfg.batch_slots, num_pages=self._num_pages,
                page_size=self.cfg.page_size, pages_per_slot=self._pps)
        return self.model.init_cache(self.cfg.batch_slots, self.cfg.max_len)

    def _share_tables(self) -> None:
        """Bind every paged layer of the resident cache to one table
        tensor, which ``_sync_tables`` then writes in place."""
        layers = [layer for layer in self._cache.values()
                  if A.is_paged(layer)]
        if layers:
            self._table = layers[0].table
            for layer in layers:
                layer.table = self._table

    def _ensure_state(self) -> None:
        if self._cache is None:
            self._cache = self._new_cache()
            self._share_tables()

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        if req.t_done < 0:
            req.t_done = time.perf_counter()
        self.finished.append(req)
        self._slots[slot] = None
        if self.pager is not None:
            self.pager.retire(slot)
        # _pos[slot] keeps its last (< max_len) value: the freed slot keeps
        # re-decoding idempotently until the next admission overwrites it
        # (paged: its table row points at the scratch page, a write sink)

    def _prefill(self, step: _Step, tokens: np.ndarray, start: int = 0):
        """Sequential decode over positions [start, S) of ``tokens`` (B, S)
        into ``step``'s cache (positions below ``start`` are already there:
        a shared prefix), one step a position → the last logits (B, V).
        The prompt goes to the device once; each step's token and position
        are written into the static buffers there."""
        toks = self._device(tokens)
        logits = None
        for i in range(start, toks.shape[1]):
            step.tokens.copy_(toks[:, i:i + 1])
            step.pos.fill_(i)
            logits = step.run()
        return logits

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
        if self.faults is not None and \
                self.faults.fire("prefill", uid=req.uid) is not None:
            # before any engine/pager state changes: the request stays
            # queued, as after a real allocation failure at prefill entry
            raise DeviceOom(
                f"injected out of memory while prefilling request "
                f"{req.uid}", site="prefill", uid=req.uid)
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
        step = self._static_cache("row", 1)
        row = step.cache
        start = 0
        if plan is not None:
            start = plan.start
            if plan.n_shared_tok:
                _prefix_row_fn(self._cache, row,
                               self._pages(plan.gather_pids, SCRATCH),
                               plan.n_shared_tok)
                self.stats["prefix_hit_tokens"] += plan.n_shared_tok
        last = self._prefill(step, tokens_all[None, :], start)
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
        tok = int(self._select(last)[0])
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
        step, into the one table tensor every paged layer shares (a
        captured step reads that tensor, so it is written, never
        rebound)."""
        if not self.pager.dirty:
            return
        if self._table is not None:
            self._table.copy_(torch.from_numpy(
                np.asarray(self.pager.table, np.int64)))
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
        step = self._step("decode", self._cache, self.cfg.batch_slots)
        step.tokens.copy_(torch.from_numpy(self._tokens))
        step.pos.copy_(torch.from_numpy(self._pos))
        logits = step.run()
        if self.faults is not None:
            stall = self.faults.fire("decode_stall")
            if stall is not None:
                time.sleep(stall.payload)
            if self.faults.fire("decode_logits") is not None:
                logits = torch.full_like(logits, torch.nan)
        if self.watch_logits and not bool(torch.isfinite(logits).all()):
            # raise BEFORE any token is absorbed: the supervisor's restore
            # rolls the poisoned step's cache writes back, and no request
            # ever sees a garbage token
            raise NonFiniteLogits(
                f"decode step {self.stats['decode_steps']} produced "
                f"non-finite logits", site="decode_logits")
        nxt = self._select(logits)
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

    # ------------------------------------------------------ wave scheduler
    def _next_wave(self) -> list[Request]:
        """Pop up to batch_slots queued requests sharing one prompt length."""
        if not self.queue:
            return []
        want = len(self.queue[0].prompt)
        wave, rest = [], []
        for r in self.queue:
            if len(r.prompt) == want and len(wave) < self.cfg.batch_slots:
                wave.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return wave

    def _serve_wave(self, wave: list[Request]) -> int:
        """Prefill + decode one wave; returns the decode steps executed."""
        S = len(wave[0].prompt)
        B = self.cfg.batch_slots
        prompts = np.zeros((B, S), np.int64)
        for slot, req in enumerate(wave):
            prompts[slot] = np.asarray(req.prompt, np.int64)
        step = self._static_cache("wave", B)
        last = self._prefill(step, prompts)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += S * len(wave)
        self.stats["vtime"] += S        # work units: batched ≈ one B=1 pass
        nxt = self._select(last)
        for slot, req in enumerate(wave):
            self._absorb(req, int(nxt[slot]))
        horizon = min(max(r.max_new for r in wave) - 1,
                      self.cfg.max_len - S - 1)
        steps = 0
        for t in range(horizon):
            if all(r.done for r in wave):
                break                       # early finishers end the wave
            step.tokens.copy_(torch.from_numpy(nxt.reshape(B, 1)))
            step.pos.fill_(S + t)
            nxt = self._select(step.run())
            self.stats["decode_steps"] += 1
            self.stats["busy_slot_steps"] += sum(1 for r in wave
                                                 if not r.done)
            self.stats["vtime"] += 1
            for slot, req in enumerate(wave):
                self._absorb(req, int(nxt[slot]))
            steps += 1
        return steps

    # ----------------------------------------------------------- ckpt hooks
    @staticmethod
    def _req_state(req: Request | None) -> dict | None:
        # on_token is dropped: callbacks do not serialize; a restored server
        # re-attaches streams (the supervisor does, behind its high-water
        # mark)
        if req is None:
            return None
        return {"uid": int(req.uid),
                "prompt": np.asarray(req.prompt, np.int64).copy(),
                "max_new": int(req.max_new),
                "out": [int(t) for t in req.out],
                "done": bool(req.done),
                "t_submit": float(req.t_submit),
                "t_first": float(req.t_first),
                "t_done": float(req.t_done),
                "deadline_s": float(req.deadline_s),
                "error": str(req.error)}

    @staticmethod
    def _req_from_state(st: dict | None) -> Request | None:
        if st is None:
            return None
        return Request(uid=int(st["uid"]),
                       prompt=np.asarray(st["prompt"], np.int64).copy(),
                       max_new=int(st["max_new"]),
                       out=[int(t) for t in st["out"]],
                       done=bool(st["done"]),
                       t_submit=float(st.get("t_submit", -1.0)),
                       t_first=float(st.get("t_first", -1.0)),
                       t_done=float(st.get("t_done", -1.0)),
                       deadline_s=float(st.get("deadline_s", 0.0)),
                       error=str(st.get("error", "")))

    def snapshot(self) -> dict:
        """Full engine state for preempt/resume.

        ``device`` holds **host copies** — the cache as a tree of CPU
        tensors, the tokens and positions as numpy, the generator's state —
        so the snapshot neither aliases the live cache (written in place by
        every step) nor holds device memory, and pickles as it is;
        ``slots``/``queue``/``finished`` are request bookkeeping and
        ``stats`` the serving counters.  ``restore`` on a fresh engine (same
        model, params and config) continues bit-identically.
        """
        return {
            "scheduler": self.cfg.scheduler,
            "batch_slots": self.cfg.batch_slots,
            "max_len": self.cfg.max_len,
            "paged": self.cfg.paged,
            "page_size": self.cfg.page_size if self.cfg.paged else 0,
            "num_pages": self._num_pages if self.cfg.paged else 0,
            "pager": None if self.pager is None else self.pager.snapshot(),
            "device": {
                "cache": (None if self._cache is None
                          else _copy_tree(self._cache, "cpu")),
                "tokens": self._tokens.copy(),
                "pos": self._pos.copy(),
                "rng": self.gen.get_state().clone(),
            },
            "slots": [self._req_state(r) for r in self._slots],
            "queue": [self._req_state(r) for r in self.queue],
            "finished": [self._req_state(r) for r in self.finished],
            "stats": dict(self.stats),
        }

    def restore(self, snap: dict) -> None:
        """Rebuild engine state from ``snapshot()`` output; the snapshot
        stays intact (its tensors are copied, not adopted), so one snapshot
        restores any number of times.

        Requests still waiting for their first token get ``t_submit``
        re-stamped: ``perf_counter`` epochs do not transfer across
        processes, and mixing them would poison time-to-first-token.
        """
        if snap["scheduler"] != self.cfg.scheduler:
            raise ValueError(
                f"snapshot from scheduler={snap['scheduler']!r} cannot "
                f"restore into scheduler={self.cfg.scheduler!r}")
        for field in ("batch_slots", "max_len"):
            if snap.get(field, getattr(self.cfg, field)) != \
                    getattr(self.cfg, field):
                raise ValueError(
                    f"snapshot {field}={snap[field]} does not match engine "
                    f"{field}={getattr(self.cfg, field)} — the resident "
                    f"cache geometry must be identical")
        if bool(snap.get("paged", False)) != self.cfg.paged:
            raise ValueError(
                f"snapshot paged={snap.get('paged', False)} does not match "
                f"engine paged={self.cfg.paged} — cache layouts differ")
        if self.cfg.paged and snap.get("page_size") != self.cfg.page_size:
            raise ValueError(
                f"snapshot page_size={snap.get('page_size')} does not match "
                f"engine page_size={self.cfg.page_size}")
        if self.cfg.paged and \
                snap.get("num_pages", self._num_pages) != self._num_pages:
            raise ValueError(
                f"snapshot num_pages={snap.get('num_pages')} does not match "
                f"engine num_pages={self._num_pages} — page ids in the "
                f"snapshot would mis-index this pool")
        if self.pager is not None:
            self.pager.restore(snap["pager"])    # marks the tables dirty
        dev = snap["device"]
        if self._cache is not None:
            # the compiled decode step holds the live buffers: write the
            # snapshot (or, from a snapshot taken before any admission, a
            # fresh cache) into them
            fill_(self._cache, self._new_cache() if dev["cache"] is None
                       else dev["cache"])
        elif dev["cache"] is not None:
            self._cache = _copy_tree(dev["cache"], self.model.device)
            self._share_tables()
        self._tokens = np.array(dev["tokens"], np.int64)
        self._pos = np.array(dev["pos"], np.int64)
        self.gen.set_state(dev["rng"])
        self._slots = [self._req_from_state(s) for s in snap["slots"]]
        self.queue = [self._req_from_state(s) for s in snap["queue"]]
        self.finished = [self._req_from_state(s) for s in snap["finished"]]
        now = time.perf_counter()
        for req in [*self._slots, *self.queue]:
            if req is not None and not req.done and req.t_first < 0:
                req.t_submit = now
        self.stats = dict(snap["stats"])
