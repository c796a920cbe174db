"""Batched serving engine — continuous (slot-level) batching over fixed
slots and a contiguous resident KV cache (port of ``repro/serve/engine.py``,
continuous scheduler, greedy decoding).

Every slot carries its own position, so requests of any length decode packed
in one (B_slots, 1) step.  A queued request is admitted into a free slot by
prefilling it at B=1 into a fresh single-row cache — a sequential decode
over the prompt, as the JAX engine prefills — and the row is then written
into its slot of the resident cache in place.  A finished slot is freed and
re-admits from the queue before the next step.  Idle slots keep re-decoding
their last token at a frozen position: the writes land on their own row
only, so each active row's tokens are those of serving it alone at B=1.
In an MoE layer the idle rows route through ``moe_ffn`` like the others.
That holds the B=1 equivalence only while no expert overflows: a token
takes at most one slot per expert, so an expert holds at most B rows, and
the capacity is at least 8 — with B ≤ 8 slots nothing is dropped.  Above
8 slots a batch-mate (idle or not) can push a row's assignment past the
capacity, as in the JAX engine.

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
from repro_torch.models import layers as L


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

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {self.batch_slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")


class ServingEngine:
    def __init__(self, model, params, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.params = params         # NmCompressed leaves stay compressed
        self.nm_kernel = NmKernelConfig(impl=cfg.nm_impl)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.stats = {"decode_steps": 0, "busy_slot_steps": 0,
                      "prefills": 0, "prefill_tokens": 0}
        self._slots: list[Request | None] = [None] * cfg.batch_slots
        self._cache = None
        self._tokens = np.zeros((cfg.batch_slots, 1), np.int64)
        self._pos = np.zeros((cfg.batch_slots,), np.int64)

    # ----------------------------------------------------------- helpers
    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.copy()).to(self.model.device)

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
    def _retire(self, slot: int) -> None:
        self.finished.append(self._slots[slot])
        self._slots[slot] = None
        # _pos[slot] keeps its last (< max_len) value: the freed slot keeps
        # re-decoding idempotently until the next admission overwrites it

    def _prefill(self, tokens: np.ndarray):
        """Sequential decode over the prompt at B=1 into a fresh row cache
        → (row cache, last logits (1, V))."""
        row = self.model.init_cache(1, self.cfg.max_len)
        toks = self._device(tokens.reshape(1, -1))
        logits = None
        for i in range(toks.shape[1]):
            logits, row = self.model.decode_step(self.params, row,
                                                 toks[:, i:i + 1], i)
        return row, logits[:, -1, :]

    def _write_slot(self, row: dict, slot: int) -> None:
        """Copy a B=1 row cache into row ``slot`` of the resident cache, in
        place — the whole row, so a stale tail is re-zeroed.  Every tensor
        field of every cache kind (GQA k/v + pos_ids, MLA latents + length,
        the int8 payloads and their scales) is batch-leading."""
        for i, layer in row.items():
            full = self._cache[i]
            for f in dataclasses.fields(full):
                dst = getattr(full, f.name)
                if isinstance(dst, torch.Tensor):
                    dst[slot] = getattr(layer, f.name)[0]

    def _admit_into(self, slot: int) -> None:
        """Prefill the queue head into ``slot``."""
        req = self.queue.pop(0)
        if self._cache is None:
            self._cache = self.model.init_cache(self.cfg.batch_slots,
                                                self.cfg.max_len)
        prompt = np.asarray(req.prompt, np.int64)
        S = len(prompt)
        row, last = self._prefill(prompt)
        self._write_slot(row, slot)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += S
        self._slots[slot] = req
        tok = int(torch.argmax(last, dim=-1)[0])
        self._absorb(req, tok)
        self._tokens[slot, 0] = tok
        self._pos[slot] = S
        if req.done or S + 1 >= self.cfg.max_len:
            req.done = True
            self._retire(slot)          # freed — the caller retries the queue

    def _admit(self) -> bool:
        """Fill free slots from the queue before the next decode step."""
        admitted = False
        for slot in range(self.cfg.batch_slots):
            while self._slots[slot] is None and self.queue:
                self._admit_into(slot)
                admitted = True
        return admitted

    def _continuous_step(self) -> bool:
        admitted = self._admit()
        active = [s for s in self._slots if s is not None]
        if not active:
            return admitted
        logits, self._cache = self.model.decode_step(
            self.params, self._cache, self._device(self._tokens),
            self._device(self._pos))
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["busy_slot_steps"] += len(active)
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
        return True
