"""Supervised serving: crash recovery, retries, and graceful degradation
(port of ``repro/serve/supervisor.py``).

The :class:`Supervisor` wraps a continuous-scheduler :class:`ServingEngine`
with a health state machine::

    HEALTHY ──fault──▶ RECOVERING ──restored──▶ DEGRADED ──N clean pumps──▶ HEALTHY
                            │
             budget exhausted▼
                        EngineDown (raised)

Every ``snapshot_every`` scheduling quanta the supervisor captures the
engine's full ``snapshot()`` (host copies of the cache, tokens, positions
and generator state; optionally pickled to ``snapshot_dir`` atomically).  When a
pump faults — an exception out of the engine/pager, non-finite logits from
the decode watchdog (``engine.watch_logits``), or a step overrunning
``step_deadline_s`` — the supervisor rolls the engine back to the last
good snapshot and **replays**: requests submitted after the snapshot are
re-submitted from the supervisor's ledger, streaming callbacks are
re-attached behind a per-request high-water mark (so a client never sees
a token twice), and greedy decode makes the replay **bitwise identical**
to the unfaulted run — the recovery guarantee tests assert equality with
the batch=1 oracle, not merely "didn't crash".

Fault attribution is per-request: a decode-step fault implicates every
resident request, an admission fault implicates the request being
prefilled.  A request implicated ``retry_budget`` times is *quarantined* —
failed alone (``error="quarantined"``) instead of poisoning the batch
forever.  Consecutive recoveries back off exponentially (capped) and a
``max_consecutive_recoveries`` budget turns a permanently wedged engine
into a raised :class:`EngineDown` instead of an infinite rollback loop.

After every recovery the pager's refcount audit (``Pager.check()``) runs,
so a restore that leaks or double-frees pages surfaces immediately as a
structured ``PagerAuditError`` naming the page.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time

from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.faults import (EngineDown, EngineFault, FaultPlan,
                                      SnapshotWriteError,
                                      StepDeadlineExceeded)
from repro_torch.serve.pager import PoolExhausted
from repro_torch.util.io import atomic_write_bytes

HEALTHY = "healthy"
DEGRADED = "degraded"
RECOVERING = "recovering"


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    snapshot_every: int = 8        # pumps between periodic snapshots
    retry_budget: int = 3          # faults a request survives before quarantine
    backoff_base_s: float = 0.0    # capped exponential backoff between
    backoff_cap_s: float = 0.25    # consecutive recoveries (0 base = none)
    step_deadline_s: float = 0.0   # watchdog: max seconds per pump (0 = off)
    # deadline-exempt first pumps: on a card the engine captures its CUDA
    # graphs (B = 1 and B = slots) in its first pump that admits and
    # decodes, as JAX's engine compiles in its first; a rollback replays
    # the same graphs against the restored buffers and captures nothing
    warmup_pumps: int = 2
    healthy_after: int = 4         # clean pumps for DEGRADED -> HEALTHY
    max_consecutive_recoveries: int = 8   # then EngineDown
    snapshot_dir: str = ""         # optional on-disk snapshot persistence
    audit_after_recovery: bool = True     # run Pager.check() post-restore

    def __post_init__(self):
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, "
                             f"got {self.snapshot_every}")
        if self.retry_budget < 1:
            raise ValueError(f"retry_budget must be >= 1, "
                             f"got {self.retry_budget}")
        if self.max_consecutive_recoveries < 1:
            raise ValueError("max_consecutive_recoveries must be >= 1")


class Supervisor:
    """Health-supervised wrapper around a continuous ServingEngine."""

    def __init__(self, engine: ServingEngine,
                 cfg: SupervisorConfig = SupervisorConfig(),
                 *, faults: FaultPlan | None = None):
        if engine.cfg.scheduler != "continuous":
            raise ValueError(
                "supervision needs the continuous scheduler: wave batches "
                "are not snapshottable mid-wave, so rollback cannot replay "
                "them")
        self.engine = engine
        self.cfg = cfg
        self.state = HEALTHY
        self.faults = faults
        engine.arm_faults(faults)
        engine.watch_logits = True           # decode watchdog
        # ledger: every request ever submitted, by uid — rollback replays
        # from here; results: first completion wins (replays are bitwise
        # identical under greedy, so "first" is also "only" semantically)
        self._ledger: dict[int, dict] = {}
        self._on_token: dict[int, object] = {}
        self._delivered: dict[int, int] = {}
        self._results: dict[int, Request] = {}
        self.retries: dict[int, int] = {}    # uid -> faults survived
        self.quarantined: list[int] = []
        self.stats = {"recoveries": 0, "faults": {}, "snapshots": 0,
                      "snapshot_write_failures": 0, "replayed_requests": 0,
                      "quarantined": 0, "backoff_s": 0.0,
                      "rollback_decode_steps": 0}
        self._pumps_since_snap = 0
        self._clean_pumps = 0
        self._consecutive = 0
        self._total_pumps = 0
        self._snap = engine.snapshot()       # genesis rollback point
        try:
            self._persist_snapshot(self._snap)
        except (OSError, SnapshotWriteError) as exc:
            # the in-memory genesis snapshot is intact; persistence is
            # best-effort from the very first capture on
            self.stats["snapshot_write_failures"] += 1
            self._note_fault(exc)

    # --------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        """Admit a request under supervision.  The original ``Request``
        object is mutated by the engine as usual, but after a rollback the
        engine continues on an internal clone — read results from
        ``run()``/``results()``, not from the submitted object."""
        uid = int(req.uid)
        self._ledger[uid] = {
            "prompt": req.prompt, "max_new": req.max_new,
            "deadline_s": req.deadline_s}
        if req.on_token is not None:
            self._on_token[uid] = req.on_token
        self._delivered.setdefault(uid, 0)
        req.on_token = self._wrap_on_token(uid)
        self.engine.submit(req)

    def _wrap_on_token(self, uid: int):
        orig = self._on_token.get(uid)

        def cb(req: Request, tok: int) -> None:
            # exactly-once delivery across rollbacks: replayed tokens are
            # bitwise the already-delivered ones, so skipping to the
            # high-water mark loses nothing
            if len(req.out) > self._delivered[uid]:
                self._delivered[uid] = len(req.out)
                if orig is not None:
                    orig(req, tok)
        return cb

    # ----------------------------------------------------------- main loop
    def pump(self) -> bool:
        """One supervised scheduling quantum.  Faults are absorbed here:
        the caller only ever sees ``EngineDown`` (recovery budget spent)
        or a failed post-recovery audit."""
        t0 = time.perf_counter()
        try:
            busy = self.engine.pump()
            dt = time.perf_counter() - t0
            if (self.cfg.step_deadline_s > 0
                    and self._total_pumps >= self.cfg.warmup_pumps
                    and dt > self.cfg.step_deadline_s):
                raise StepDeadlineExceeded(
                    f"pump took {dt:.3f}s > step deadline "
                    f"{self.cfg.step_deadline_s:.3f}s", site="decode_stall")
        except (EngineFault, PoolExhausted) as exc:
            self._recover(exc)
            return True
        self._total_pumps += 1
        self._consecutive = 0
        self._harvest()
        self._clean_pumps += 1
        if self.state == DEGRADED and \
                self._clean_pumps >= self.cfg.healthy_after:
            self.state = HEALTHY
        if busy:
            self._pumps_since_snap += 1
            if self._pumps_since_snap >= self.cfg.snapshot_every:
                self.checkpoint()
        return busy

    def run(self, *, max_steps: int = 100_000) -> list[Request]:
        """Drain queue and slots under supervision; returns every finished
        request (including quarantined/cancelled ones) in uid order."""
        steps = 0
        while steps < max_steps and self.pump():
            steps += 1
        self._harvest()
        return self.results()

    def results(self) -> list[Request]:
        return sorted(self._results.values(), key=lambda r: r.uid)

    def idle(self) -> bool:
        return self.engine.idle()

    def _harvest(self) -> None:
        """Move engine completions into the supervisor's results, first
        completion per uid winning (rollback replays re-finish uids the
        caller already saw; under greedy those replays are identical)."""
        if not self.engine.finished:
            return
        for r in self.engine.finished:
            if r.uid not in self._results:
                self._results[r.uid] = r
        self.engine.finished.clear()

    # ---------------------------------------------------------- snapshotting
    def checkpoint(self) -> None:
        """Capture a new rollback point (and optionally persist it).  A
        persistence failure keeps the previous snapshot as the rollback
        point and degrades instead of crashing."""
        snap = self.engine.snapshot()
        try:
            self._persist_snapshot(snap)
        except (OSError, SnapshotWriteError) as exc:
            self.stats["snapshot_write_failures"] += 1
            self._note_fault(exc)
            self.state = DEGRADED
            self._clean_pumps = 0
            return                      # keep the old (persisted) snapshot
        self._snap = snap
        self._pumps_since_snap = 0
        self.stats["snapshots"] += 1

    def _persist_snapshot(self, snap: dict) -> None:
        if self.faults is not None and \
                self.faults.fire("snapshot_write") is not None:
            raise SnapshotWriteError("injected snapshot write failure",
                                     site="snapshot_write")
        if self.cfg.snapshot_dir:
            path = os.path.join(self.cfg.snapshot_dir, "snapshot.pkl")
            # atomic (tmp + fsync + replace): no torn snapshot on crash
            atomic_write_bytes(path, pickle.dumps(snap))

    # ------------------------------------------------------------- recovery
    def _note_fault(self, exc: Exception) -> None:
        key = type(exc).__name__
        self.stats["faults"][key] = self.stats["faults"].get(key, 0) + 1

    def _implicated(self, exc: Exception) -> list[int]:
        uid = getattr(exc, "uid", -1)
        if uid >= 0:
            return [uid]
        # decode/pager faults: every resident request was in the batch
        return [r.uid for r in self.engine._slots if r is not None]

    def _recover(self, exc: Exception) -> None:
        self.state = RECOVERING
        self._note_fault(exc)
        self.stats["recoveries"] += 1
        self._consecutive += 1
        if self._consecutive > self.cfg.max_consecutive_recoveries:
            raise EngineDown(
                f"gave up after {self._consecutive - 1} consecutive failed "
                f"recoveries (last fault: {type(exc).__name__}: {exc})"
            ) from exc
        implicated = self._implicated(exc)
        for uid in implicated:
            self.retries[uid] = self.retries.get(uid, 0) + 1
        eng = self.engine
        self.stats["rollback_decode_steps"] += max(
            0, eng.stats["decode_steps"]
            - self._snap["stats"]["decode_steps"])

        eng.restore(self._snap)
        # uids the caller already saw complete must not become resident
        # again (per-slot independence: removing them changes no other
        # request's tokens); their replay is redundant by bit-parity
        for uid in self._results:
            eng.cancel(uid)
        # requests submitted after the snapshot vanished with the rollback:
        # replay them from the ledger (fresh clones — the originals carry
        # post-snapshot state)
        present = {r.uid for r in eng.queue}
        present |= {r.uid for r in eng._slots if r is not None}
        present |= {r.uid for r in eng.finished}
        for uid, spec in self._ledger.items():
            if uid in present or uid in self._results:
                continue
            eng.submit(Request(uid, spec["prompt"], max_new=spec["max_new"],
                               deadline_s=spec["deadline_s"]),
                       force=True)
            self.stats["replayed_requests"] += 1
        # re-attach streaming callbacks (snapshot() drops them by contract)
        for req in (*eng.queue, *(r for r in eng._slots if r is not None)):
            if not req.done:
                req.on_token = self._wrap_on_token(req.uid)
        # quarantine: a request implicated retry_budget times is failed
        # alone instead of poisoning every future batch
        for uid in implicated:
            if self.retries[uid] >= self.cfg.retry_budget and \
                    uid not in self.quarantined and \
                    uid not in self._results:
                eng.cancel(uid, error="quarantined")
                self.quarantined.append(uid)
                self.stats["quarantined"] += 1
        self._harvest()
        if self.cfg.audit_after_recovery and eng.pager is not None:
            eng.pager.check()           # PagerAuditError names the page
        if self.cfg.backoff_base_s > 0:
            delay = min(self.cfg.backoff_base_s * 2 ** (self._consecutive - 1),
                        self.cfg.backoff_cap_s)
            self.stats["backoff_s"] += delay
            time.sleep(delay)
        self._clean_pumps = 0
        self.state = DEGRADED

    # ------------------------------------------------------------ lifecycle
    def drain(self, *, timeout_s: float = 30.0) -> bool:
        """Finish in-flight work without admitting from outside: pump until
        idle or timeout.  Returns True when fully drained."""
        t0 = time.perf_counter()
        while not self.engine.idle():
            if time.perf_counter() - t0 > timeout_s:
                return False
            self.pump()
        self._harvest()
        return True

    def health(self) -> dict:
        eng = self.engine
        return {
            "state": self.state,
            "ok": self.state in (HEALTHY, DEGRADED),
            "queued": len(eng.queue),
            "active": sum(r is not None for r in eng._slots),
            "recoveries": self.stats["recoveries"],
            "quarantined": self.stats["quarantined"],
            "snapshot_age_pumps": self._pumps_since_snap,
        }
