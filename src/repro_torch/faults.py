"""Deterministic fault injection — the shared core for serving AND pruning
(the port's own copy of ``repro/faults.py``; plans serialize to the same
JSON bytes).

A ``FaultPlan`` is a seedable, serializable schedule of faults fired at
**named sites** threaded through the serving stack (engine, pager,
supervisor, SSE front-end) and the prune-job runtime (calibration loop,
Hessian accumulation, Cholesky factorization, journal writes).  Every
site is a zero-cost no-op until a plan is armed — the call sites guard on
``faults is not None`` before doing any work, so the unfaulted hot path
pays one attribute load per step and nothing else.

Serving sites (who fires them, and what the armed effect is):

  ``decode_logits``   engine, after each decode step — logits become NaN
                      (the watchdog must catch them *before* a garbage
                      token is absorbed).
  ``decode_stall``    engine, per decode step — sleeps ``payload`` seconds
                      so the supervisor's step deadline trips.
  ``prefill``         engine, at admission (before any state mutation) —
                      raises :class:`DeviceOom`, shaped like a device
                      allocation failure.
  ``pager_fault_in``  pager, inside ``fault_in`` — raises
                      ``PoolExhausted``; a long enough burst defeats the
                      engine's preempt-and-retry loop and escapes to the
                      supervisor.
  ``snapshot_write``  supervisor, while persisting a periodic snapshot —
                      raises :class:`SnapshotWriteError`; the supervisor
                      keeps the last good snapshot and degrades.
  ``sse_stall``       front-end, between streamed events — sleeps
                      ``payload`` seconds per firing, emulating a stalled
                      client/egress link.

Prune sites (fired by ``core/schedule.prune_model`` / ``core/jobs.PruneJob``):

  ``calib_batch``     pass-1 calibration loop, once per (block, batch)
                      forward — raises :class:`CalibrationError`,
                      emulating a data-loader/device crash mid-pass-1
                      (drives the journal's crash/resume path).
  ``hessian_accum``   once per per-layer accumulator update — the
                      activation batch is replaced with NaNs *before*
                      accumulation, so the ``HessianAccumulator``
                      non-finite-batch guard must absorb it (the skip is
                      visible in ``LayerReport.calib_skipped``).
  ``cholesky``        once per solve attempt in ``prune_layer_guarded``
                      — the attempt is treated as a failed (singular)
                      factorization, driving the adaptive-damping
                      escalation and ``on_singular`` policies without
                      having to craft a pathological Hessian.
  ``journal_write``   once per layer-journal record — raises
                      :class:`JournalWriteError` *before* anything is
                      written, killing the job at a layer boundary
                      (resume must redo exactly that layer).

Trigger model: each site has a monotonically increasing invocation
counter owned by the plan (it deliberately does NOT roll back with the
engine — a replayed step must not re-fire the fault that caused the
rollback, or recovery could never converge).  A spec fires when

  * ``at`` is non-empty: the site's invocation index lies in
    ``[a, a + count)`` for some ``a`` in ``at`` (bursts of ``count``
    consecutive invocations per entry), and ``uid`` (when >= 0) matches;
  * ``at`` is empty and ``uid >= 0``: every invocation whose uid matches,
    up to ``count`` total firings (0 = unlimited) — the *poison request*
    shape;
  * ``at`` is empty and ``prob > 0``: a seeded Bernoulli draw per
    invocation, up to ``count`` total firings (0 = unlimited).

Plans round-trip through JSON (``to_json``/``from_json``) and a compact
CLI string (``parse``): ``"decode_logits@5;pager_fault_in@7x6;prefill~3"``
means NaN logits at decode invocation 5, a 6-call pool-exhaustion burst
starting at fault-in invocation 7, and an OOM on every admission of uid 3.
``repro_torch.serve.faults`` re-exports everything here unchanged.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

SERVE_SITES = ("decode_logits", "decode_stall", "prefill", "pager_fault_in",
               "snapshot_write", "sse_stall")
PRUNE_SITES = ("calib_batch", "hessian_accum", "cholesky", "journal_write")
SITES = SERVE_SITES + PRUNE_SITES


# --------------------------------------------------------------------------
# fault taxonomy — what the serve supervisor / prune job catches
# --------------------------------------------------------------------------
class EngineFault(RuntimeError):
    """Base class for recoverable serving faults.  ``site`` names the
    injection/detection point; ``uid`` (>= 0) names the implicated
    request when the fault is attributable to one."""

    def __init__(self, msg: str, *, site: str = "", uid: int = -1):
        super().__init__(msg)
        self.site = site
        self.uid = uid


class InjectedFault(EngineFault):
    """A fault raised by an armed :class:`FaultPlan`."""


class DeviceOom(InjectedFault):
    """OOM-shaped allocation failure (an injected out-of-memory)."""


class SnapshotWriteError(InjectedFault):
    """Persisting a periodic snapshot failed."""


class NonFiniteLogits(EngineFault):
    """The decode step produced NaN/Inf logits (watchdog detection)."""


class StepDeadlineExceeded(EngineFault):
    """A scheduling quantum overran the supervisor's step deadline."""


class EngineDown(RuntimeError):
    """The supervisor exhausted its consecutive-recovery budget."""


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at capacity.

    ``retry_after_s`` is the caller-facing backoff hint (load shedding
    rejects new work instead of evicting resident work)."""

    def __init__(self, msg: str, *, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


# ----------------------------------------------------------- prune faults
class CalibrationError(InjectedFault):
    """A calibration batch forward failed mid-pass-1 (``calib_batch``)."""


class JournalWriteError(InjectedFault):
    """Persisting a prune-job journal record failed (``journal_write``)."""


class SingularHessian(RuntimeError):
    """The damped calibration Hessian could not be factorized (or the OBS
    solve went non-finite) and the layer's ``on_singular`` policy said
    fail.  ``attempts`` counts the solve attempts that were tried —
    under ``on_singular="escalate"`` each attempt multiplied the damping
    by 10×."""

    def __init__(self, msg: str, *, path: str = "", attempts: int = 0):
        super().__init__(msg)
        self.path = path
        self.attempts = attempts


class InsufficientCalibration(RuntimeError):
    """A layer's Hessian accumulator closed with fewer calibration tokens
    than the job's minimum-sample guard demands (all batches skipped as
    non-finite, or a misconfigured calibration stream)."""


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    at: tuple[int, ...] = ()   # site invocation indices (burst starts)
    count: int = 1             # burst length (at) / total-firings cap (else)
    uid: int = -1              # >= 0: only fire for this request uid
    prob: float = 0.0          # at == (): Bernoulli rate per invocation
    payload: float = 0.0       # site-specific (stall seconds)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {', '.join(SITES)}")
        if any(a < 0 for a in self.at):
            raise ValueError(f"negative invocation index in at={self.at}")
        if self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.at and self.count < 1:
            raise ValueError("at-scheduled specs need count >= 1 (burst)")
        if not self.at and self.uid < 0 and self.prob <= 0.0:
            raise ValueError(
                "spec never fires: needs at=, uid=, or prob= "
                f"(site {self.site!r})")

    def to_dict(self) -> dict:
        return {"site": self.site, "at": list(self.at), "count": self.count,
                "uid": self.uid, "prob": self.prob, "payload": self.payload}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        unknown = set(d) - {"site", "at", "count", "uid", "prob", "payload"}
        if unknown:
            raise ValueError(f"unknown FaultSpec keys {sorted(unknown)}")
        return cls(site=d["site"], at=tuple(int(a) for a in d.get("at", ())),
                   count=int(d.get("count", 1)), uid=int(d.get("uid", -1)),
                   prob=float(d.get("prob", 0.0)),
                   payload=float(d.get("payload", 0.0)))


class FaultPlan:
    """A deterministic schedule of :class:`FaultSpec` firings.

    ``fire(site, uid=)`` advances the site's invocation counter and
    returns the first triggered spec (or None).  Counters and the seeded
    RNG are plan-owned and monotonic — engine rollback never rewinds
    them, so an injected fault is consumed exactly once.
    """

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...] = (),
                 *, seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self.invocations: dict[str, int] = {s: 0 for s in SITES}
        self.fired: list[dict] = []        # {"site", "index", "uid", "spec"}
        self._rng = np.random.default_rng(self.seed)
        self._firings = [0] * len(self.specs)   # total firings per spec

    # ------------------------------------------------------------- firing
    def fire(self, site: str, *, uid: int = -1) -> FaultSpec | None:
        idx = self.invocations[site]
        self.invocations[site] = idx + 1
        hit = None
        for j, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.uid >= 0 and spec.uid != uid:
                continue
            if spec.at:
                if not any(a <= idx < a + spec.count for a in spec.at):
                    continue
            elif spec.prob > 0.0:
                if spec.count and self._firings[j] >= spec.count:
                    continue
                # one draw per eligible invocation keeps the stream
                # deterministic in (seed, call sequence)
                if float(self._rng.random()) >= spec.prob:
                    continue
            else:                           # uid-targeted, at == ()
                if spec.count and self._firings[j] >= spec.count:
                    continue
            if hit is None:
                hit = spec
                self._firings[j] += 1
        if hit is not None:
            self.fired.append({"site": site, "index": idx, "uid": uid,
                               "spec": hit.to_dict()})
        return hit

    def fired_by_site(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.fired:
            out[f["site"]] = out.get(f["site"], 0) + 1
        return out

    # ------------------------------------------------------------ serde
    def to_json(self) -> str:
        return json.dumps({"version": 1, "seed": self.seed,
                           "specs": [s.to_dict() for s in self.specs]},
                          indent=1)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        if d.get("version") != 1:
            raise ValueError(f"unsupported fault-plan version "
                             f"{d.get('version')!r}")
        unknown = set(d) - {"version", "seed", "specs"}
        if unknown:
            raise ValueError(f"unknown fault-plan keys {sorted(unknown)}")
        return cls([FaultSpec.from_dict(s) for s in d["specs"]],
                   seed=int(d.get("seed", 0)))

    @classmethod
    def parse(cls, text: str, *, seed: int = 0) -> "FaultPlan":
        """Compact CLI syntax: ``site@start[xburst][~uid][+payload]``
        entries separated by ``;`` — e.g.
        ``decode_logits@5;pager_fault_in@7x6;prefill~3;sse_stall@0+0.5``.
        ``site@start`` fires once at that site invocation; ``xburst``
        widens it to a burst; ``~uid`` restricts (or, with no ``@``,
        targets every admission of) that uid; ``+payload`` attaches a
        float payload (stall seconds)."""
        specs = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            payload = 0.0
            if "+" in raw:
                raw, _, p = raw.partition("+")
                payload = float(p)
            uid = -1
            if "~" in raw:
                raw, _, u = raw.partition("~")
                uid = int(u)
            at: tuple[int, ...] = ()
            count = 1
            if "@" in raw:
                raw, _, a = raw.partition("@")
                if "x" in a:
                    a, _, c = a.partition("x")
                    count = int(c)
                at = (int(a),)
            elif uid >= 0:
                count = 0                   # persistent poison request
            specs.append(FaultSpec(site=raw.strip(), at=at, count=count,
                                   uid=uid, payload=payload))
        return cls(specs, seed=seed)

    @classmethod
    def load(cls, path_or_spec: str, *, seed: int = 0) -> "FaultPlan":
        """Load a JSON plan file, or fall back to the compact syntax."""
        if path_or_spec.lstrip().startswith("{"):
            return cls.from_json(path_or_spec)
        try:
            with open(path_or_spec) as f:
                return cls.from_json(f.read())
        except (OSError, json.JSONDecodeError):
            return cls.parse(path_or_spec, seed=seed)


__all__ = [
    "SITES", "SERVE_SITES", "PRUNE_SITES",
    "FaultPlan", "FaultSpec",
    "EngineFault", "InjectedFault", "DeviceOom", "SnapshotWriteError",
    "NonFiniteLogits", "StepDeadlineExceeded", "EngineDown", "QueueFull",
    "CalibrationError", "JournalWriteError", "SingularHessian",
    "InsufficientCalibration",
]
