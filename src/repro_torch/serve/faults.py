"""Serving-side view of the shared fault-injection core.

The hook machinery (``FaultPlan``/``FaultSpec``, site registry, exception
taxonomy) lives in :mod:`repro_torch.faults` so the prune-job runtime
(``core/jobs.py``) and the serving stack share one deterministic
injection engine; this module re-exports it unchanged for the serving
imports.  A star import keeps the shim total — names added to the core
propagate without edits here — while ``__all__`` still curates the
serve-facing surface.  See ``repro_torch/faults.py`` for the site
catalogue (serving sites: decode_logits, decode_stall, prefill,
pager_fault_in, snapshot_write, sse_stall) and the trigger model.
"""
from __future__ import annotations

from repro_torch.faults import *  # noqa: F401,F403 — total re-export shim

__all__ = [
    "SITES", "SERVE_SITES", "PRUNE_SITES",
    "FaultPlan", "FaultSpec",
    "EngineFault", "InjectedFault", "DeviceOom", "SnapshotWriteError",
    "NonFiniteLogits", "StepDeadlineExceeded", "EngineDown", "QueueFull",
]
