"""The prune-side exceptions of ``repro/faults.py`` (own copies)."""
from __future__ import annotations


class CalibrationError(RuntimeError):
    """A calibration batch forward failed mid-pass-1."""


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
    than the job's minimum-sample guard demands."""
