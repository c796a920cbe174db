"""Data pipeline: synthetic calibration + training streams, the offline
stand-in for C4/WikiText-2 (port of ``repro.data``)."""
from repro_torch.data.pipeline import (
    CalibrationStream,
    SyntheticCorpus,
    TrainStream,
    calibration_batches,
)

__all__ = [
    "CalibrationStream",
    "SyntheticCorpus",
    "TrainStream",
    "calibration_batches",
]
