"""Learning-rate schedules (port of ``repro/optim/schedules.py``): pure
functions step ↦ 0-d float32 tensor.

The arithmetic is the JAX package's, in float32: the step becomes a float32
tensor, Python constants enter each operation as float32 scalars, and
``cos`` runs in float32.  Expressions keep JAX's grouping so that the
Python-float parts (``0.5 * (peak - floor)``) are computed in double and
rounded once, as there.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear ramp to ``peak`` then linear decay to ``floor``."""

    def f(step):
        s = _f32(step)
        up = peak * s / max(warmup_steps, 1)
        frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        down = peak + (floor - peak) * torch.clamp(frac, 0.0, 1.0)
        return torch.where(s < warmup_steps, up, down)

    return f


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warmup then cosine decay to ``floor`` (LLaMA-style)."""

    def f(step):
        s = _f32(step)
        up = peak * s / max(warmup_steps, 1)
        frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = floor + 0.5 * (peak - floor) * (
            1.0 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
        return torch.where(s < warmup_steps, up, cos)

    return f
