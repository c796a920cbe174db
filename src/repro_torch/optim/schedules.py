"""Learning-rate schedules (port of ``repro/optim/schedules.py``): pure
functions step ↦ 0-d float32 tensor, on the step's device (a train step
hands them its counter on the card: they run inside its CUDA graph, so
they read the step from the tensor and never from the host).

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
    def lr_schedule(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=getattr(step, "device", None))

    return lr_schedule


def linear_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear ramp to ``peak`` then linear decay to ``floor``."""

    def lr_schedule(step):
        s = _f32(step)
        up = peak * s / max(warmup_steps, 1)
        frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        down = peak + (floor - peak) * torch.clamp(frac, 0.0, 1.0)
        return torch.where(s < warmup_steps, up, down)

    return lr_schedule


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warmup then cosine decay to ``floor`` (LLaMA-style)."""

    def lr_schedule(step):
        s = _f32(step)
        up = peak * s / max(warmup_steps, 1)
        frac = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = floor + 0.5 * (peak - floor) * (
            1.0 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
        return torch.where(s < warmup_steps, up, cos)

    return lr_schedule
