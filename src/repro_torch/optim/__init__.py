"""Optimizer substrate — AdamW + schedules (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState, clip_by_global_norm
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup
from repro_torch.optim.masked import SparsityPreserving, sparsity_preserving

__all__ = [
    "AdamW", "AdamWState", "clip_by_global_norm",
    "constant", "cosine_warmup", "linear_warmup",
    "SparsityPreserving", "sparsity_preserving",
]
