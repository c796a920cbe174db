"""Model factory + the generic Alg.-3 pruning adapter (port of
``repro/models/model_builder.py``; the dense and MoE families so far)."""
from __future__ import annotations

from typing import Any

from repro_torch.models.transformer import TransformerLM


def build_model(cfg, *, device="cuda"):
    """Build the family's model on ``device``."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"family {cfg.family!r} is not ported yet")
    return TransformerLM(cfg, device=device)


class ModelAdapter:
    """BlockwiseAdapter (core/schedule.py) over a port model."""

    def __init__(self, model):
        self.model = model

    def num_blocks(self, params) -> int:
        return self.model.num_blocks()

    def prepare(self, params, batch) -> Any:
        return self.model.embed_batch(params, batch)

    def block_apply(self, params, i: int, carry, *, capture: bool):
        tape: dict | None = {} if capture else None
        out = self.model.block(params, i, carry, tape=tape)
        return out, (tape or {})

    def block_linear_paths(self, params, i: int):
        return self.model.block_linear_paths(params, i)
