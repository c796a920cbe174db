"""Model factory + the generic Alg.-3 pruning adapter (port of
``repro/models/model_builder.py``)."""
from __future__ import annotations

from typing import Any

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm_lm import XlstmLM

_FAMILIES = {"dense": TransformerLM, "moe": TransformerLM, "vlm": TransformerLM,
             "encdec": EncDecLM, "hybrid": HybridLM, "ssm": XlstmLM}


def build_model(cfg, *, device="cuda"):
    """Build the family's model on ``device``."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, device=device)


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
