"""Architecture registry of the port (dense Llama and qwen3-moe so far)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: tuple[str, ...] = ("tinyllama-1.1b", "qwen3-moe-30b-a3b")

_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b"}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
