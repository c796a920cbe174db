"""Architecture registry of the port (dense Llama, qwen3-moe and
deepseek-v3 so far)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: tuple[str, ...] = ("tinyllama-1.1b", "qwen3-moe-30b-a3b",
                          "deepseek-v3-671b")

_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "deepseek-v3-671b": "deepseek_v3_671b"}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
