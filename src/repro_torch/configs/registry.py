"""Architecture registry of the port: every arch of the JAX registry but
h2o-danube, mistral-large and the VLM, in the JAX registry's order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: tuple[str, ...] = ("gemma3-1b", "tinyllama-1.1b", "whisper-medium",
                          "deepseek-v3-671b", "qwen3-moe-30b-a3b",
                          "zamba2-7b", "xlstm-1.3b")

_MODULES = {"gemma3-1b": "gemma3_1b",
            "tinyllama-1.1b": "tinyllama_1_1b",
            "whisper-medium": "whisper_medium",
            "deepseek-v3-671b": "deepseek_v3_671b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "zamba2-7b": "zamba2_7b",
            "xlstm-1.3b": "xlstm_1_3b"}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
