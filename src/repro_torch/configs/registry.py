"""Architecture registry of the port: every arch of the JAX registry, in
its order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: tuple[str, ...] = ("gemma3-1b", "h2o-danube-1.8b", "mistral-large-123b",
                          "tinyllama-1.1b", "whisper-medium",
                          "deepseek-v3-671b", "qwen3-moe-30b-a3b",
                          "zamba2-7b", "internvl2-76b", "xlstm-1.3b")

_MODULES = {"gemma3-1b": "gemma3_1b",
            "h2o-danube-1.8b": "h2o_danube_1_8b",
            "mistral-large-123b": "mistral_large_123b",
            "tinyllama-1.1b": "tinyllama_1_1b",
            "whisper-medium": "whisper_medium",
            "deepseek-v3-671b": "deepseek_v3_671b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "zamba2-7b": "zamba2_7b",
            "internvl2-76b": "internvl2_76b",
            "xlstm-1.3b": "xlstm_1_3b"}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG
