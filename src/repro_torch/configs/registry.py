"""Architecture registry of the port: every arch of the JAX registry, in
its order, and the per-cell input specs (meta tensors, the port's
``ShapeDtypeStruct``).

Skips: ``long_500k`` needs sub-quadratic attention state and is defined
only for the SWA/SSM/hybrid archs; whisper has no long cell.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell

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

# archs with sub-quadratic long-context decode
LONG_CONTEXT_OK = frozenset(
    {"gemma3-1b", "h2o-danube-1.8b", "zamba2-7b", "xlstm-1.3b"})


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> bool:
    if cell.name == "long_500k":
        return cfg.name in LONG_CONTEXT_OK
    return True


def all_cells(include_skipped: bool = False):
    """Yield every (arch, cell) pair of the 10×4 assignment grid."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for cell in SHAPES.values():
            if include_skipped or cell_supported(cfg, cell):
                yield arch, cell


# token and position dtype of the port's batches: int64, what its data
# pipeline, engine and embedding lookups use (the JAX package's is int32)
TOKEN_DTYPE = torch.int64


def _meta(shape, dtype) -> torch.Tensor:
    """The port's ``ShapeDtypeStruct``: a tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract batch inputs for train/prefill cells (meta tensors)."""
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        return {"frames": _meta((B, S, cfg.d_model), cfg.torch_dtype),
                "dec_tokens": _meta((B, cfg.dec_seq), TOKEN_DTYPE)}
    if cfg.family == "vlm":
        n_img = min(cfg.vlm_image_tokens, S // 2)
        return {"tokens": _meta((B, S - n_img), TOKEN_DTYPE),
                "patch_embeds": _meta((B, n_img, cfg.d_model),
                                      cfg.torch_dtype)}
    return {"tokens": _meta((B, S), TOKEN_DTYPE)}


def decode_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract (tokens, pos) for a single decode step with a seq_len-deep
    cache; ``pos`` is per slot, (B,).  Encoder–decoder cells also take
    ``enc_out``: a natural 30 s encoder source (1500 frames)."""
    B = cell.global_batch
    specs = {"tokens": _meta((B, 1), TOKEN_DTYPE),
             "pos": _meta((B,), TOKEN_DTYPE)}
    if cfg.family == "encdec":
        specs["enc_out"] = _meta((B, 1500, cfg.d_model), cfg.torch_dtype)
    return specs


def concrete_batch(cfg: ModelConfig, cell: ShapeCell,
                   generator: "torch.Generator | None" = None,
                   device="cuda") -> dict:
    """A random batch matching ``input_specs``, drawn from ``generator``
    (a generator on ``device``; seed 0 when None): tokens uniform in
    ``[0, vocab)``, floats standard normal — JAX's law, not its values."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    out = {}
    for k, spec in input_specs(cfg, cell).items():
        if spec.dtype == TOKEN_DTYPE:
            out[k] = torch.randint(0, cfg.vocab_size, spec.shape,
                                   generator=gen, device=dev)
        else:
            out[k] = torch.randn(spec.shape, generator=gen, device=dev,
                                 dtype=torch.float32).to(spec.dtype)
    return out
