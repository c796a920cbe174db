"""Model configuration schema — a copy of ``repro/configs/base.py`` with
``torch_dtype`` in place of the JAX ``jdtype``."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # normalization / activation / attention details
    act: str = "silu"
    norm: str = "rmsnorm"
    attn_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0
    sliding_window: int = 0         # 0 = full attention
    global_every: int = 0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    num_dense_layers: int = 0
    capacity_factor: float = 1.25

    # MLA (DeepSeek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid (Mamba2, Zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    attn_every: int = 0
    num_shared_attn: int = 2

    # xLSTM
    xlstm_proj_factor: int = 2
    slstm_every: int = 0

    # enc-dec (Whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0
    dec_seq: int = 448

    # VLM
    vlm_image_tokens: int = 256

    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""        # "" = model dtype; "int8" = quantized

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def uses_mla(self) -> bool:
        return self.kv_lora_rank > 0

    def layer_is_global(self, i: int) -> bool:
        """SWA schedule: full attention for layer i?"""
        if self.sliding_window == 0:
            return True
        if self.global_every == 0:
            return False
        return (i + 1) % self.global_every == 0

    def layer_is_moe(self, i: int) -> bool:
        return self.num_experts > 0 and i >= self.num_dense_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
