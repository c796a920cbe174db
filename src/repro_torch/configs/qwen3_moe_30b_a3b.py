"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4, head_dim 128),
128 experts top-8, expert d_ff=768, vocab=151936, qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151_936,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=768,
    qk_norm=True, tie_embeddings=False, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    vocab_size=512, num_experts=8, num_experts_per_tok=2, moe_d_ff=32,
    capacity_factor=4.0, dtype="float32",
)
