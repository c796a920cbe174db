"""zamba2-7b [hybrid] — 81 Mamba2 layers d_model=3584, shared transformer
blocks (32H MHA + d_ff 14336 MLP, two alternating sets) every 6 layers,
ssm_state=64, vocab=32000.  [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32_000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_groups=2,
    attn_every=6, num_shared_attn=2,
    sliding_window=4096,              # windowed shared attention at long ctx
    tie_embeddings=False, rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_groups=2,
    attn_every=3, sliding_window=8, dtype="float32",
)
