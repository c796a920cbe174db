"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262_144,
    act="gelu", qk_norm=True, tie_embeddings=True,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    sliding_window=512, global_every=6,         # 5 local : 1 global
)

REDUCED = CONFIG.replace(
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, sliding_window=8, dtype="float32",
)
