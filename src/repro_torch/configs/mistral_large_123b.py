"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768, full attention.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32_768,
    tie_embeddings=False, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, dtype="float32",
)
