"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32_000,
    tie_embeddings=False, rope_theta=10_000.0,
    sliding_window=4096, global_every=0,        # mistral-style: all local
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, sliding_window=8, dtype="float32",
)
