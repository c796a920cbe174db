"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000, llama2 architecture.  The paper's own Table-5 model.
[arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32_000,
    tie_embeddings=False, rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32",
)
