"""internvl2-76b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
Llama-3-70B-style language backbone.  [arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128_256,
    tie_embeddings=False, rope_theta=500_000.0, vlm_image_tokens=256,
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, vlm_image_tokens=8, dtype="float32",
)
