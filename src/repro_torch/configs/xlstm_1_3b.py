"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4H, sLSTM every 8th block
(xLSTM[7:1]), no separate FFN (d_ff=0; blocks carry 2x up/down projections),
vocab=50304.  [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50_304,
    xlstm_proj_factor=2, slstm_every=8,
    tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, head_dim=16, vocab_size=512,
    slstm_every=4, dtype="float32",
)
