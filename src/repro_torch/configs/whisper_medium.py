"""whisper-medium [audio] — 24L(enc)+24L(dec) d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865, enc-dec; the conv audio front end is a stub (the
batch carries precomputed frame embeddings).  [arXiv:2212.04356;
unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=0, encoder_layers=24, decoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51_865,
    act="gelu", norm="layernorm", attn_bias=True,
    tie_embeddings=True, dec_seq=448,
)

REDUCED = CONFIG.replace(
    encoder_layers=2, decoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, dec_seq=16,
    dtype="float32",
)
