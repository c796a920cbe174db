"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA (q_lora 1536,
kv_lora 512, nope 128, rope 64, v 128), 1 shared + 256 routed experts top-8
(moe d_ff 2048), first 3 layers dense (d_ff 18432), vocab=129280.
MTP head omitted (single-token objective).  [arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129_280,
    num_experts=256, num_experts_per_tok=8, num_shared_experts=1,
    moe_d_ff=2048, num_dense_layers=3,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    tie_embeddings=False, rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, num_experts=8, num_experts_per_tok=2,
    moe_d_ff=32, num_dense_layers=1, q_lora_rank=32, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    capacity_factor=4.0, dtype="float32",
)
