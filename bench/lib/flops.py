"""The benchmark's own operation and byte counts: model FLOPs a token, and
the roofline bound of one kernel launch.  Copied into the benchmark so
that a change to the program cannot move the yardstick.

A bound is max(bytes / peak HBM bandwidth, operations / peak bf16 rate):
every input read once, every output written once, and for a 2:4 product
the multiply-adds of the kept weights only (half the dense ones).
"""
from __future__ import annotations

from bench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

BF16 = 2
FP32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def attn_linear_macs(cfg) -> int:
    """q, k, v and o projections, a token a layer (GQA)."""
    d, hd = cfg.d_model, cfg.head_dim
    return (d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * d)


def ffn_macs(cfg, i: int) -> int:
    """Layer i's feed-forward a token: the router and the k routed experts
    (no capacity padding: the work the token needs), or the dense MLP."""
    if cfg.num_experts and i >= cfg.num_dense_layers:
        return (cfg.d_model * cfg.num_experts
                + cfg.num_experts_per_tok * 3 * cfg.d_model * cfg.moe_d_ff)
    return 3 * cfg.d_model * cfg.d_ff


def block_macs(cfg, i: int) -> int:
    return attn_linear_macs(cfg) + ffn_macs(cfg, i)


def attn_core_macs(cfg, ctx: int) -> int:
    """Scores and the weighted sum of one query over ``ctx`` keys, a layer."""
    return 2 * cfg.num_heads * cfg.head_dim * ctx


def token_flops(cfg, ctx: int, *, head: bool = True) -> float:
    """Model FLOPs of one token at context ``ctx`` (its position + 1)
    through every block, and the LM head when ``head``."""
    macs = sum(block_macs(cfg, i) for i in range(cfg.num_layers))
    macs += cfg.num_layers * attn_core_macs(cfg, ctx)
    if head:
        macs += cfg.d_model * cfg.vocab_size
    return 2.0 * macs


def block_forward_flops(cfg, i: int, seqs: int, seq_len: int) -> float:
    """One causal forward of ``seqs`` sequences of ``seq_len`` tokens
    through block i: Σ over their positions of the block's part of
    ``token_flops``."""
    macs = seqs * seq_len * block_macs(cfg, i)
    macs += seqs * attn_core_macs(cfg, 1) * seq_len * (seq_len + 1) // 2
    return 2.0 * macs


def k2_bound_s(B: int, c: int, b: int, idx_bits: int) -> float:
    """K2, y (B, c) = x (B, b) · W (c, b)ᵀ with W 2:4-compressed in bf16:
    the kept values (c · b/2), their indices (4 or 8 bits each), x read
    once, y written once; B · c · b/2 multiply-adds."""
    kept = c * (b // 2)
    nbytes = kept * BF16 + kept * idx_bits / 8 + (B * b + B * c) * BF16
    return bound_s(nbytes, 2.0 * B * kept)


def k1_ops(rows: int, b: int) -> float:
    """K1's operations as the kernel table counts them: the symmetric half
    of xᵀx, rows · b · (b + 1)."""
    return float(rows) * b * (b + 1)


def k1_bound_s(rows: int, b: int, esize: int = BF16) -> float:
    """K1, H (b, b) fp32 += xᵀx for x (rows, b): x read once, H read and
    written once."""
    return bound_s(rows * b * esize + 2 * b * b * FP32, k1_ops(rows, b))
