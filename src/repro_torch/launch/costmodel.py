"""Analytic FLOP/HBM-byte cost model for the roofline (port of
``repro/launch/costmodel.py``: the same formulas, term for term).

The port has no compiler cost analysis to read, so this model is the
roofline's only source of compute and memory terms; the dry run and the
perf ladders put the card's measured step time beside it.

Conventions:
  * flops are cluster-wide per optimizer step (train) / per forward
    (prefill) / per token-step (decode);
  * 1 MAC = 2 flops; causal attention context ≈ S/2 (windowed: ≈ w);
  * train multiplier: fwd(1) + remat re-fwd(1) + bwd(2) = 4× block fwd,
    3× head fwd (head is not rematted);
  * HBM bytes are a napkin traffic model (weight streams × microbatches,
    saved residuals, logits, optimizer state, KV cache) — the quantities a
    performance engineer would whiteboard before trusting a profiler.

Bytes of a tree are the port's own: the cache's positions, lengths and
page tables are int64 here (int32 in the JAX package), so ``cache_bytes``
and a decode step's ``hbm_bytes`` exceed JAX's by 4 bytes an index
element — what the card really moves.
"""
from __future__ import annotations

import dataclasses
import math

import torch

BF16 = 2
FP32 = 4


@dataclasses.dataclass
class Cost:
    flops: float = 0.0            # cluster-wide per step
    hbm_bytes: float = 0.0        # cluster-wide per step
    weight_bytes: float = 0.0     # one full stream of active weights
    detail: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# per-family linear-layer MACs per token (weights actually multiplied)
# --------------------------------------------------------------------------
def _gqa_linear(cfg) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    return d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
        + cfg.num_heads * hd * d


def _mla_linear(cfg) -> float:
    d, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return (d * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr)
            + d * (cfg.kv_lora_rank + dr) + cfg.kv_lora_rank * H * (dn + dv)
            + H * dv * d)


def _mlp_linear(cfg) -> float:
    return 3 * cfg.d_model * cfg.d_ff


def _moe_linear(cfg, *, active: bool) -> float:
    d, fm = cfg.d_model, cfg.moe_d_ff
    routed = cfg.num_experts_per_tok if active else cfg.num_experts
    total = cfg.d_model * cfg.num_experts          # router
    total += routed * 3 * d * fm * (cfg.capacity_factor if active else 1.0)
    total += cfg.num_shared_experts * 3 * d * fm
    return total


def _mamba_linear(cfg) -> float:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    heads = d_inner // cfg.ssm_head_dim
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + heads
    return d * d_in_proj + d_inner * d


def _mlstm_linear(cfg) -> float:
    d = cfg.d_model
    di = cfg.xlstm_proj_factor * d
    return d * 2 * di + 3 * di * di + 2 * di * cfg.num_heads + di * d


def _ctx(cfg, i: int, S: int, kind: str, cache_len: int) -> float:
    """Average attention context length for layer i."""
    if kind == "decode":
        L = cache_len
        if cfg.sliding_window and not cfg.layer_is_global(i):
            L = min(cfg.sliding_window, L)
        return float(L)
    if cfg.sliding_window and not cfg.layer_is_global(i):
        return float(min(cfg.sliding_window, S / 2))
    return S / 2.0


def linear_macs_per_token(cfg) -> tuple[float, float]:
    """(active, total) linear MACs per token across all blocks + head."""
    fam = cfg.family
    act = tot = 0.0
    if fam in ("dense", "moe", "vlm"):
        for i in range(cfg.num_layers):
            a = _mla_linear(cfg) if cfg.uses_mla else _gqa_linear(cfg)
            act += a
            tot += a
            if cfg.layer_is_moe(i):
                act += _moe_linear(cfg, active=True)
                tot += _moe_linear(cfg, active=False)
            else:
                act += _mlp_linear(cfg)
                tot += _mlp_linear(cfg)
    elif fam == "encdec":
        enc = _gqa_linear(cfg) + 2 * cfg.d_model * cfg.d_ff
        dec = 2 * _gqa_linear(cfg) + 2 * cfg.d_model * cfg.d_ff
        act += cfg.encoder_layers * enc + cfg.decoder_layers * dec
        tot = act
    elif fam == "hybrid":
        act += cfg.num_layers * _mamba_linear(cfg)
        n_shared_apps = sum(
            1 for i in range(cfg.num_layers)
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0
        )
        per_app = _gqa_linear(cfg) + _mlp_linear(cfg)
        act += n_shared_apps * per_app          # applications (weights reused)
        tot = act
    elif fam == "ssm":
        act += cfg.num_layers * _mlstm_linear(cfg)
        tot = act
    head = cfg.d_model * cfg.vocab_size        # tied head counted once
    return act + head, tot + head


def attn_macs(cfg, B: int, S: int, kind: str, cache_len: int = 0) -> float:
    """Quadratic/recurrent mixing MACs for the whole model, per step."""
    fam = cfg.family
    tokens = B * (1 if kind == "decode" else S)
    total = 0.0
    if fam in ("dense", "moe", "vlm"):
        for i in range(cfg.num_layers):
            ctx = _ctx(cfg, i, S, kind, cache_len)
            if cfg.uses_mla:
                if kind == "decode":
                    H = cfg.num_heads
                    total += B * H * (
                        2 * cfg.qk_nope_head_dim * cfg.kv_lora_rank
                        + ctx * (2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                    )
                else:
                    H = cfg.num_heads
                    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                    total += tokens * ctx * H * (dqk + cfg.v_head_dim)
            else:
                total += 2 * tokens * ctx * cfg.num_heads * cfg.head_dim
    elif fam == "encdec":
        Sf = S  # encoder frames
        Sd = cfg.dec_seq if kind != "decode" else 1
        ctx_cross = 1500 if kind == "decode" else Sf
        hd = cfg.num_heads * cfg.head_dim
        if kind != "decode":
            total += cfg.encoder_layers * 2 * B * Sf * Sf * hd
        self_ctx = cache_len if kind == "decode" else Sd / 2
        total += cfg.decoder_layers * 2 * B * Sd * self_ctx * hd
        total += cfg.decoder_layers * 2 * B * Sd * ctx_cross * hd
    elif fam == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        total += cfg.num_layers * tokens * 3 * d_inner * cfg.ssm_state
        n_apps = sum(1 for i in range(cfg.num_layers)
                     if cfg.attn_every and (i + 1) % cfg.attn_every == 0)
        w = cfg.sliding_window or 0
        if kind == "decode":
            ctx = min(w, cache_len) if w else cache_len
            total += n_apps * 2 * B * ctx * cfg.num_heads * cfg.head_dim
        else:
            ctx = min(w, S / 2) if w else S / 2
            total += n_apps * 2 * tokens * ctx * cfg.num_heads * cfg.head_dim
    elif fam == "ssm":
        di = cfg.xlstm_proj_factor * cfg.d_model
        hd = di // cfg.num_heads
        # matrix-memory update + read: ~2 rank-1 ops on (hd, hd) per head
        total += cfg.num_layers * tokens * 2 * di * hd
    return total


# --------------------------------------------------------------------------
# top-level step costs
# --------------------------------------------------------------------------
def tree_tensors(tree) -> list:
    """The tensor leaves of a port tree: nested dicts, lists, tuples and
    dataclasses (caches, compressed leaves); other fields (a cache's
    static ``window``, a compressed leaf's ``n``/``m``) are not leaves, as
    they are static aux data in the JAX trees."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_tensors(getattr(tree, f.name))]
    return []


def _tree_bytes(tree) -> float:
    total = 0.0
    for leaf in tree_tensors(tree):
        total += float(math.prod(leaf.shape)) * leaf.element_size()
    return total


def param_bytes(cfg, a_params) -> float:
    return _tree_bytes(a_params)


def cache_bytes(a_cache) -> float:
    return _tree_bytes(a_cache)


def _depth(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.decoder_layers
    return cfg.num_layers


def step_cost(cfg, cell, a_params, *, n_micro: int = 1,
              a_cache=None, cross_cached: bool = False,
              enc_len: int = 1500) -> Cost:
    B, S = cell.global_batch, cell.seq_len
    kind = cell.kind
    act_macs, _ = linear_macs_per_token(cfg)
    P = param_bytes(cfg, a_params)
    L = _depth(cfg)
    d = cfg.d_model
    V = cfg.vocab_size

    if kind == "train":
        tokens = B * S
        fwd = 2 * act_macs * tokens + 2 * attn_macs(cfg, B, S, kind)
        flops = 4 * (fwd - 2 * d * V * tokens) + 3 * (2 * d * V * tokens)
        # traffic: weights streamed 3× (fwd + remat + bwd) per microbatch;
        # optimizer: grads fp32 r/w + moments r/w + params r/w;
        # activations: saved residuals w+r, block-local recompute traffic;
        # logits bf16 w+r per microbatch chunk.
        moments = P  # bf16 moments ≈ param bytes, ×2 tensors
        hbm = (3 * P * n_micro
               + 2 * FP32 / BF16 * P + 4 * moments + 2 * P
               + 6 * tokens * d * BF16 * L / max(1, 1)  # residual traffic
               + 2 * tokens * V * BF16)
        det = {"fwd_flops": fwd, "n_micro": n_micro}
    elif kind == "prefill":
        tokens = B * S
        flops = 2 * act_macs * tokens + 2 * attn_macs(cfg, B, S, kind)
        hbm = (P + 4 * tokens * d * BF16 * L
               + (cache_bytes(a_cache) if a_cache is not None else 0.0)
               + 2 * B * V * BF16)
        det = {}
    else:  # decode — one token per sequence
        flops = 2 * act_macs * B + 2 * attn_macs(cfg, B, S, kind, cache_len=S)
        cb = cache_bytes(a_cache) if a_cache is not None else 0.0
        hbm = P + cb + 2 * B * V * BF16
        det = {"cache_bytes": cb}
        if cfg.family == "encdec":
            hd = cfg.num_heads * cfg.head_dim
            kv_dims = 2 * cfg.num_kv_heads * cfg.head_dim
            if cross_cached:
                # read the precomputed per-layer cross-KV each step
                cross_b = (cfg.decoder_layers * B * enc_len
                           * kv_dims * BF16)
                hbm += cross_b
                det["cross_kv_bytes"] = cross_b
            else:
                # re-project the full encoder source through wk/wv every
                # step of every decoder layer — the naive path
                cross_f = (2 * cfg.decoder_layers * B * enc_len
                           * cfg.d_model * kv_dims)
                flops += cross_f
                hbm += (cfg.decoder_layers * B * enc_len
                        * cfg.d_model * BF16)
                det["cross_recompute_flops"] = cross_f
    return Cost(flops=flops, hbm_bytes=hbm, weight_bytes=P, detail=det)
