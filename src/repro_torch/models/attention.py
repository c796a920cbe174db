"""Attention: GQA and DeepSeek's MLA, with training/prefill and
single-token decode over contiguous KV caches (port of
``repro/models/attention.py`` without its paged caches).

Cache layouts:
  GQA      : k/v (B, L, H_kv, Dh) with absolute slots (L = max_len) or a
             ring of ``window`` slots for sliding-window layers, plus
             per-row position ids; ``QuantGqaCache`` holds k/v in int8 with
             one fp32 scale per (slot, kv-head).
  MLA      : the compressed latent c_kv (B, L, kv_lora) and the shared
             rope key k_rope (B, L, Dr), plus each row's filled length;
             ``QuantMlaCache`` holds c_kv in int8 with one fp32 scale per
             group of ``MLA_INT8_GROUP`` channels, k_rope in the model
             dtype.  Decode runs the absorbed form: W_k folded into the
             query, W_v applied after the attention, so a step reads
             (kv_lora + Dr) values per cached token.

Decode positions are per slot: ``pos`` is a python int (every row at the
same depth) or a (B,) tensor.  Unlike the JAX caches, which are returned
anew, the port writes each new token into the cache tensors in place
(``index_put_``) and returns the same cache.

Attention is a plain matmul + softmax in fp32 over the masked scores, as
the JAX package computes it; the scaling of the scores rounds as JAX's does
(``_scale_scores``, ``mla_decode``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -1e30


def slot_positions(pos, batch: int, device) -> Tensor:
    """Normalize decode positions to a per-slot (B,) int64 vector."""
    p = torch.as_tensor(pos, dtype=torch.int64, device=device)
    if p.dim() == 0:
        return p.expand(batch)
    if p.shape != (batch,):
        raise ValueError(f"per-slot pos must be () or ({batch},), "
                         f"got {tuple(p.shape)}")
    return p


def gqa_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": L.linear_params(gen, d, cfg.num_heads * hd, bias=cfg.attn_bias,
                              **kw),
        "wk": L.linear_params(gen, d, cfg.num_kv_heads * hd, **kw),
        "wv": L.linear_params(gen, d, cfg.num_kv_heads * hd,
                              bias=cfg.attn_bias, **kw),
        "wo": L.linear_params(gen, cfg.num_heads * hd, d, bias=cfg.attn_bias,
                              **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = L.rmsnorm_params(hd, **kw)
        p["knorm"] = L.rmsnorm_params(hd, **kw)
    return p


def _qkv(p, cfg, x, positions, theta, tape, path):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = L.dense(p["wq"], x, tape, path + ("wq",)).reshape(B, S, cfg.num_heads,
                                                           hd)
    k = L.dense(p["wk"], x, tape, path + ("wk",)).reshape(B, S,
                                                           cfg.num_kv_heads, hd)
    v = L.dense(p["wv"], x, tape, path + ("wv",)).reshape(B, S,
                                                           cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["qnorm"], q)
        k = L.rmsnorm(p["knorm"], k)
    if theta > 0:
        q = L.apply_rope(q, positions, theta)
        k = L.apply_rope(k, positions, theta)
    return q, k, v


def _scale_scores(scores: Tensor, D: int) -> Tensor:
    """scores / √D with √D rounded to the scores' dtype, as JAX's
    ``jnp.sqrt(D).astype(q.dtype)``: 11.3125 for D = 128 in bf16, not the
    fp32 √128 that dividing by a python float applies.  The divisor is a
    tensor on the scores' device, so the quotient is a true division on
    the card as on the CPU."""
    root = torch.full((), float(D), dtype=torch.float32,
                      device=scores.device).sqrt()
    return scores / root.to(scores.dtype)


def _sdpa(q, k, v, mask, num_heads, num_kv_heads):
    """q/k (B,S,H,Dqk), v (B,T,Hkv,Dv), mask (B,1,S,T) bool — True =
    attend.  Dv may differ from Dqk (MLA); the scale uses Dqk."""
    B, S, H, D = q.shape
    g = num_heads // num_kv_heads
    qg = q.reshape(B, S, num_kv_heads, g, D)
    scores = _scale_scores(torch.einsum("bskgd,btkd->bkgst", qg, k), D)
    scores = torch.where(mask[:, :, None], scores.to(torch.float32), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, v.shape[-1])


def causal_mask(S: int, window: int = 0, device="cpu") -> Tensor:
    """(S, S) True = attend."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def gqa_forward(p, cfg, x, positions, *, theta, window=0, tape=None,
                path=()) -> Tensor:
    """Full-sequence causal attention (training / prefill / calibration)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, theta, tape, path)
    m = causal_mask(S, window, x.device)[None, None]
    out = _sdpa(q, k, v, m.expand(B, 1, S, S), cfg.num_heads,
                cfg.num_kv_heads)
    return L.dense(p["wo"], out.reshape(B, S, -1), tape, path + ("wo",))


@dataclasses.dataclass
class GqaCache:
    k: Tensor          # (B, L, Hkv, Dh) — L = max_len (full) or window (SWA)
    v: Tensor
    pos_ids: Tensor    # (B, L) absolute position stored per row slot (-1 empty)
    window: int        # 0 = full cache


@dataclasses.dataclass
class QuantGqaCache:
    """int8 KV cache with one symmetric fp32 scale per (slot, kv-head):
    half the bytes of a bf16 cache at rest and per decode step; attention
    reads it dequantized to the model dtype."""

    k: Tensor          # (B, L, Hkv, Dh) int8
    v: Tensor
    k_scale: Tensor    # (B, L, Hkv) fp32
    v_scale: Tensor
    pos_ids: Tensor    # (B, L)
    window: int


def gqa_cache_init(cfg, batch: int, max_len: int, window: int = 0,
                   dtype=torch.float32, device="cpu"):
    """A zeroed cache: ``QuantGqaCache`` when ``cfg.kv_cache_dtype`` is
    "int8", else a ``GqaCache`` in ``dtype``."""
    slots = window if window > 0 else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.head_dim)
    pos_ids = torch.full((batch, slots), -1, dtype=torch.int64,
                         device=device)
    if cfg.kv_cache_dtype == "int8":
        return QuantGqaCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
            pos_ids=pos_ids, window=window)
    return GqaCache(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device),
                    pos_ids=pos_ids, window=window)


def _quantize_kv(t: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 over the last axis: scale = max(|t|, 1e-8) / 127 in
    fp32, payload round-half-even(t / scale) clipped to ±127.  A k/v token
    (B, 1, Hkv, Dh) → payload + (B, 1, Hkv) scale; an MLA latent grouped
    (B, 1, ng, G) → payload + (B, 1, ng) scale."""
    t32 = t.to(torch.float32)
    scale = torch.clamp(t32.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: Tensor, scale: Tensor, dtype) -> Tensor:
    """int8 payload (..., g) × scale (...) in fp32, cast to ``dtype``."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def gqa_decode(p, cfg, x, pos, cache, *, theta):
    """One-token decode.  x (B, 1, d); pos int or (B,) absolute positions.
    Writes the new k/v into ``cache`` in place (an int8 cache quantizes
    them first); → (y (B, 1, d), cache)."""
    B = x.shape[0]
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q, k, v = _qkv(p, cfg, x, pos_vec[:, None], theta, None, ())
    slots = cache.k.shape[1]
    slot = pos_vec % slots if cache.window > 0 else pos_vec
    rows = torch.arange(B, device=x.device)
    cache.pos_ids.index_put_((rows, slot), pos_vec)
    if isinstance(cache, QuantGqaCache):
        for new, buf, sbuf in ((k, cache.k, cache.k_scale),
                               (v, cache.v, cache.v_scale)):
            nq, ns = _quantize_kv(new)
            buf.index_put_((rows, slot), nq[:, 0])
            sbuf.index_put_((rows, slot), ns[:, 0])
        k_att = _dequantize(cache.k, cache.k_scale, x.dtype)
        v_att = _dequantize(cache.v, cache.v_scale, x.dtype)
    else:
        cache.k.index_put_((rows, slot), k[:, 0].to(cache.k.dtype))
        cache.v.index_put_((rows, slot), v[:, 0].to(cache.v.dtype))
        k_att, v_att = cache.k, cache.v

    ids = cache.pos_ids
    valid = (ids >= 0) & (ids <= pos_vec[:, None])               # (B, L)
    if cache.window:
        valid &= ids > pos_vec[:, None] - cache.window
    out = _sdpa(q, k_att, v_att, valid[:, None, None, :],
                cfg.num_heads, cfg.num_kv_heads)
    y = L.dense(p["wo"], out.reshape(B, 1, -1))
    return y, cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------
def mla_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    d, H = cfg.d_model, cfg.num_heads
    dq, dkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq_a": L.linear_params(gen, d, dq, **kw),
        "q_norm": L.rmsnorm_params(dq, **kw),
        "wq_b": L.linear_params(gen, dq, H * (dn + dr), **kw),
        "wkv_a": L.linear_params(gen, d, dkv + dr, **kw),
        "kv_norm": L.rmsnorm_params(dkv, **kw),
        "wkv_b": L.linear_params(gen, dkv, H * (dn + dv), **kw),
        "wo": L.linear_params(gen, H * dv, d, **kw),
    }


def _mla_qkr(p, cfg, x, positions, tape, path):
    """→ q_nope (B,S,H,dn), q_rope (B,S,H,dr) rotated, c_kv (B,S,dkv)
    normed, k_rope (B,S,dr) — one rope key shared by every head."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = L.dense(p["wq_b"], L.rmsnorm(p["q_norm"],
                L.dense(p["wq_a"], x, tape, path + ("wq_a",))),
                tape, path + ("wq_b",)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    kv = L.dense(p["wkv_a"], x, tape, path + ("wkv_a",))
    c_kv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = L.rmsnorm(p["kv_norm"], c_kv)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def mla_forward(p, cfg, x, positions, *, tape=None, path=()) -> Tensor:
    """Training/prefill MLA: expand c_kv through wkv_b to per-head k/v and
    run the causal ``_sdpa`` (q·k over dn + dr, values of width dv)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(p, cfg, x, positions, tape, path)
    kv = L.dense(p["wkv_b"], c_kv, tape, path + ("wkv_b",)).reshape(
        B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    m = causal_mask(S, device=x.device)[None, None].expand(B, 1, S, S)
    out = _sdpa(q, k, v, m, H, H)
    return L.dense(p["wo"], out.reshape(B, S, -1), tape, path + ("wo",))


@dataclasses.dataclass
class MlaCache:
    c_kv: Tensor       # (B, L, kv_lora)
    k_rope: Tensor     # (B, L, Dr)
    length: Tensor     # (B,) filled prefix per row


@dataclasses.dataclass
class QuantMlaCache:
    """int8 latent cache with one fp32 scale per (row, slot, group of
    ``_mla_group(kv_lora)`` channels): the latent mixes channels of very
    different magnitude, which one scale per slot would flatten.  k_rope
    stays in the model dtype."""

    c_kv: Tensor       # (B, L, kv_lora) int8
    c_scale: Tensor    # (B, L, kv_lora / G) fp32
    k_rope: Tensor     # (B, L, Dr) model dtype
    length: Tensor     # (B,)


MLA_INT8_GROUP = 8


def _mla_group(dkv: int) -> int:
    """Largest channel-group size ≤ MLA_INT8_GROUP that divides kv_lora."""
    return next(g for g in (8, 4, 2, 1)
                if g <= MLA_INT8_GROUP and dkv % g == 0)


def mla_cache_init(cfg, batch: int, max_len: int, dtype=torch.float32,
                   device="cpu"):
    """A zeroed latent cache: ``QuantMlaCache`` when
    ``cfg.kv_cache_dtype`` is "int8", else an ``MlaCache`` in ``dtype``."""
    dkv, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    k_rope = torch.zeros((batch, max_len, dr), dtype=dtype, device=device)
    length = torch.zeros((batch,), dtype=torch.int64, device=device)
    if cfg.kv_cache_dtype == "int8":
        g = _mla_group(dkv)
        return QuantMlaCache(
            c_kv=torch.zeros((batch, max_len, dkv), dtype=torch.int8,
                             device=device),
            c_scale=torch.zeros((batch, max_len, dkv // g),
                                dtype=torch.float32, device=device),
            k_rope=k_rope, length=length)
    return MlaCache(c_kv=torch.zeros((batch, max_len, dkv), dtype=dtype,
                                     device=device),
                    k_rope=k_rope, length=length)


def mla_decode(p, cfg, x, pos, cache):
    """Absorbed single-token decode in the compressed c_kv space.

    score_t = q_nopeᵀ W_kᵀ c_kv[t] + q_ropeᵀ k_rope[t], both terms in the
    model dtype, then scaled in fp32 by 1/√(dn + dr); ctx = probs · c_kv
    and out = ctx · W_v, with W_k, W_v the raw wkv_b kernel reshaped (so
    wkv_b is always dense).  Writes the new latent (int8 per channel group
    for a ``QuantMlaCache``) in place; ``length`` becomes pos + 1 for every
    row; the mask is ``arange(L) <= pos``.  → (y (B, 1, d), cache)."""
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, dkv = cfg.v_head_dim, cfg.kv_lora_rank
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q_nope, q_rope, c_new, kr_new = _mla_qkr(p, cfg, x, pos_vec[:, None],
                                             None, ())
    rows = torch.arange(B, device=x.device)
    cache.k_rope.index_put_((rows, pos_vec),
                            kr_new[:, 0].to(cache.k_rope.dtype))
    cache.length.copy_(pos_vec + 1)
    if isinstance(cache, QuantMlaCache):
        ng = cache.c_scale.shape[-1]
        cq, cs = _quantize_kv(c_new.reshape(B, 1, ng, dkv // ng))
        cache.c_kv.index_put_((rows, pos_vec), cq.reshape(B, dkv))
        cache.c_scale.index_put_((rows, pos_vec), cs[:, 0])
        L_max = cache.c_kv.shape[1]
        c_att = _dequantize(cache.c_kv.reshape(B, L_max, ng, dkv // ng),
                            cache.c_scale, x.dtype).reshape(B, L_max, dkv)
    else:
        cache.c_kv.index_put_((rows, pos_vec),
                              c_new[:, 0].to(cache.c_kv.dtype))
        c_att = cache.c_kv
    wkv_b = p["wkv_b"]["w"].reshape(dkv, H, dn + dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_eff = torch.einsum("bhd,khd->bhk", q_nope[:, 0], w_k)    # (B, H, dkv)
    scores = torch.einsum("bhk,blk->bhl", q_eff, c_att) + torch.einsum(
        "bhd,bld->bhl", q_rope[:, 0], cache.k_rope)
    scale = 1.0 / torch.full((), float(dn + dr), dtype=torch.float32,
                             device=x.device).sqrt()
    valid = torch.arange(c_att.shape[1], device=x.device)[None, :] <= \
        pos_vec[:, None]
    scores = torch.where(valid[:, None, :], scores.to(torch.float32) * scale,
                         NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhl,blk->bhk", probs, c_att)          # (B, H, dkv)
    out = torch.einsum("bhk,khd->bhd", ctx, w_v)              # (B, H, dv)
    y = L.dense(p["wo"], out.reshape(B, 1, H * dv))
    return y, cache
