"""GQA attention with training/prefill and single-token decode over a
contiguous KV cache (port of ``repro/models/attention.py``, GQA part).

Cache layout: k/v (B, L, H_kv, Dh) with absolute slots (L = max_len) or a
ring of ``window`` slots for sliding-window layers, plus per-row position
ids.  Decode positions are per slot: ``pos`` is a python int (every row at
the same depth) or a (B,) tensor.  Unlike the JAX cache, which is returned
anew, the port writes the new k/v into the cache tensors in place
(``index_put_``) and returns the same cache.

Attention is a plain matmul + softmax in fp32 over the masked scores, as
the JAX package computes it.
"""
from __future__ import annotations

import dataclasses
import math

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


def _sdpa(q, k, v, mask, num_heads, num_kv_heads):
    """q (B,S,H,D), k/v (B,T,Hkv,D), mask (B,1,S,T) bool — True = attend."""
    B, S, H, D = q.shape
    g = num_heads // num_kv_heads
    qg = q.reshape(B, S, num_kv_heads, g, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(D)
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


def gqa_cache_init(cfg, batch: int, max_len: int, window: int = 0,
                   dtype=torch.float32, device="cpu") -> GqaCache:
    slots = window if window > 0 else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return GqaCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos_ids=torch.full((batch, slots), -1, dtype=torch.int64,
                           device=device),
        window=window)


def gqa_decode(p, cfg, x, pos, cache: GqaCache, *, theta):
    """One-token decode.  x (B, 1, d); pos int or (B,) absolute positions.
    Writes the new k/v into ``cache`` in place; → (y (B, 1, d), cache)."""
    B = x.shape[0]
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q, k, v = _qkv(p, cfg, x, pos_vec[:, None], theta, None, ())
    slots = cache.k.shape[1]
    slot = pos_vec % slots if cache.window > 0 else pos_vec
    rows = torch.arange(B, device=x.device)
    cache.k.index_put_((rows, slot), k[:, 0].to(cache.k.dtype))
    cache.v.index_put_((rows, slot), v[:, 0].to(cache.v.dtype))
    cache.pos_ids.index_put_((rows, slot), pos_vec)

    ids = cache.pos_ids
    valid = (ids >= 0) & (ids <= pos_vec[:, None])               # (B, L)
    if cache.window:
        valid &= ids > pos_vec[:, None] - cache.window
    out = _sdpa(q, cache.k, cache.v, valid[:, None, None, :],
                cfg.num_heads, cfg.num_kv_heads)
    y = L.dense(p["wo"], out.reshape(B, 1, -1))
    return y, cache
