"""Attention: GQA and DeepSeek's MLA, with training/prefill and
single-token decode over contiguous and paged KV caches (port of
``repro/models/attention.py``).

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
  paged    : ``Paged{Gqa,QuantGqa,Mla,QuantMla}Cache`` hold the same
             leaves as page pools (num_pages, page_size, ...) shared by
             every slot, plus a (B, pages_per_slot) table of physical pages
             (``serve/pager.py`` decides it).  Full-attention layers only:
             a sliding-window layer keeps its ring.

Decode positions are per slot: ``pos`` is a python int (every row at the
same depth) or a (B,) tensor — the serving engine always passes its static
(B,) buffer.  Unlike the JAX caches, which are returned
anew, the port writes each new token into the cache tensors in place
(``index_put_``) and returns the same cache.  Positions, lengths and page
tables are int64 (int32 in JAX).

Attention is a plain matmul + softmax in fp32 over the masked scores, as
the JAX package computes it (paged attention too: gathers and einsums, no
kernel); the scaling of the scores rounds as JAX's does
(``_scale_scores``, ``mla_decode``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -1e30


def slot_positions(pos, batch: int, device) -> Tensor:
    """Normalize decode positions to a per-slot (B,) int64 vector on
    ``device``.  A tensor — the serving engine's static (B,) buffer — is
    used as it is, so a captured step reads the buffer the engine writes
    before each replay; an int every row shares is filled on the device
    (``torch.full``: no host-to-device copy, which a capture refuses)."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((batch,), pos, dtype=torch.int64, device=device)
    p = pos.to(device=device, dtype=torch.int64)
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


def gqa_forward(p, cfg, x, positions, *, theta, window=0, is_causal=True,
                tape=None, path=()) -> Tensor:
    """Full-sequence attention (training / prefill / calibration): causal,
    or over every position with ``is_causal=False`` (an encoder)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, theta, tape, path)
    if is_causal:
        m = causal_mask(S, window, x.device)[None, None]
    else:
        m = torch.ones((1, 1, S, S), dtype=torch.bool, device=x.device)
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
    them first); → (y (B, 1, d), cache).  A paged cache decodes through
    ``_gqa_decode_paged``."""
    if isinstance(cache, (PagedGqaCache, PagedQuantGqaCache)):
        return _gqa_decode_paged(p, cfg, x, pos, cache, theta=theta)
    B = x.shape[0]
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q, k, v = _qkv(p, cfg, x, pos_vec[:, None], theta, None, ())
    slots = cache.k.shape[1]
    slot = pos_vec % slots if cache.window > 0 else pos_vec
    rows = torch.arange(B, device=x.device)
    cache.pos_ids.index_put_((rows, slot), pos_vec)

    def put(field, new):
        buf = getattr(cache, field)
        buf.index_put_((rows, slot), new.to(buf.dtype))

    y = _gqa_attend(p, cfg, x, q, k, v, cache, pos_vec, cache.window, put,
                    lambda field: getattr(cache, field))
    return y, cache


def _gqa_attend(p, cfg, x, q, k, v, cache, pos_vec, window, put, read):
    """The decode tail every GQA cache shares: write the new k/v (an int8
    cache quantizes them and writes their scales), attend over the rows
    with lanes ``0 ≤ pos_ids ≤ pos`` (and within ``window``) valid, then
    ``wo`` → y (B, 1, d).  ``put(field, new)`` writes one token a row into
    the leaf ``field``; ``read(field)`` → that leaf's (B, L, ...) rows."""
    if isinstance(cache, (QuantGqaCache, PagedQuantGqaCache)):
        for new, field in ((k, "k"), (v, "v")):
            nq, ns = _quantize_kv(new)
            put(field, nq[:, 0])
            put(field + "_scale", ns[:, 0])
        k_att = _dequantize(read("k"), read("k_scale"), x.dtype)
        v_att = _dequantize(read("v"), read("v_scale"), x.dtype)
    else:
        put("k", k[:, 0])
        put("v", v[:, 0])
        k_att, v_att = read("k"), read("v")
    ids = cache.pos_ids
    valid = (ids >= 0) & (ids <= pos_vec[:, None])               # (B, L)
    if window:
        valid &= ids > pos_vec[:, None] - window
    out = _sdpa(q, k_att, v_att, valid[:, None, None, :],
                cfg.num_heads, cfg.num_kv_heads)
    return L.dense(p["wo"], out.reshape(x.shape[0], 1, -1))


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


def _quantize_latent(c_new: Tensor, ng: int) -> tuple[Tensor, Tensor]:
    """One latent token (B, 1, dkv) → int8 payload (B, dkv) and its (B, ng)
    fp32 scales, one per group of dkv / ng channels."""
    B, _, dkv = c_new.shape
    cq, cs = _quantize_kv(c_new.reshape(B, 1, ng, dkv // ng))
    return cq.reshape(B, dkv), cs[:, 0]


def _dequantize_latent(c: Tensor, scale: Tensor, dtype) -> Tensor:
    """int8 latent rows (B, L, dkv) × their (B, L, ng) scales → (B, L, dkv)
    in ``dtype``."""
    B, n_lanes, dkv = c.shape
    ng = scale.shape[-1]
    return _dequantize(c.reshape(B, n_lanes, ng, dkv // ng), scale,
                       dtype).reshape(B, n_lanes, dkv)


def mla_decode(p, cfg, x, pos, cache):
    """Absorbed single-token decode in the compressed c_kv space.

    score_t = q_nopeᵀ W_kᵀ c_kv[t] + q_ropeᵀ k_rope[t], both terms in the
    model dtype, then scaled in fp32 by 1/√(dn + dr); ctx = probs · c_kv
    and out = ctx · W_v, with W_k, W_v the raw wkv_b kernel reshaped (so
    wkv_b is always dense).  Writes the new latent (int8 per channel group
    for a ``QuantMlaCache``) in place; ``length`` becomes pos + 1 for every
    row; the mask is ``arange(L) <= pos``.  → (y (B, 1, d), cache).  A
    paged cache decodes through ``_mla_decode_paged``."""
    if isinstance(cache, (PagedMlaCache, PagedQuantMlaCache)):
        return _mla_decode_paged(p, cfg, x, pos, cache)
    B = x.shape[0]
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q_nope, q_rope, c_new, kr_new = _mla_qkr(p, cfg, x, pos_vec[:, None],
                                             None, ())
    rows = torch.arange(B, device=x.device)
    cache.k_rope.index_put_((rows, pos_vec),
                            kr_new[:, 0].to(cache.k_rope.dtype))
    cache.length.copy_(pos_vec + 1)
    if isinstance(cache, QuantMlaCache):
        cq, cs = _quantize_latent(c_new, cache.c_scale.shape[-1])
        cache.c_kv.index_put_((rows, pos_vec), cq)
        cache.c_scale.index_put_((rows, pos_vec), cs)
        c_att = _dequantize_latent(cache.c_kv, cache.c_scale, x.dtype)
    else:
        cache.c_kv.index_put_((rows, pos_vec),
                              c_new[:, 0].to(cache.c_kv.dtype))
        c_att = cache.c_kv
    return _mla_attend(p, cfg, x, q_nope, q_rope, c_att, cache.k_rope,
                       pos_vec), cache


def _mla_attend(p, cfg, x, q_nope, q_rope, c_att, k_rope, pos_vec):
    """The absorbed attention of one decode step over the latent rows
    c_att (B, L, dkv) and k_rope (B, L, Dr), lanes ≤ pos valid → y."""
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, dkv = cfg.v_head_dim, cfg.kv_lora_rank
    wkv_b = p["wkv_b"]["w"].reshape(dkv, H, dn + dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_eff = torch.einsum("bhd,khd->bhk", q_nope[:, 0], w_k)    # (B, H, dkv)
    scores = torch.einsum("bhk,blk->bhl", q_eff, c_att) + torch.einsum(
        "bhd,bld->bhl", q_rope[:, 0], k_rope)
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
    return y


# --------------------------------------------------------------------------
# Paged caches (serve/pager.py decides the page tables)
# --------------------------------------------------------------------------
# Pool leaves are (num_pages, page_size, ...) shared by every slot; the
# per-slot ``table`` (B, pages_per_slot) maps logical page p of slot b to a
# physical page, and the gather ``pool[table].reshape(B, P·ps, ...)``
# rebuilds exactly the (B, L, ...) row the contiguous layouts hold, in the
# same lane order.  Masked lanes (pos_ids -1 or beyond pos) hit NEG_INF
# before the softmax and weigh an exact 0.0, so paged decode is bitwise the
# contiguous decode whenever P·ps equals the contiguous max_len.  A token
# lands at physical page ``table[b, pos // ps]``, offset ``pos % ps``.
# Page 0 is the pager's scratch sink: idle and retired slots keep
# re-decoding and write there, so one ``index_put_`` may hold duplicate
# (page 0, offset) indices whose winner is unspecified on CUDA; scratch is
# masked wherever it is read and stays finite.  Two active slots never
# share a write page: the engine faults every active write page in
# (copy-on-write) before each decode step.


@dataclasses.dataclass
class PagedGqaCache:
    k: Tensor          # (N_pages, page_size, Hkv, Dh) pool
    v: Tensor
    pos_ids: Tensor    # (B, P·page_size) absolute position per lane (-1)
    table: Tensor      # (B, P) physical page per logical page


@dataclasses.dataclass
class PagedQuantGqaCache:
    k: Tensor          # (N_pages, page_size, Hkv, Dh) int8 pool
    v: Tensor
    k_scale: Tensor    # (N_pages, page_size, Hkv) fp32
    v_scale: Tensor
    pos_ids: Tensor    # (B, P·page_size)
    table: Tensor      # (B, P)


@dataclasses.dataclass
class PagedMlaCache:
    c_kv: Tensor       # (N_pages, page_size, kv_lora) pool
    k_rope: Tensor     # (N_pages, page_size, Dr) pool
    length: Tensor     # (B,)
    table: Tensor      # (B, P)


@dataclasses.dataclass
class PagedQuantMlaCache:
    c_kv: Tensor       # (N_pages, page_size, kv_lora) int8 pool
    c_scale: Tensor    # (N_pages, page_size, kv_lora / G) fp32 pool
    k_rope: Tensor     # (N_pages, page_size, Dr) pool
    length: Tensor     # (B,)
    table: Tensor      # (B, P)


PAGED_CACHE_TYPES = (PagedGqaCache, PagedQuantGqaCache,
                     PagedMlaCache, PagedQuantMlaCache)

# the page-indexed leaves of each paged kind; the others are per-slot
# bookkeeping the helpers below handle one by one
_POOL_FIELDS = {
    PagedGqaCache: ("k", "v"),
    PagedQuantGqaCache: ("k", "v", "k_scale", "v_scale"),
    PagedMlaCache: ("c_kv", "k_rope"),
    PagedQuantMlaCache: ("c_kv", "c_scale", "k_rope"),
}


def is_paged(cache) -> bool:
    return isinstance(cache, PAGED_CACHE_TYPES)


def paged_geometry(cache) -> tuple[int, int, int, int]:
    """→ (num_pages, page_size, pages_per_slot, batch)."""
    pool = getattr(cache, _POOL_FIELDS[type(cache)][0])
    return (pool.shape[0], pool.shape[1],
            cache.table.shape[1], cache.table.shape[0])


def gqa_paged_cache_init(cfg, batch: int, *, num_pages: int, page_size: int,
                         pages_per_slot: int, dtype=torch.float32,
                         device="cpu"):
    """Full-attention GQA pools (sliding-window layers keep their rings:
    a ring is already O(window) a slot).  Every table entry starts at
    scratch; int8 pools when ``cfg.kv_cache_dtype`` is "int8"."""
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    pos_ids = torch.full((batch, pages_per_slot * page_size), -1,
                         dtype=torch.int64, device=device)
    table = torch.zeros((batch, pages_per_slot), dtype=torch.int64,
                        device=device)
    if cfg.kv_cache_dtype == "int8":
        return PagedQuantGqaCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32,
                                device=device),
            pos_ids=pos_ids, table=table)
    return PagedGqaCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device),
                         pos_ids=pos_ids, table=table)


def mla_paged_cache_init(cfg, batch: int, *, num_pages: int, page_size: int,
                         pages_per_slot: int, dtype=torch.float32,
                         device="cpu"):
    """Latent pools; int8 latent with its scales as a pool leaf when
    ``cfg.kv_cache_dtype`` is "int8"."""
    dkv, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    k_rope = torch.zeros((num_pages, page_size, dr), dtype=dtype,
                         device=device)
    length = torch.zeros((batch,), dtype=torch.int64, device=device)
    table = torch.zeros((batch, pages_per_slot), dtype=torch.int64,
                        device=device)
    if cfg.kv_cache_dtype == "int8":
        g = _mla_group(dkv)
        return PagedQuantMlaCache(
            c_kv=torch.zeros((num_pages, page_size, dkv), dtype=torch.int8,
                             device=device),
            c_scale=torch.zeros((num_pages, page_size, dkv // g),
                                dtype=torch.float32, device=device),
            k_rope=k_rope, length=length, table=table)
    return PagedMlaCache(
        c_kv=torch.zeros((num_pages, page_size, dkv), dtype=dtype,
                         device=device),
        k_rope=k_rope, length=length, table=table)


def _paged_put(cache, field, new, phys, off) -> None:
    """Write one token a row into the pool in place: (N, ps, ...) ←
    new (B, ...) at (phys, off)."""
    pool = getattr(cache, field)
    pool.index_put_((phys, off), new.to(pool.dtype))


def _paged_gather(cache, field) -> Tensor:
    """pool[table] → the logical (B, P·ps, ...) rows."""
    pool = getattr(cache, field)
    B, P = cache.table.shape
    return pool[cache.table].reshape(B, P * pool.shape[1], *pool.shape[2:])


def _write_page_slots(cache, pos_vec):
    """(physical page, offset) of each row's write at ``pos_vec``."""
    ps = getattr(cache, _POOL_FIELDS[type(cache)][0]).shape[1]
    rows = torch.arange(pos_vec.shape[0], device=pos_vec.device)
    return cache.table[rows, pos_vec // ps], pos_vec % ps


def _gqa_decode_paged(p, cfg, x, pos, cache, *, theta):
    B = x.shape[0]
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q, k, v = _qkv(p, cfg, x, pos_vec[:, None], theta, None, ())
    phys, off = _write_page_slots(cache, pos_vec)
    rows = torch.arange(B, device=x.device)
    cache.pos_ids.index_put_((rows, pos_vec), pos_vec)
    # paged layers are never windowed: no window term
    y = _gqa_attend(p, cfg, x, q, k, v, cache, pos_vec, 0,
                    lambda field, new: _paged_put(cache, field, new, phys,
                                                  off),
                    lambda field: _paged_gather(cache, field))
    return y, cache


def _mla_decode_paged(p, cfg, x, pos, cache):
    B = x.shape[0]
    pos_vec = slot_positions(pos, B, x.device)                   # (B,)
    q_nope, q_rope, c_new, kr_new = _mla_qkr(p, cfg, x, pos_vec[:, None],
                                             None, ())
    phys, off = _write_page_slots(cache, pos_vec)
    _paged_put(cache, "k_rope", kr_new[:, 0], phys, off)
    cache.length.copy_(pos_vec + 1)
    if isinstance(cache, PagedQuantMlaCache):
        cq, cs = _quantize_latent(c_new, cache.c_scale.shape[-1])
        _paged_put(cache, "c_kv", cq, phys, off)
        _paged_put(cache, "c_scale", cs, phys, off)
        c_att = _dequantize_latent(_paged_gather(cache, "c_kv"),
                                   _paged_gather(cache, "c_scale"), x.dtype)
    else:
        _paged_put(cache, "c_kv", c_new[:, 0], phys, off)
        c_att = _paged_gather(cache, "c_kv")
    return _mla_attend(p, cfg, x, q_nope, q_rope, c_att,
                       _paged_gather(cache, "k_rope"), pos_vec), cache


# ------------------------------------------------------------ engine helpers
# Index vectors have a fixed length, padded with page 0 (scratch): the
# padding's scatters write into the scratch sink and its gathers read
# lanes the callers mask.

def paged_copy_pages(cache, src: Tensor, dst: Tensor):
    """``pool[dst[i]] = pool[src[i]]`` on every pool leaf, in place — the
    copy-on-write service.  A gather, then a scatter (never an aliasing
    copy), so the padding pairs (scratch, scratch) are harmless."""
    for f in _POOL_FIELDS[type(cache)]:
        pool = getattr(cache, f)
        pool.index_put_((dst,), pool[src])
    return cache


def paged_write_row(cache, row, slot: int, lps: Tensor, pids: Tensor):
    """Scatter a B=1 contiguous row cache into pool pages (admission):
    logical page ``lps[i]`` of the row lands in physical page ``pids[i]``
    (pad with (0, scratch)).  ``row`` is the matching contiguous kind with
    L = P·ps; the slot's bookkeeping (pos_ids / length) is copied whole.
    The caller updates ``table``."""
    ps = getattr(cache, _POOL_FIELDS[type(cache)][0]).shape[1]
    for f in _POOL_FIELDS[type(cache)]:
        rleaf = getattr(row, f)                                  # (1, L, ...)
        pages = rleaf[0].reshape(-1, ps, *rleaf.shape[2:])[lps]
        getattr(cache, f).index_put_((pids,), pages)
    if isinstance(cache, (PagedGqaCache, PagedQuantGqaCache)):
        cache.pos_ids[slot] = row.pos_ids[0]
    else:
        cache.length[slot] = row.length[0]
    return cache


def paged_prefix_to_row(cache, row, pids: Tensor, n_tok: int):
    """Materialize a shared prefix into a B=1 contiguous row cache, in
    place: ``pids`` (P,) covers the whole row (pad with scratch); lanes
    ≥ ``n_tok`` hold garbage the tail prefill overwrites or masks."""
    ps = getattr(cache, _POOL_FIELDS[type(cache)][0]).shape[1]
    for f in _POOL_FIELDS[type(cache)]:
        pool = getattr(cache, f)
        getattr(row, f).copy_(pool[pids].reshape(1, -1, *pool.shape[2:]))
    if isinstance(cache, (PagedGqaCache, PagedQuantGqaCache)):
        lanes = torch.arange(pids.shape[0] * ps, device=pids.device)
        row.pos_ids.copy_(torch.where(lanes < n_tok, lanes, -1)[None])
    else:
        row.length.fill_(n_tok)
    return row
