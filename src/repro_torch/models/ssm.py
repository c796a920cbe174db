"""Mamba2-style selective state-space block, for Zamba2 (port of
``repro/models/ssm.py``).

State-space recurrence per head h with scalar decay (SSD formulation):

    s_t = a_t · s_{t-1} + dt_t · B_t ⊗ x_t        s ∈ R^{d_head × d_state}
    y_t = s_t · C_t + D ⊙ x_t

``a_t = exp(-exp(A_log)·dt_t)`` is a scalar per head and step.  The JAX
package runs the recurrence as an associative scan; here it is a sequential
fp32 loop over the sequence, which computes the same recurrence with the
sums in another order.  y_t is taken inside the loop, so only one step's
state (B, H, hd, st) is alive at a time — the whole (B, S, H, hd, st)
history is 1.9 GB at zamba2's full width and 8 × 128 tokens.  (The closed
form through cumulative products of a_t is avoided: the products
underflow.)  Single-token decode carries (s, conv) state: O(1) a token.

Prunable linears: in_proj (z, x, B, C and dt fused) and out_proj.  The conv
kernel, A_log, D and dt_bias are not linear-layer weights and stay dense.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Tensor = torch.Tensor


def mamba2_dims(cfg) -> tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def mamba2_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    d = cfg.d_model
    d_inner, heads = mamba2_dims(cfg)
    ng, st = cfg.ssm_groups, cfg.ssm_state
    # fused in_proj: [z (d_inner), x (d_inner), B (ng·st), C (ng·st), dt (heads)]
    d_in_proj = 2 * d_inner + 2 * ng * st + heads
    conv_dim = d_inner + 2 * ng * st
    kw = dict(dtype=dtype, device=device)
    conv = torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                       device=device, dtype=torch.float32) * 0.1
    return {
        "in_proj": L.linear_params(gen, d, d_in_proj, **kw),
        "out_proj": L.linear_params(gen, d_inner, d, **kw),
        "conv_w": conv.to(dtype),
        "A_log": torch.zeros((heads,), **kw),
        "D": torch.ones((heads,), **kw),
        "dt_bias": torch.zeros((heads,), **kw),
    }


def _split_proj(cfg, zxbcdt: Tensor):
    d_inner, heads = mamba2_dims(cfg)
    gs = cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, gs, gs, heads], dim=-1)


def _causal_conv(seq: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal conv: seq (B, S, C), w (K, C); the K taps summed in
    order, as the JAX package sums them."""
    K, S = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (torch's softplus switches to x
    above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _heads(t: Tensor, heads: int, ng: int, dim: int) -> Tensor:
    """Groups → heads: each of the ng groups repeated heads/ng times in
    place (``jnp.repeat``, i.e. repeat_interleave)."""
    return torch.repeat_interleave(t, heads // ng, dim=dim)


def mamba2_forward(p, cfg, x: Tensor, *, tape=None, path=()) -> Tensor:
    """Full-sequence forward.  x (B, S, d) → (B, S, d)."""
    B, S, _ = x.shape
    d_inner, heads = mamba2_dims(cfg)
    ng, st, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32

    zxbcdt = L.dense(p["in_proj"], x, tape, path + ("in_proj",))
    z, xin, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    conv_out = F.silu(_causal_conv(torch.cat([xin, Bc, Cc], dim=-1),
                                   p["conv_w"]))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, ng * st, ng * st], dim=-1)

    dt = _softplus(dt.to(f32) + p["dt_bias"])                    # (B,S,H)
    a = torch.exp(-torch.exp(p["A_log"].to(f32))[None, None] * dt)
    xh = xin.reshape(B, S, heads, hd).to(f32)
    Bh = _heads(Bc.reshape(B, S, ng, st), heads, ng, 2).to(f32)
    Ch = _heads(Cc.reshape(B, S, ng, st), heads, ng, 2).to(f32)
    dx = dt[..., None] * xh                                      # (B,S,H,hd)

    s = torch.zeros((B, heads, hd, st), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        s = a[:, t, :, None, None] * s + \
            dx[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhdn,bhn->bhd", s, Ch[:, t]))
    y = torch.stack(ys, dim=1)                                   # (B,S,H,hd)
    y = y + p["D"].to(f32)[None, None, :, None] * xh
    y = (y.reshape(B, S, d_inner) * F.silu(z.to(f32))).to(x.dtype)
    return L.dense(p["out_proj"], y, tape, path + ("out_proj",))


@dataclasses.dataclass
class MambaCache:
    ssm: Tensor       # (B, H, hd, st) fp32
    conv: Tensor      # (B, K-1, conv_dim) model dtype


def mamba2_cache_init(cfg, batch: int, dtype=torch.float32,
                      device="cpu") -> MambaCache:
    d_inner, heads = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return MambaCache(
        ssm=torch.zeros((batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device))


def mamba2_decode(p, cfg, x: Tensor, cache: MambaCache):
    """One-token step.  x (B, 1, d) → (y (B, 1, d), ``cache``): the next
    state is written into the cache's own tensors in place, so a captured
    step keeps reading and writing the same buffers."""
    B = x.shape[0]
    d_inner, heads = mamba2_dims(cfg)
    ng, st, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    f32 = torch.float32

    zxbcdt = L.dense(p["in_proj"], x)
    z, xin, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                   # (B,1,conv)
    window = torch.cat([cache.conv, conv_in], dim=1)             # (B,K,conv)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, ng * st, ng * st], dim=-1)

    dt = _softplus(dt[:, 0].to(f32) + p["dt_bias"])              # (B,H)
    a = torch.exp(-torch.exp(p["A_log"].to(f32))[None] * dt)
    xh = xin.reshape(B, heads, hd).to(f32)
    Bh = _heads(Bc.reshape(B, ng, st), heads, ng, 1).to(f32)
    Ch = _heads(Cc.reshape(B, ng, st), heads, ng, 1).to(f32)

    s = a[..., None, None] * cache.ssm + \
        (dt[..., None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhdn,bhn->bhd", s, Ch)
    y = y + p["D"].to(f32)[None, :, None] * xh
    y = (y.reshape(B, 1, d_inner) * F.silu(z.to(f32))).to(x.dtype)
    out = L.dense(p["out_proj"], y)
    cache.ssm.copy_(s)
    cache.conv.copy_(window[:, 1:])
    return out, cache
