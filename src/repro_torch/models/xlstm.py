"""xLSTM blocks — mLSTM (matrix memory, parallel form) and sLSTM (scalar
memory, a true recurrence) per Beck et al. 2024 (port of
``repro/models/xlstm.py``), in the 7:1 mLSTM:sLSTM pattern of xlstm-1.3b.

The mLSTM forward is the stabilized parallel (attention-like) form over the
sequence; decode carries the O(1) recurrent state (C, n, m).  The sLSTM
forward is a Python loop over the sequence, one per-head recurrence a step.

Prunable linears: up/down projections, q/k/v and the gate pre-activations
(i/f/z/o).  The per-head recurrent R matrices of sLSTM are not pruned: their
inputs live inside the recurrence, where no calibration tape reaches.

Caches are dataclasses; decode writes the next state into the cache's own
tensors in place and returns the same object.  ``MlstmCache`` stores C
and n in bf16 when ``cfg.kv_cache_dtype`` is "bf16" or "int8" and updates
them in fp32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Tensor = torch.Tensor
_F32 = torch.float32


# ==========================================================================
# mLSTM
# ==========================================================================
def mlstm_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    d = cfg.d_model
    di = cfg.xlstm_proj_factor * d                       # inner width
    kw = dict(dtype=dtype, device=device)
    return {
        "up": L.linear_params(gen, d, 2 * di, **kw),      # x-branch + gate
        "wq": L.linear_params(gen, di, di, **kw),
        "wk": L.linear_params(gen, di, di, **kw),
        "wv": L.linear_params(gen, di, di, **kw),
        "wi": L.linear_params(gen, di, cfg.num_heads, **kw),
        "wf": L.linear_params(gen, di, cfg.num_heads, **kw),
        "onorm": L.rmsnorm_params(di, **kw),
        "down": L.linear_params(gen, di, d, **kw),
    }


def _mlstm_qkvif(p, cfg, x, tape, path):
    B, S, _ = x.shape
    H = cfg.num_heads
    hd = cfg.xlstm_proj_factor * cfg.d_model // H
    xb, gate = L.dense(p["up"], x, tape, path + ("up",)).chunk(2, dim=-1)
    xb = F.silu(xb)
    q = L.dense(p["wq"], xb, tape, path + ("wq",)).reshape(B, S, H, hd)
    k = L.dense(p["wk"], xb, tape, path + ("wk",)).reshape(B, S, H, hd) / \
        math.sqrt(hd)
    v = L.dense(p["wv"], xb, tape, path + ("wv",)).reshape(B, S, H, hd)
    i_pre = L.dense(p["wi"], xb, tape, path + ("wi",))           # (B,S,H)
    f_pre = L.dense(p["wf"], xb, tape, path + ("wf",))
    return xb, gate, q, k, v, i_pre.to(_F32), f_pre.to(_F32)


def mlstm_forward(p, cfg, x: Tensor, *, tape=None, path=()) -> Tensor:
    """Stabilized parallel mLSTM (quadratic in the sequence)."""
    B, S, _ = x.shape
    di = cfg.xlstm_proj_factor * cfg.d_model
    _, gate, q, k, v, i_pre, f_pre = _mlstm_qkvif(p, cfg, x, tape, path)

    Fc = torch.cumsum(F.logsigmoid(f_pre), dim=1)                # (B,S,H)
    # D[t, s] = F_t − F_s + i_s for s ≤ t, −inf above the diagonal; the
    # diagonal is in every row, so the row max (the stabilizer) is finite
    Dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
    Dmat = torch.where(tri[None, :, :, None], Dmat, float("-inf"))
    mstab = Dmat.amax(dim=2, keepdim=True)                       # (B,S,1,H)
    Dexp = torch.exp(Dmat - mstab)                               # (B,S,S,H)

    scores = torch.einsum("bthd,bshd->btsh", q.to(_F32), k.to(_F32))
    w = scores * Dexp
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-mstab[:, :, 0]))
    y = torch.einsum("btsh,bshd->bthd", w, v.to(_F32))
    y = y / (norm[..., None] + 1e-6)
    y = y.reshape(B, S, di).to(x.dtype)
    y = L.rmsnorm(p["onorm"], y) * torch.sigmoid(gate)
    return L.dense(p["down"], y, tape, path + ("down",))


@dataclasses.dataclass
class MlstmCache:
    C: Tensor      # (B, H, hd, hd) matrix memory
    n: Tensor      # (B, H, hd) normalizer
    m: Tensor      # (B, H) stabilizer, fp32


def mlstm_cache_init(cfg, batch: int, device="cpu") -> MlstmCache:
    """The zero state: C and n in bf16 when ``cfg.kv_cache_dtype`` is
    "bf16" or "int8" (the dominant decode stream, hd²·H a block), else
    fp32; m at −1e30 in fp32."""
    H = cfg.num_heads
    hd = cfg.xlstm_proj_factor * cfg.d_model // H
    dt = (torch.bfloat16 if cfg.kv_cache_dtype in ("bf16", "int8")
          else _F32)
    return MlstmCache(
        C=torch.zeros((batch, H, hd, hd), dtype=dt, device=device),
        n=torch.zeros((batch, H, hd), dtype=dt, device=device),
        m=torch.full((batch, H), -1e30, dtype=_F32, device=device))


def mlstm_decode(p, cfg, x: Tensor, cache: MlstmCache):
    B = x.shape[0]
    di = cfg.xlstm_proj_factor * cfg.d_model
    _, gate, q, k, v, i_pre, f_pre = _mlstm_qkvif(p, cfg, x, None, ())
    q, k, v = (t[:, 0].to(_F32) for t in (q, k, v))             # (B,H,hd)
    i_t, f_t = i_pre[:, 0], f_pre[:, 0]                          # (B,H)

    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + cache.m, i_t)
    fa = torch.exp(logf + cache.m - m_new)
    ia = torch.exp(i_t - m_new)
    C = fa[..., None, None] * cache.C.to(_F32) \
        + ia[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fa[..., None] * cache.n.to(_F32) + ia[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))
    y = (num / (den[..., None] + 1e-6)).reshape(B, 1, di).to(x.dtype)
    y = L.rmsnorm(p["onorm"], y) * torch.sigmoid(gate)
    out = L.dense(p["down"], y)
    cache.C.copy_(C.to(cache.C.dtype))
    cache.n.copy_(n.to(cache.n.dtype))
    cache.m.copy_(m_new)
    return out, cache


# ==========================================================================
# sLSTM
# ==========================================================================
def slstm_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    kw = dict(dtype=dtype, device=device)
    p = {"onorm": L.rmsnorm_params(d, **kw)}
    for g in ("wi", "wf", "wz", "wo"):
        p[g] = L.linear_params(gen, d, d, **kw)
    for g in ("ri", "rf", "rz", "ro"):
        # block-diagonal per-head recurrence (H, hd, hd)
        r = torch.randn((H, hd, hd), generator=gen, device=device,
                        dtype=_F32) * (1.0 / hd) ** 0.5
        p[g] = {"w": r.to(dtype)}
    di = cfg.xlstm_proj_factor * d
    p["up"] = L.linear_params(gen, d, 2 * di, **kw)
    p["down"] = L.linear_params(gen, di, d, **kw)
    return p


@dataclasses.dataclass
class SlstmCache:
    c: Tensor   # (B, H, hd) cell
    n: Tensor   # (B, H, hd) normalizer
    h: Tensor   # (B, H, hd) hidden
    m: Tensor   # (B, H, hd) stabilizer


def slstm_cache_init(cfg, batch: int, device="cpu") -> SlstmCache:
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    z = torch.zeros(shape, dtype=_F32, device=device)
    return SlstmCache(z, z.clone(), z.clone(),
                      torch.full(shape, -1e30, dtype=_F32, device=device))


def _slstm_cell(p, xi, xf, xz, xo, st: SlstmCache) -> SlstmCache:
    """One recurrence step; x* are the gates' pre-activations (B, H, hd)
    in fp32."""
    def rec(g):
        return torch.einsum("bhd,hde->bhe", st.h, p[g]["w"].to(_F32))

    i_pre = xi + rec("ri")
    f_pre = xf + rec("rf")
    z = torch.tanh(xz + rec("rz"))
    o = torch.sigmoid(xo + rec("ro"))
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + st.m, i_pre)
    fa = torch.exp(logf + st.m - m_new)
    ia = torch.exp(i_pre - m_new)
    c = fa * st.c + ia * z
    n = torch.clamp(fa * st.n + ia, min=1e-6)
    return SlstmCache(c, n, o * (c / n), m_new)


def _slstm_out(p, x: Tensor, h: Tensor, tape, path) -> Tensor:
    """The sLSTM block's tail: onorm, up, gated gelu, down."""
    h = L.rmsnorm(p["onorm"], h.to(x.dtype))
    a, b = L.dense(p["up"], h, tape, path + ("up",)).chunk(2, dim=-1)
    return L.dense(p["down"], L.act_fn("gelu")(a) * b, tape,
                   path + ("down",))


def slstm_forward(p, cfg, x: Tensor, *, tape=None, path=()) -> Tensor:
    """A sequential loop over S (no parallel form exists)."""
    B, S, d = x.shape
    H = cfg.num_heads
    pre = {g: L.dense(p[g], x, tape, path + (g,))
           .reshape(B, S, H, d // H).to(_F32)
           for g in ("wi", "wf", "wz", "wo")}
    st = slstm_cache_init(cfg, B, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, pre["wi"][:, t], pre["wf"][:, t],
                         pre["wz"][:, t], pre["wo"][:, t], st)
        hs.append(st.h)
    h = torch.stack(hs, dim=1).reshape(B, S, d)
    return _slstm_out(p, x, h, tape, path)


def slstm_decode(p, cfg, x: Tensor, cache: SlstmCache):
    B, _, d = x.shape
    H = cfg.num_heads
    pre = {g: L.dense(p[g], x).reshape(B, H, d // H).to(_F32)
           for g in ("wi", "wf", "wz", "wo")}
    st = _slstm_cell(p, pre["wi"], pre["wf"], pre["wz"], pre["wo"], cache)
    for f in ("c", "n", "h", "m"):
        getattr(cache, f).copy_(getattr(st, f))
    return _slstm_out(p, x, st.h.reshape(B, 1, d), None, ()), cache


def xlstm_linear_paths(p: dict, path=()) -> list[tuple]:
    """Prunable feed-forward linears (the R matrices excluded)."""
    return [path + (name, "w")
            for name in ("up", "wq", "wk", "wv", "wi", "wf", "wz", "wo",
                         "down") if name in p]
