"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``).

Dispatch: flatten tokens, route top-k, sort (token, expert) pairs by expert,
scatter the first C survivors per expert into an (E, C, d) buffer (overflow
assignments go to a trash expert and are dropped), run the gated FFN as
batched matmuls over the stacked expert kernels, gather back and combine
with the router weights renormalised over the assignments that survived the
drop.

Expert kernels are stacked (E, d_in, d_out); the pruning driver addresses
slice e as (..., 'w', e).  With a tape, the dispatch threads the (E, C) row
validity mask into it, so each expert's Hessian counts only the tokens
routed to it and a never-routed expert fails ``finalize(min_count=)``.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L

Tensor = torch.Tensor


def moe_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": L.linear_params(gen, d, E, **kw),          # kept dense
        "gate": L.stacked_linear_params(gen, E, d, f, **kw),
        "up": L.stacked_linear_params(gen, E, d, f, **kw),
        "down": L.stacked_linear_params(gen, E, f, d, **kw),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {
            "gate": L.linear_params(gen, d, fs, **kw),
            "up": L.linear_params(gen, d, fs, **kw),
            "down": L.linear_params(gen, fs, d, **kw),
        }
    return p


def capacity(num_tokens: int, k: int, num_experts: int,
             capacity_factor: float = 1.25) -> int:
    c = int(num_tokens * k / num_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_ffn(p: dict, x: Tensor, cfg, *, tape=None, path=()) -> Tensor:
    """x: (B, S, d) → (B, S, d)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = capacity(T, k, E, cfg.capacity_factor)
    xt = x.reshape(T, d)
    dev = x.device

    # ---- routing (the router stays dense and unpruned) --------------------
    logits = xt @ p["router"]["w"]                             # (T, E)
    gates, ids = torch.topk(torch.softmax(logits.to(torch.float32), dim=-1),
                            k, dim=-1)

    # ---- sort-based dispatch ----------------------------------------------
    flat_ids = ids.reshape(-1)                                 # (T*k,)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    s_ids, s_tok = flat_ids[order], flat_tok[order]
    grp_start = torch.searchsorted(s_ids, s_ids, side="left")
    idx_in_grp = torch.arange(T * k, device=dev) - grp_start
    keep = idx_in_grp < C
    # dropped assignments land in the trash expert E, sliced off below
    dst_e = torch.where(keep, s_ids, E)
    dst_c = torch.where(keep, idx_in_grp, 0)
    buf = torch.zeros((E + 1, C, d), dtype=xt.dtype, device=dev)
    buf[dst_e, dst_c] = xt[s_tok]
    buf = buf[:E]

    # ---- top-k renorm over the SURVIVING assignments ----------------------
    keep_tk = torch.empty((T * k,), dtype=torch.bool, device=dev)
    keep_tk[order] = keep
    gates = torch.where(keep_tk.reshape(T, k), gates, 0.0)
    denom = gates.sum(dim=-1, keepdim=True)
    gates = gates / torch.where(denom > 0.0, denom, 1.0)  # all dropped: 0

    # ---- expert computation -------------------------------------------------
    valid = None
    if tape is not None:
        valid = torch.zeros((E + 1, C), dtype=torch.bool, device=dev)
        valid[dst_e, dst_c] = keep
        valid = valid[:E]
    act = L.act_fn(cfg.act)
    h = act(L.stacked_dense(p["gate"], buf, tape, path + ("gate",), valid)) * \
        L.stacked_dense(p["up"], buf, tape, path + ("up",), valid)
    out_buf = L.stacked_dense(p["down"], h, tape, path + ("down",), valid)

    # ---- gather back + combine --------------------------------------------
    y_sorted = torch.where(keep[:, None],
                           out_buf[dst_e.clamp(0, E - 1), dst_c], 0.0)
    y_flat = torch.empty((T * k, d), dtype=xt.dtype, device=dev)
    y_flat[order] = y_sorted.to(xt.dtype)
    y = (y_flat.reshape(T, k, d) * gates[..., None].to(xt.dtype)).sum(dim=1)

    # ---- shared experts (always on) ----------------------------------------
    if "shared" in p:
        sp = p["shared"]
        hs = act(L.dense(sp["gate"], xt, tape, path + ("shared", "gate"))) * \
            L.dense(sp["up"], xt, tape, path + ("shared", "up"))
        y = y + L.dense(sp["down"], hs, tape, path + ("shared", "down"))

    return y.reshape(B, S, d)


def moe_linear_paths(p: dict, path=()) -> list[tuple]:
    """Prunable paths: every expert slice of gate/up/down + the shared FFN."""
    E = p["gate"]["w"].shape[0]
    paths = []
    for name in ("gate", "up", "down"):
        paths += [path + (name, "w", e) for e in range(E)]
    if "shared" in p:
        paths += [path + ("shared", n, "w") for n in ("gate", "up", "down")]
    return paths
