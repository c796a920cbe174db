"""Plain PyTorch reference of a decoder-only transformer (GQA with
optional qk-norm, rotary positions, a gated SiLU MLP or a top-k MoE), in
float32 with TF32 off.  It imports nothing of the program: it follows the
published description of Llama/Mistral- and Qwen3-MoE-style blocks.

Weights come as plain dicts of dense tensors in (in, out) layout (a
pruned kernel is the dense kernel times its keep mask).  ``cast`` is
applied to both operands of every product; the identity gives the
reference, ``fp8_cast`` the control that computes in float8.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor
EPS = 1e-6


def setup_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def identity(x: Tensor) -> Tensor:
    return x


def fp8_cast(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to 448), back in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def mm(x: Tensor, w: Tensor, cast=identity) -> Tensor:
    return cast(x) @ cast(w)


def rmsnorm(x: Tensor, scale: Tensor) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * scale


def rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """Rotary positions on x (S, H, D): the two halves of each head are
    the real and imaginary parts."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg, w: dict, x: Tensor, cast=identity, tape=None) -> Tensor:
    """Causal GQA self-attention over sequences x (N, S, d), each at
    positions 0..S−1 → (N·S, d)."""
    N, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x2 = x.reshape(N * S, -1)
    if tape is not None:
        tape["wq"] = tape["wk"] = tape["wv"] = x2
    q = mm(x2, w["wq"]["w"], cast).view(N, S, H, D)
    k = mm(x2, w["wk"]["w"], cast).view(N, S, Hkv, D)
    v = mm(x2, w["wv"]["w"], cast).view(N, S, Hkv, D)
    if cfg.qk_norm:
        q, k = rmsnorm(q, w["qnorm"]["scale"]), rmsnorm(k, w["knorm"]["scale"])
    pos = torch.arange(S, device=x.device)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    g = H // Hkv
    out = torch.empty((N, S, H * D), dtype=x.dtype, device=x.device)
    for s in range(N):                    # one sequence's scores at a time
        qh = rope(q[s], pos, cfg.rope_theta).permute(1, 0, 2)    # (H, S, D)
        kh = rope(k[s], pos, cfg.rope_theta).permute(1, 0, 2)
        kh = kh.repeat_interleave(g, 0)
        vh = v[s].permute(1, 0, 2).repeat_interleave(g, 0)
        scores = torch.bmm(cast(qh), cast(kh).transpose(1, 2)) / D ** 0.5
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        out[s] = torch.bmm(cast(probs), cast(vh)).permute(1, 0, 2).reshape(
            S, H * D)
    out = out.reshape(N * S, H * D)
    if tape is not None:
        tape["wo"] = out
    return mm(out, w["wo"]["w"], cast)


def mlp(w: dict, x: Tensor, cast=identity, tape=None) -> Tensor:
    h = torch.nn.functional.silu(mm(x, w["gate"]["w"], cast)) * \
        mm(x, w["up"]["w"], cast)
    if tape is not None:
        tape["gate"] = tape["up"] = x
        tape["down"] = h
    return mm(h, w["down"]["w"], cast)


def moe(cfg, w: dict, x: Tensor, cast=identity, capacity: int = 0,
        tape=None) -> Tensor:
    """Top-k MoE over tokens x (T, d): softmax router probabilities, the k
    most probable experts (ties to the lower expert), gates renormalised
    over the kept assignments.  With ``capacity`` > 0 an expert keeps only
    its first ``capacity`` assignments in token order and the rest are
    dropped; 0 keeps every assignment.  ``tape`` gets each expert's kept
    inputs under ("gate"|"up"|"down", e)."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(mm(x, w["router"]["w"], cast), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    sel = torch.zeros(T, E, dtype=torch.bool, device=x.device)
    sel.scatter_(1, top, True)
    if capacity:
        sel &= (torch.cumsum(sel.to(torch.int64), 0) - 1) < capacity
    gates = torch.where(sel, probs, 0.0)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-30)
    y = torch.zeros_like(x)
    for e in torch.nonzero(sel.any(0)).flatten().tolist():
        rows = torch.nonzero(sel[:, e]).flatten()
        xe = x[rows]
        h = torch.nn.functional.silu(mm(xe, w["gate"]["w"][e], cast)) * \
            mm(xe, w["up"]["w"][e], cast)
        if tape is not None:
            tape[("gate", e)] = tape[("up", e)] = xe
            tape[("down", e)] = h
        y.index_add_(0, rows, mm(h, w["down"]["w"][e], cast) * gates[rows, e:e + 1])
    return y


def block(cfg, w: dict, x: Tensor, *, moe_layer: bool, cast=identity,
          capacity: int = 0, tape=None) -> Tensor:
    """One pre-norm block over sequences x (N, S, d) or one sequence
    (S, d); the MoE routes the N·S tokens of the call together, in order
    (the capacity is per call)."""
    shape = x.shape
    x = x.reshape(-1, *shape[-2:])
    at = None if tape is None else {}
    h = x.reshape(-1, shape[-1]) + attention(
        cfg, w["attn"], rmsnorm(x, w["ln1"]["scale"]), cast, at)
    hn = rmsnorm(h, w["ln2"]["scale"])
    ft = None if tape is None else {}
    if moe_layer:
        f = moe(cfg, w["moe"], hn, cast, capacity, ft)
    else:
        f = mlp(w["mlp"], hn, cast, ft)
    if tape is not None:
        tape.update({("attn", n): v for n, v in at.items()})
        kind = "moe" if moe_layer else "mlp"
        tape.update({(kind,) + (n if isinstance(n, tuple) else (n,)): v
                     for n, v in ft.items()})
    return (h + f).reshape(shape)


def logits(w_head: dict, x: Tensor, cast=identity) -> Tensor:
    return mm(rmsnorm(x, w_head["final_norm"]["scale"]), w_head["lm_head"]["w"],
              cast)
