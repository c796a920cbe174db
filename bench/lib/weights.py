"""Weights of a decoder-only transformer (dense or MoE, GQA), drawn on the
device from the seed, leaf by leaf from a stream of their own, in the
port's parameter tree ((in, out) kernels, expert stacks (E, in, out)).

Every leaf has its own generator, so any block can be drawn again alone:
the references draw the same weights again, layer by layer, after the
program's state is freed.  The laws are the port's initialisers': He
normal with fan-in, embeddings N(0, 0.02²), norm scales 1.
"""
from __future__ import annotations

from bench.lib.traffic import sub_seed

# leaf streams: the salt of each leaf of a block
_LEAVES = ("wq", "wk", "wv", "wo", "router", "gate", "up", "down")


def _normal(torch, shape, std: float, seed: int, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return w.mul_(std)


def head_weights(torch, cfg, seed: int, device, dtype) -> dict:
    """The embedding table, the final norm and the untied LM head."""
    d, V = cfg.d_model, cfg.vocab_size
    out = {"embed": {"table": _normal(torch, (V, d), 0.02,
                                      sub_seed(seed, 10, 0), device, dtype)},
           "final_norm": {"scale": torch.ones(d, device=device,
                                              dtype=dtype)}}
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": _normal(torch, (d, V), (2.0 / d) ** 0.5,
                                       sub_seed(seed, 10, 1), device, dtype)}
    return out


def block_weights(torch, cfg, i: int, seed: int, device, dtype) -> dict:
    """Block i's dense weights."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def lin(name, d_in, d_out, lead=()):
        s = sub_seed(seed, 100 + i, _LEAVES.index(name))
        return {"w": _normal(torch, (*lead, d_in, d_out), (2.0 / d_in) ** 0.5,
                             s, device, dtype)}

    def ones(n):
        return {"scale": torch.ones(n, device=device, dtype=dtype)}

    attn = {"wq": lin("wq", d, hq), "wk": lin("wk", d, hkv),
            "wv": lin("wv", d, hkv), "wo": lin("wo", hq, d)}
    if cfg.qk_norm:
        attn["qnorm"], attn["knorm"] = ones(hd), ones(hd)
    blk = {"ln1": ones(d), "ln2": ones(d), "attn": attn}
    if cfg.num_experts and i >= cfg.num_dense_layers:
        E, f = cfg.num_experts, cfg.moe_d_ff
        blk["moe"] = {"router": lin("router", d, E),
                      "gate": lin("gate", d, f, (E,)),
                      "up": lin("up", d, f, (E,)),
                      "down": lin("down", f, d, (E,))}
    else:
        f = cfg.d_ff
        blk["mlp"] = {"gate": lin("gate", d, f), "up": lin("up", d, f),
                      "down": lin("down", f, d)}
    return blk


def nm_prune_mask(torch, w, n: int = 2, m: int = 4):
    """Magnitude n:m mask of w (..., in, out) → bool, True = pruned: in
    every group of m consecutive inputs of an output, the n smallest |w|,
    ties to the lower index (a rank by comparisons, so the same weights
    always give the same mask)."""
    *lead, d_in, d_out = w.shape
    a = w.abs().reshape(*lead, d_in // m, m, d_out)
    rank = torch.zeros(a.shape, dtype=torch.int8, device=w.device)
    for j in range(m):
        aj = a.select(-2, j).unsqueeze(-2)
        before = torch.arange(m, device=w.device).view(m, 1) > j
        rank += ((aj < a) | ((aj == a) & before)).to(torch.int8)
    return (rank < n).reshape(w.shape)


def masked_paths(cfg, i: int) -> list:
    """The (path, leaf) pairs of block i that serve 2:4-compressed: the
    attention projections and the expert stacks or the MLP (the router
    stays dense)."""
    attn = [(("attn", n), "w") for n in ("wq", "wk", "wv", "wo")]
    if cfg.num_experts and i >= cfg.num_dense_layers:
        return attn + [(("moe", n), "w") for n in ("gate", "up", "down")]
    return attn + [(("mlp", n), "w") for n in ("gate", "up", "down")]
