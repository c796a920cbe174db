"""Decoder-only transformer LM — the dense (tinyllama), MoE (qwen3-moe) and
MLA + MoE (deepseek-v3) paths of ``repro/models/transformer.py``.

Model protocol, as in the JAX package:
    init(gen)                                   → params
    forward(params, batch, tape=None)           → logits (B, S, V)
    loss(params, batch)                         → scalar CE
    init_cache(batch, max_len)                  → {layer: cache} — GQA or
                                                  MLA, int8 when
                                                  cfg.kv_cache_dtype is "int8"
    decode_step(params, cache, tokens, pos)     → (logits (B, 1, V), cache)
    embed_batch / block / num_blocks / block_linear_paths   (Alg.-3 adapter)
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

Tensor = torch.Tensor


class TransformerLM:
    def __init__(self, cfg, *, device="cuda"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"{cfg.name}: the port runs dense and MoE "
                             "models only so far")
        if cfg.norm != "rmsnorm":
            raise ValueError(f"{cfg.name}: norm {cfg.norm!r} is not ported")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---------------------------------------------------------------- init
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen`` (a generator on the model's
        device), in the JAX tree's paths and (in, out) kernel layout."""
        cfg, dt, dev = self.cfg, self.cfg.torch_dtype, self.device
        params: dict[str, Any] = {
            "embed": L.embedding_params(gen, cfg.vocab_size, cfg.d_model, dt,
                                        dev),
            "final_norm": L.rmsnorm_params(cfg.d_model, dt, dev),
            "blocks": {},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.linear_params(gen, cfg.d_model,
                                                cfg.vocab_size, dtype=dt,
                                                device=dev)
        for i in range(cfg.num_layers):
            blk = {
                "ln1": L.rmsnorm_params(cfg.d_model, dt, dev),
                "ln2": L.rmsnorm_params(cfg.d_model, dt, dev),
                "attn": (A.mla_params(gen, cfg, dt, dev) if cfg.uses_mla
                         else A.gqa_params(gen, cfg, dt, dev)),
            }
            if cfg.layer_is_moe(i):
                blk["moe"] = M.moe_params(gen, cfg, dt, dev)
            else:
                blk["mlp"] = {
                    n: L.linear_params(gen, di, do, dtype=dt, device=dev)
                    for n, di, do in (("gate", cfg.d_model, cfg.d_ff),
                                      ("up", cfg.d_model, cfg.d_ff),
                                      ("down", cfg.d_ff, cfg.d_model))}
            params["blocks"][i] = blk
        return params

    # ------------------------------------------------------------- helpers
    def _theta(self, i: int) -> float:
        cfg = self.cfg
        if cfg.sliding_window and not cfg.layer_is_global(i) and \
                cfg.rope_theta_local:
            return cfg.rope_theta_local
        return cfg.rope_theta

    def _window(self, i: int) -> int:
        return 0 if self.cfg.layer_is_global(i) else self.cfg.sliding_window

    def _ffn(self, i, blk, x, tape, path):
        """Layer i's feed-forward: the MoE FFN or the dense gated MLP."""
        if self.cfg.layer_is_moe(i):
            return M.moe_ffn(blk["moe"], x, self.cfg, tape=tape,
                             path=path + ("moe",))
        act = L.act_fn(self.cfg.act)
        mlp = blk["mlp"]
        h = act(L.dense(mlp["gate"], x, tape, path + ("mlp", "gate"))) * \
            L.dense(mlp["up"], x, tape, path + ("mlp", "up"))
        return L.dense(mlp["down"], h, tape, path + ("mlp", "down"))

    def _head(self, params, h) -> Tensor:
        h = L.rmsnorm(params["final_norm"], h)
        if self.cfg.tie_embeddings:
            return L.unembed(params["embed"], h)
        return h @ params["lm_head"]["w"]

    # ------------------------------------------------------ blockwise parts
    def embed_batch(self, params, batch) -> dict:
        """→ carry {h, positions}."""
        tokens = batch["tokens"].to(self.device)
        h = L.embed(params["embed"], tokens)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        return {"h": h, "positions": positions}

    def num_blocks(self) -> int:
        return self.cfg.num_layers

    def block(self, params, i: int, carry: dict, tape=None) -> dict:
        blk = params["blocks"][i]
        path = ("blocks", i)
        h, pos = carry["h"], carry["positions"]
        hn = L.rmsnorm(blk["ln1"], h)
        if self.cfg.uses_mla:
            attn = A.mla_forward(blk["attn"], self.cfg, hn, pos, tape=tape,
                                 path=path + ("attn",))
        else:
            attn = A.gqa_forward(blk["attn"], self.cfg, hn, pos,
                                 theta=self._theta(i),
                                 window=self._window(i), tape=tape,
                                 path=path + ("attn",))
        h = h + attn
        ff = self._ffn(i, blk, L.rmsnorm(blk["ln2"], h), tape, path)
        return {"h": h + ff, "positions": pos}

    def block_linear_paths(self, params, i: int) -> list[tuple]:
        path = ("blocks", i)
        names = (("wq_a", "wq_b", "wkv_a", "wkv_b", "wo") if self.cfg.uses_mla
                 else ("wq", "wk", "wv", "wo"))
        attn = [path + ("attn", n, "w") for n in names]
        if self.cfg.layer_is_moe(i):
            return attn + M.moe_linear_paths(params["blocks"][i]["moe"],
                                             path + ("moe",))
        return attn + [path + ("mlp", n, "w") for n in ("gate", "up", "down")]

    # ------------------------------------------------------------- forward
    def forward(self, params, batch, tape=None) -> Tensor:
        carry = self.embed_batch(params, batch)
        for i in range(self.cfg.num_layers):
            carry = self.block(params, i, carry, tape)
        return self._head(params, carry["h"])

    def loss(self, params, batch) -> Tensor:
        tokens = batch["tokens"].to(self.device)
        logits = self.forward(params, {"tokens": tokens})
        labels = batch.get("labels")
        if labels is None:
            labels = F.pad(tokens[:, 1:], (0, 1), value=-1)
        return L.cross_entropy(logits, labels.to(self.device))

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int) -> dict:
        caches = {}
        for i in range(self.cfg.num_layers):
            if self.cfg.uses_mla:
                caches[i] = A.mla_cache_init(self.cfg, batch, max_len,
                                             dtype=self.cfg.torch_dtype,
                                             device=self.device)
                continue
            w = self._window(i)
            caches[i] = A.gqa_cache_init(
                self.cfg, batch, max_len, window=min(w, max_len) if w else 0,
                dtype=self.cfg.torch_dtype, device=self.device)
        return caches

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B, 1); pos int or (B,) absolute positions — a vector
        decodes every slot at its own depth.  → (logits (B, 1, V), cache);
        the cache is updated in place."""
        h = L.embed(params["embed"], tokens.to(self.device))
        # one host→device copy of the positions per step, not one per layer
        pos = A.slot_positions(pos, h.shape[0], self.device)
        for i in range(self.cfg.num_layers):
            blk = params["blocks"][i]
            hn = L.rmsnorm(blk["ln1"], h)
            if self.cfg.uses_mla:
                attn, cache[i] = A.mla_decode(blk["attn"], self.cfg, hn, pos,
                                              cache[i])
            else:
                attn, cache[i] = A.gqa_decode(blk["attn"], self.cfg, hn, pos,
                                              cache[i], theta=self._theta(i))
            h = h + attn
            h = h + self._ffn(i, blk, L.rmsnorm(blk["ln2"], h), None, ())
        return self._head(params, h), cache
