"""Zamba2-style hybrid (port of ``repro/models/hybrid.py``): a Mamba2
backbone with *shared* transformer blocks interleaved every ``attn_every``
layers.  The shared blocks (``num_shared_attn`` alternating parameter sets)
hold GQA attention and a gated MLP and are applied with the same weights at
each of their invocation sites.

Prunable linears: every Mamba in/out projection, and the shared blocks'
attention and MLP projections — pruned once, at the set's last site, with
the Hessian accumulated over every site (``core/schedule.py`` keeps its
accumulators across blocks), the treatment of weight sharing under the
paper's objective (Eq. 1).

Serving cache: ``{"mamba": {i: MambaCache}, "shared": {j: GQA cache}}``,
one GQA cache per invocation site j, windowed at min(sliding_window,
max_len); ``cfg.kv_cache_dtype == "int8"`` quantizes those caches only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Tensor = torch.Tensor


class HybridLM:
    def __init__(self, cfg, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _shared_points(self) -> list[int]:
        cfg = self.cfg
        return [i for i in range(cfg.num_layers)
                if cfg.attn_every and (i + 1) % cfg.attn_every == 0]

    def _which(self, i: int) -> int:
        """The shared set block i (a shared point) applies."""
        cfg = self.cfg
        return ((i + 1) // cfg.attn_every - 1) % cfg.num_shared_attn

    # ---------------------------------------------------------------- init
    def init(self, gen: torch.Generator) -> dict:
        cfg, dt, dev = self.cfg, self.cfg.torch_dtype, self.device
        kw = dict(dtype=dt, device=dev)
        params = {
            "embed": L.embedding_params(gen, cfg.vocab_size, cfg.d_model, dt,
                                        dev),
            "final_norm": L.norm_params(cfg.norm, cfg.d_model, **kw),
            "mamba": {}, "shared": {},
        }
        for i in range(cfg.num_layers):
            params["mamba"][i] = {
                "ln": L.norm_params(cfg.norm, cfg.d_model, **kw),
                "mixer": S.mamba2_params(gen, cfg, **kw),
            }
        for s in range(cfg.num_shared_attn):
            params["shared"][s] = {
                "ln1": L.norm_params(cfg.norm, cfg.d_model, **kw),
                "ln2": L.norm_params(cfg.norm, cfg.d_model, **kw),
                "attn": A.gqa_params(gen, cfg, **kw),
                "mlp": {n: L.linear_params(gen, di, do, **kw)
                        for n, di, do in (("gate", cfg.d_model, cfg.d_ff),
                                          ("up", cfg.d_model, cfg.d_ff),
                                          ("down", cfg.d_ff, cfg.d_model))},
            }
        return params

    # ------------------------------------------------------ blockwise parts
    def embed_batch(self, params, batch) -> dict:
        h = L.embed(params["embed"], batch["tokens"].to(self.device))
        B, Sq, _ = h.shape
        pos = torch.arange(Sq, device=h.device)[None].expand(B, Sq)
        return {"h": h, "positions": pos}

    def num_blocks(self) -> int:
        return self.cfg.num_layers

    def _mlp(self, sb, hn, tape, path) -> Tensor:
        act = L.act_fn(self.cfg.act)
        mlp = sb["mlp"]
        h = act(L.dense(mlp["gate"], hn, tape, path + ("mlp", "gate"))) * \
            L.dense(mlp["up"], hn, tape, path + ("mlp", "up"))
        return L.dense(mlp["down"], h, tape, path + ("mlp", "down"))

    def _shared_apply(self, params, which: int, h, pos, tape) -> Tensor:
        cfg = self.cfg
        sb = params["shared"][which]
        path = ("shared", which)
        attn = A.gqa_forward(sb["attn"], cfg, L.norm(sb["ln1"], h), pos,
                             theta=cfg.rope_theta, window=cfg.sliding_window,
                             tape=tape, path=path + ("attn",))
        h = h + attn
        return h + self._mlp(sb, L.norm(sb["ln2"], h), tape, path)

    def block(self, params, i: int, carry: dict, tape=None) -> dict:
        h, pos = carry["h"], carry["positions"]
        mb = params["mamba"][i]
        h = h + S.mamba2_forward(mb["mixer"], self.cfg, L.norm(mb["ln"], h),
                                 tape=tape, path=("mamba", i, "mixer"))
        if i in self._shared_points():
            h = self._shared_apply(params, self._which(i), h, pos, tape)
        return {"h": h, "positions": pos}

    def block_linear_paths(self, params, i: int) -> list[tuple]:
        paths = [("mamba", i, "mixer", n, "w") for n in ("in_proj",
                                                         "out_proj")]
        # each shared set is pruned at its own last site, with the Hessian
        # accumulated over every earlier one
        pts = self._shared_points()
        for s in range(self.cfg.num_shared_attn):
            s_pts = [p for p in pts if self._which(p) == s]
            if s_pts and i == s_pts[-1]:
                base = ("shared", s)
                paths += [base + ("attn", n, "w")
                          for n in ("wq", "wk", "wv", "wo")]
                paths += [base + ("mlp", n, "w")
                          for n in ("gate", "up", "down")]
        return paths

    # ------------------------------------------------------------- forward
    def forward(self, params, batch, tape=None) -> Tensor:
        carry = self.embed_batch(params, batch)
        for i in range(self.cfg.num_layers):
            carry = self.block(params, i, carry, tape)
        return L.unembed(params["embed"],
                         L.norm(params["final_norm"], carry["h"]))

    def loss_from_carry(self, params, carry, batch) -> Tensor:
        logits = L.unembed(params["embed"],
                           L.norm(params["final_norm"], carry["h"]))
        labels = batch.get("labels")
        if labels is None:
            labels = F.pad(batch["tokens"][:, 1:], (0, 1), value=-1)
        return L.cross_entropy(logits, labels.to(self.device))

    def loss(self, params, batch) -> Tensor:
        carry = self.embed_batch(params, batch)
        for i in range(self.cfg.num_layers):
            carry = self.block(params, i, carry)
        return self.loss_from_carry(params, carry, batch)

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dt, dev = self.cfg, self.cfg.torch_dtype, self.device
        cache = {"mamba": {i: S.mamba2_cache_init(cfg, batch, dt, dev)
                           for i in range(cfg.num_layers)},
                 "shared": {}}
        # one KV cache per shared-block invocation site (windowed)
        w = min(cfg.sliding_window or max_len, max_len)
        for j, _ in enumerate(self._shared_points()):
            cache["shared"][j] = A.gqa_cache_init(cfg, batch, max_len,
                                                  window=w, dtype=dt,
                                                  device=dev)
        return cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B, 1); pos int or (B,): the Mamba state is
        position-free, the shared GQA blocks take per-slot positions.
        → (logits (B, 1, V), cache); the dicts are updated in place."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens.to(self.device))
        pos = A.slot_positions(pos, h.shape[0], self.device)
        pts = self._shared_points()
        for i in range(cfg.num_layers):
            mb = params["mamba"][i]
            out, cache["mamba"][i] = S.mamba2_decode(
                mb["mixer"], cfg, L.norm(mb["ln"], h), cache["mamba"][i])
            h = h + out
            if i in pts:
                j = pts.index(i)
                sb = params["shared"][self._which(i)]
                attn, cache["shared"][j] = A.gqa_decode(
                    sb["attn"], cfg, L.norm(sb["ln1"], h), pos,
                    cache["shared"][j], theta=cfg.rope_theta)
                h = h + attn
                h = h + self._mlp(sb, L.norm(sb["ln2"], h), None, ())
        return L.unembed(params["embed"],
                         L.norm(params["final_norm"], h)), cache
