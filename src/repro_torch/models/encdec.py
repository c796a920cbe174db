"""Whisper-style encoder–decoder, the whisper-medium backbone (port of
``repro/models/encdec.py``).

The audio conv front end is a stub, as in the JAX package: the batch
carries precomputed frame embeddings (B, S_frames, d_model).  The backbone:
LayerNorm and (tanh) GELU, bidirectional encoder self-attention, causal
decoder self-attention and cross-attention, sinusoidal positions, learned
token embeddings with a tied head.  Biases on wq, wv, wo (not wk) and on
both MLP linears; a compressed linear adds its bias after K2.

Block-wise pruning order (Alg. 3): encoder blocks 0..E-1, then decoder
blocks E..E+D-1; the carry holds both streams.  Cross-attention reads the
post-norm encoder output.

Serving: ``encode`` once a source; ``decode_step(..., enc_out)`` takes the
encoded source (B, T, d) or the per-layer cross k/v of
``precompute_cross_kv`` (a dict), which spares re-projecting the source
through wk/wv at every step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Tensor = torch.Tensor


class EncDecLM:
    def __init__(self, cfg, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---------------------------------------------------------------- init
    def init(self, gen: torch.Generator) -> dict:
        cfg, dt, dev = self.cfg, self.cfg.torch_dtype, self.device
        params = {
            "embed": L.embedding_params(gen, cfg.vocab_size, cfg.d_model, dt,
                                        dev),
            "enc_norm": L.layernorm_params(cfg.d_model, dt, dev),
            "dec_norm": L.layernorm_params(cfg.d_model, dt, dev),
            "enc": {}, "dec": {},
        }
        for i in range(cfg.encoder_layers):
            params["enc"][i] = self._block_params(gen, cross=False)
        for i in range(cfg.decoder_layers):
            params["dec"][i] = self._block_params(gen, cross=True)
        return params

    def _block_params(self, gen, *, cross: bool) -> dict:
        cfg = self.cfg
        kw = dict(dtype=cfg.torch_dtype, device=self.device)
        lns = ("ln1", "lnx", "ln2") if cross else ("ln1", "ln2")
        blk = {n: L.layernorm_params(cfg.d_model, **kw) for n in lns}
        blk["attn"] = A.gqa_params(gen, cfg, **kw)
        if cross:
            blk["xattn"] = A.gqa_params(gen, cfg, **kw)
        blk["mlp"] = {
            "fc1": L.linear_params(gen, cfg.d_model, cfg.d_ff, bias=True,
                                   **kw),
            "fc2": L.linear_params(gen, cfg.d_ff, cfg.d_model, bias=True,
                                   **kw)}
        return blk

    # ------------------------------------------------------------- pieces
    def _mlp(self, blk, x, tape, path) -> Tensor:
        h = L.act_fn("gelu")(L.dense(blk["mlp"]["fc1"], x, tape,
                                     path + ("mlp", "fc1")))
        return L.dense(blk["mlp"]["fc2"], h, tape, path + ("mlp", "fc2"))

    def _cross_kv(self, p, enc, tape, path) -> tuple[Tensor, Tensor]:
        """wk/wv over the encoded source (B, T, d) → k, v (B, T, Hkv, Dh)."""
        cfg = self.cfg
        B, T, _ = enc.shape
        k = L.dense(p["wk"], enc, tape, path + ("xattn", "wk"))
        v = L.dense(p["wv"], enc, tape, path + ("xattn", "wv"))
        return (k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim),
                v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim))

    def _cross_attn(self, blk, x, enc, tape, path, kv=None) -> Tensor:
        """q from the decoder stream x (B, S, d) over every source position:
        k/v projected from the encoded source ``enc``, or taken from ``kv``
        (one layer of ``precompute_cross_kv``)."""
        cfg = self.cfg
        p = blk["xattn"]
        B, S, _ = x.shape
        q = L.dense(p["wq"], x, tape, path + ("xattn", "wq")).reshape(
            B, S, cfg.num_heads, cfg.head_dim)
        k, v = ((kv["k"], kv["v"]) if kv is not None
                else self._cross_kv(p, enc, tape, path))
        mask = torch.ones((B, 1, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = A._sdpa(q, k, v, mask, cfg.num_heads, cfg.num_kv_heads)
        return L.dense(p["wo"], out.reshape(B, S, -1), tape,
                       path + ("xattn", "wo"))

    # ------------------------------------------------------ blockwise parts
    def embed_batch(self, params, batch) -> dict:
        cfg, dev = self.cfg, self.device
        frames = batch["frames"].to(device=dev, dtype=cfg.torch_dtype)
        B, Sf, _ = frames.shape
        enc_h = frames + L.sinusoidal_positions(Sf, cfg.d_model, dev).to(
            frames.dtype)
        dec_tokens = batch["dec_tokens"].to(dev)
        Sd = dec_tokens.shape[1]
        dec_h = L.embed(params["embed"], dec_tokens)
        dec_h = dec_h + L.sinusoidal_positions(Sd, cfg.d_model, dev).to(
            dec_h.dtype)
        pos = torch.arange(Sd, device=dev)[None].expand(B, Sd)
        return {"enc_h": enc_h, "dec_h": dec_h, "positions": pos}

    def num_blocks(self) -> int:
        return self.cfg.encoder_layers + self.cfg.decoder_layers

    def block(self, params, i: int, carry: dict, tape=None) -> dict:
        cfg = self.cfg
        E = cfg.encoder_layers
        if i < E:
            blk, path = params["enc"][i], ("enc", i)
            h = carry["enc_h"]
            pos0 = torch.zeros(h.shape[:2], dtype=torch.int64,
                               device=h.device)
            h = h + A.gqa_forward(blk["attn"], cfg,
                                  L.layernorm(blk["ln1"], h), pos0,
                                  theta=0.0, is_causal=False, tape=tape,
                                  path=path + ("attn",))
            h = h + self._mlp(blk, L.layernorm(blk["ln2"], h), tape, path)
            return {**carry, "enc_h": h}
        blk, path = params["dec"][i - E], ("dec", i - E)
        h = carry["dec_h"]
        h = h + A.gqa_forward(blk["attn"], cfg, L.layernorm(blk["ln1"], h),
                              carry["positions"], theta=0.0, is_causal=True,
                              tape=tape, path=path + ("attn",))
        # cross-attention reads the post-norm encoder output (as encode())
        enc_src = L.layernorm(params["enc_norm"], carry["enc_h"])
        h = h + self._cross_attn(blk, L.layernorm(blk["lnx"], h), enc_src,
                                 tape, path)
        h = h + self._mlp(blk, L.layernorm(blk["ln2"], h), tape, path)
        return {**carry, "dec_h": h}

    def block_linear_paths(self, params, i: int) -> list[tuple]:
        E = self.cfg.encoder_layers
        attn = ("wq", "wk", "wv", "wo")
        if i < E:
            path = ("enc", i)
            return ([path + ("attn", n, "w") for n in attn]
                    + [path + ("mlp", n, "w") for n in ("fc1", "fc2")])
        path = ("dec", i - E)
        return ([path + ("attn", n, "w") for n in attn]
                + [path + ("xattn", n, "w") for n in attn]
                + [path + ("mlp", n, "w") for n in ("fc1", "fc2")])

    # ------------------------------------------------------------- forward
    def forward(self, params, batch, tape=None) -> Tensor:
        carry = self.embed_batch(params, batch)
        for i in range(self.num_blocks()):
            carry = self.block(params, i, carry, tape)
        return L.unembed(params["embed"],
                         L.layernorm(params["dec_norm"], carry["dec_h"]))

    def loss_from_carry(self, params, carry, batch) -> Tensor:
        logits = L.unembed(params["embed"],
                           L.layernorm(params["dec_norm"], carry["dec_h"]))
        labels = batch.get("labels")
        if labels is None:
            labels = F.pad(batch["dec_tokens"][:, 1:], (0, 1), value=-1)
        return L.cross_entropy(logits, labels.to(self.device))

    def loss(self, params, batch) -> Tensor:
        carry = self.embed_batch(params, batch)
        for i in range(self.num_blocks()):
            carry = self.block(params, i, carry)
        return self.loss_from_carry(params, carry, batch)

    # ------------------------------------------------------------- serving
    def encode(self, params, frames) -> Tensor:
        """frames (B, Sf, d) → the post-norm encoder output (B, Sf, d)."""
        cfg, dt, dev = self.cfg, self.cfg.torch_dtype, self.device
        frames = frames.to(device=dev, dtype=dt)
        B, Sf, _ = frames.shape
        carry = {"enc_h": frames + L.sinusoidal_positions(
                     Sf, cfg.d_model, dev).to(dt),
                 "dec_h": torch.zeros((B, 1, cfg.d_model), dtype=dt,
                                      device=dev),
                 "positions": torch.zeros((B, 1), dtype=torch.int64,
                                          device=dev)}
        for i in range(cfg.encoder_layers):
            carry = self.block(params, i, carry)
        return L.layernorm(params["enc_norm"], carry["enc_h"])

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        return {j: A.gqa_cache_init(cfg, batch, max_len,
                                    dtype=cfg.torch_dtype, device=self.device)
                for j in range(cfg.decoder_layers)}

    def precompute_cross_kv(self, params, enc_out) -> dict:
        """Each decoder layer's cross-attention k/v, computed once a
        request: {j: {"k", "v"}} of (B, T, Hkv, Dh)."""
        out = {}
        for j in range(self.cfg.decoder_layers):
            k, v = self._cross_kv(params["dec"][j]["xattn"], enc_out, None, ())
            out[j] = {"k": k, "v": v}
        return out

    def _cross_attn_cached(self, blk, x, kv) -> Tensor:
        return self._cross_attn(blk, x, None, None, (), kv=kv)

    def decode_step(self, params, cache, tokens, pos, enc_out):
        """One decoder token against an encoded source: ``enc_out`` is the
        (B, T, d) output of ``encode`` or the dict of
        ``precompute_cross_kv``.  ``pos`` int or (B,): each row gathers its
        own sinusoidal position.  → (logits (B, 1, V), cache); the
        self-attention caches are written in place."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens.to(self.device))
        B = h.shape[0]
        pos = A.slot_positions(pos, B, self.device)
        table = L.sinusoidal_positions(cache[0].k.shape[1], cfg.d_model,
                                       self.device)
        h = h + table[pos][:, None, :].to(h.dtype)
        cached = isinstance(enc_out, dict)
        for j in range(cfg.decoder_layers):
            blk = params["dec"][j]
            attn, cache[j] = A.gqa_decode(blk["attn"], cfg,
                                          L.layernorm(blk["ln1"], h), pos,
                                          cache[j], theta=0.0)
            h = h + attn
            hx = L.layernorm(blk["lnx"], h)
            if cached:
                h = h + self._cross_attn_cached(blk, hx, enc_out[j])
            else:
                h = h + self._cross_attn(blk, hx, enc_out, None, ())
            h = h + self._mlp(blk, L.layernorm(blk["ln2"], h), None, ())
        return L.unembed(params["embed"],
                         L.layernorm(params["dec_norm"], h)), cache
