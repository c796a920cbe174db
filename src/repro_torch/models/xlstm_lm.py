"""xLSTM language model (port of ``repro/models/xlstm_lm.py``): a residual
stack of mLSTM blocks with an sLSTM block every ``slstm_every`` layers
(xLSTM[7:1] for the 1.3b config).  d_ff = 0: the blocks carry their own
up/down projections.  The head is tied to the embedding, as in the JAX
model.  Serving cache: ``{i: MlstmCache | SlstmCache}``, O(1) in the
sequence length."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X

Tensor = torch.Tensor


class XlstmLM:
    def __init__(self, cfg, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _is_slstm(self, i: int) -> bool:
        k = self.cfg.slstm_every
        return bool(k) and (i + 1) % k == 0

    def init(self, gen: torch.Generator) -> dict:
        cfg, dt, dev = self.cfg, self.cfg.torch_dtype, self.device
        params = {
            "embed": L.embedding_params(gen, cfg.vocab_size, cfg.d_model, dt,
                                        dev),
            "final_norm": L.norm_params(cfg.norm, cfg.d_model, dt, dev),
            "blocks": {},
        }
        for i in range(cfg.num_layers):
            mk = X.slstm_params if self._is_slstm(i) else X.mlstm_params
            params["blocks"][i] = {
                "ln": L.norm_params(cfg.norm, cfg.d_model, dt, dev),
                "cell": mk(gen, cfg, dt, dev),
            }
        return params

    def embed_batch(self, params, batch) -> dict:
        return {"h": L.embed(params["embed"],
                             batch["tokens"].to(self.device))}

    def num_blocks(self) -> int:
        return self.cfg.num_layers

    def block(self, params, i: int, carry: dict, tape=None) -> dict:
        blk = params["blocks"][i]
        fwd = X.slstm_forward if self._is_slstm(i) else X.mlstm_forward
        h = carry["h"]
        return {"h": h + fwd(blk["cell"], self.cfg, L.norm(blk["ln"], h),
                             tape=tape, path=("blocks", i, "cell"))}

    def block_linear_paths(self, params, i: int) -> list[tuple]:
        return X.xlstm_linear_paths(params["blocks"][i]["cell"],
                                    ("blocks", i, "cell"))

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

    def init_cache(self, batch: int, max_len: int) -> dict:
        del max_len  # the recurrent state is O(1) in the sequence length
        return {i: (X.slstm_cache_init(self.cfg, batch, self.device)
                    if self._is_slstm(i)
                    else X.mlstm_cache_init(self.cfg, batch, self.device))
                for i in range(self.cfg.num_layers)}

    def decode_step(self, params, cache, tokens, pos):
        """pos is accepted for the API's sake: the recurrent state is
        per-row and position-free.  → (logits (B, 1, V), cache); the dict
        is updated in place."""
        del pos
        h = L.embed(params["embed"], tokens.to(self.device))
        for i in range(self.cfg.num_layers):
            blk = params["blocks"][i]
            dec = X.slstm_decode if self._is_slstm(i) else X.mlstm_decode
            out, cache[i] = dec(blk["cell"], self.cfg, L.norm(blk["ln"], h),
                                cache[i])
            h = h + out
        return L.unembed(params["embed"],
                         L.norm(params["final_norm"], h)), cache
