"""Magnitude pruning baseline (Han et al. 2015) — paper Alg. 4, data-free
(port of ``repro/core/magnitude.py``).  Ties go to the lower index, as
``jax.lax.top_k`` breaks them."""
from __future__ import annotations

import torch

from repro_torch.core.thanos import PruneResult
from repro_torch.util.graphs import graphed

Tensor = torch.Tensor


def _result(w: Tensor, mask: Tensor) -> PruneResult:
    pruned = mask > 0.5
    loss = torch.where(pruned, w.to(torch.float32) ** 2, 0.0).sum()
    return PruneResult(w.masked_fill(pruned, 0), mask, loss)


@graphed(static=("p",))
def prune_unstructured(w: Tensor, h: "Tensor | None" = None, *,
                       p: float) -> PruneResult:
    """Layer-global: prune the ⌊pcb⌋ smallest |W_ij| (Alg. 4 line 2)."""
    c, b = w.shape
    k = int(p * c * b)
    mag = torch.abs(w.to(torch.float32)).reshape(-1)
    mask = torch.zeros((c * b,), dtype=torch.float32, device=w.device)
    mask.index_fill_(0, torch.argsort(mag, stable=True)[:k], 1.0)
    return _result(w, mask.reshape(c, b))


@graphed(static=("n", "m"))
def prune_nm(w: Tensor, h: "Tensor | None" = None, *, n: int,
             m: int) -> PruneResult:
    """n:m magnitude: n smallest |W| per m-group."""
    c, b = w.shape
    if b % m:
        raise ValueError(f"n:m needs b % m == 0, got b={b}, m={m}")
    mag = torch.abs(w.to(torch.float32)).reshape(c, b // m, m)
    idx = torch.argsort(mag, dim=-1, stable=True)[..., :n]
    mask = torch.zeros_like(mag).scatter_(-1, idx, 1.0)
    return _result(w, mask.reshape(c, b))


@graphed(static=("p",))
def prune_structured(w: Tensor, h: "Tensor | None" = None, *,
                     p: float) -> PruneResult:
    """Column magnitude: drop the ⌈pb⌉ smallest-‖·‖₂ columns."""
    c, b = w.shape
    s = int(-(-p * b // 1))
    score = (w.to(torch.float32) ** 2).sum(0)
    col = torch.zeros((b,), dtype=torch.float32, device=w.device)
    col.index_fill_(0, torch.argsort(score, stable=True)[:s], 1.0)
    return _result(w, col[None, :].expand(c, b))
