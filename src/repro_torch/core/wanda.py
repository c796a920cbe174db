"""Wanda baseline (Sun et al. 2023) — paper Alg. 6 (port of
``repro/core/wanda.py``).

Metric |W_ij|·‖X_j‖₂ (Eq. 46), no weight update.  The JAX module ranks
with ``jax.lax.top_k(-metric, k)``, which keeps the lower index first among
equal values; the port takes the first k of a stable ascending argsort,
which selects the same entries.  Every metric here is ≥ +0 (|·| times a
clamped square root, or a sum of squares), so −0.0 never enters a ranking.
"""
from __future__ import annotations

import torch

from repro_torch.core import masks as mmod
from repro_torch.core.thanos import PruneResult
from repro_torch.util.graphs import graphed

Tensor = torch.Tensor


def _result(w: Tensor, mask: Tensor, metric: Tensor) -> PruneResult:
    pruned = mask > 0.5
    loss = (torch.where(pruned, metric, 0.0) ** 2).sum()          # Σ S^OBD
    return PruneResult(w.masked_fill(pruned, 0), mask, loss)


def _metric(w: Tensor, h: Tensor) -> Tensor:
    return mmod.wanda_metric(w.to(torch.float32),
                             mmod.col_norms_from_hessian(h))


@graphed(static=("p",))
def prune_unstructured(w: Tensor, h: Tensor, *, p: float) -> PruneResult:
    """Per row, prune the ⌊pb⌋ smallest-metric weights (row-local)."""
    c, b = w.shape
    metric = _metric(w, h)
    idx = torch.argsort(metric, dim=1, stable=True)[:, :int(p * b)]
    mask = torch.zeros((c, b), dtype=torch.float32,
                       device=w.device).scatter_(1, idx, 1.0)
    return _result(w, mask, metric)


@graphed(static=("n", "m"))
def prune_nm(w: Tensor, h: Tensor, *, n: int, m: int) -> PruneResult:
    """n:m Wanda: the n smallest-metric weights per m-group, no update."""
    xnorm = mmod.col_norms_from_hessian(h)
    mask = mmod.nm_mask(w.to(torch.float32), xnorm, n, m)
    return _result(w, mask, mmod.wanda_metric(w.to(torch.float32), xnorm))


@graphed(static=("p",))
def prune_structured(w: Tensor, h: Tensor, *, p: float) -> PruneResult:
    """Structured Wanda (paper Tab. 2 baseline): drop the ⌈pb⌉ columns with
    the smallest aggregated metric Σ_i (|W_ij|·‖X_j‖)², no update."""
    c, b = w.shape
    metric = _metric(w, h)
    col_score = (metric ** 2).sum(0)
    col = torch.zeros((b,), dtype=torch.float32, device=w.device)
    s = int(-(-p * b // 1))
    col.index_fill_(0, torch.argsort(col_score, stable=True)[:s], 1.0)
    return _result(w, col[None, :].expand(c, b), metric)
