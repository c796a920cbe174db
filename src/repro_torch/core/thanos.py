"""Thanos pruning — Alg. 1 (unstructured), Alg. 8 (n:m), Alg. 2 (structured)
(port of ``repro/core/thanos.py``).

The JAX ``fori_loop``s become Python loops over column blocks; the
static-shape embedding is kept: full-size (c, b) weights, a residual metric
that is +inf on finished columns, and the trailing inverse Hessian carried
as a full (b, b) matrix advanced by the rank-B downdate
(``hessian.block_downdate``, in place).  Every block's padded OBS systems
are solved once (``solver.prune_block``).

Each solver is ``util.graphs.graphed`` with JAX's static arguments: inside
a prune run on the card it replays one CUDA graph a shape, so the loops
above cost their launches once, at the capture.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hessian as hmod
from repro_torch.core import masks as mmod
from repro_torch.core import solver as smod
from repro_torch.util.graphs import graphed

Tensor = torch.Tensor


class PruneResult(NamedTuple):
    weights: Tensor   # (c, b) pruned + OBS-updated weights, w's dtype
    mask: Tensor      # (c, b) float 1.0 = pruned
    loss: Tensor      # () cumulative OBS loss Σ S_k (paper Eq. 61)


def _setup(w: Tensor, h: Tensor, percdamp: float, alpha: float):
    """(xnorm, U, Hinv₀, fp32 weights with dead features zeroed, outliers)."""
    h = h.to(torch.float32)
    xnorm = mmod.col_norms_from_hessian(h)
    u_hinv = hmod.inv_cholesky_upper(hmod.dampen(h, percdamp))
    hinv = hmod.inverse_from_upper(u_hinv)
    w32 = torch.where(hmod.dead_features(h)[None, :], 0.0,
                      w.to(torch.float32))
    return xnorm, u_hinv, hinv, w32, _outlier_row_mask(w32, h, alpha)


@graphed(static=("p", "block_size", "percdamp", "row_chunk", "alpha"))
def prune_unstructured(w: Tensor, h: Tensor, *, p: float,
                       block_size: int = 128, percdamp: float = 0.01,
                       row_chunk: int = 0, alpha: float = 0.0) -> PruneResult:
    """Thanos Alg. 1 — unstructured pruning to sparsity p with block size B.

    w (c, b) paper layout (rows = outputs); h (b, b) raw Hessian 2XXᵀ.
    """
    c, b = w.shape
    B = min(block_size, b)
    xnorm, u_hinv, hinv, w_cur, outlier = _setup(w, h, percdamp, alpha)
    r = torch.full((), int(p * c * b), dtype=torch.int64, device=w.device)
    cols = torch.arange(b, device=w.device)
    total = torch.zeros((c, b), dtype=torch.float32, device=w.device)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    for j1 in range(0, b, B):
        active = cols >= j1
        in_block = active & (cols < j1 + B)
        metric = mmod.wanda_metric(w_cur, xnorm)
        metric = torch.where(active[None, :], metric, torch.inf)
        metric = torch.where(outlier[:, None], torch.inf, metric)
        m_blk = (mmod.rank_threshold_mask(metric, r)
                 & in_block[None, :]).to(torch.float32)        # Eq. 70
        r = r - m_blk.sum().to(torch.int64)                     # line 8
        start = min(j1, b - B)          # ragged last block: clamp the slice
        q_loc, valid = mmod.phi_padded(m_blk[:, start:start + B], B)
        w_cur, dloss = smod.prune_block(hinv, w_cur, q_loc + start, valid,
                                        j1, B, row_chunk=row_chunk)
        hinv = hmod.block_downdate(hinv, u_hinv, j1, B)         # line 17
        total += m_blk
        loss += dloss
    return PruneResult(w_cur.to(w.dtype), total, loss)


@graphed(static=("n", "m", "block_size", "percdamp", "row_chunk",
                 "alpha"))
def prune_nm(w: Tensor, h: Tensor, *, n: int, m: int, block_size: int = 512,
             percdamp: float = 0.01, row_chunk: int = 0,
             alpha: float = 0.0) -> PruneResult:
    """Thanos Alg. 8 — semi-structured n:m (n zeros per m consecutive
    weights).  With α > 0 the ⌈αc⌉ highest-energy rows stay dense."""
    c, b = w.shape
    B = min(block_size, b)
    if B % m or b % B:
        raise ValueError(f"need m | B | b, got m={m} B={B} b={b}")
    r_max = (B // m) * n
    xnorm, u_hinv, hinv, w_cur, outlier = _setup(w, h, percdamp, alpha)
    total = torch.zeros((c, b), dtype=torch.float32, device=w.device)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    for j1 in range(0, b, B):
        m_loc = mmod.nm_mask(w_cur[:, j1:j1 + B], xnorm[j1:j1 + B], n, m)
        m_loc = torch.where(outlier[:, None], 0.0, m_loc)       # Alg.8 l.10
        q_loc, valid = mmod.phi_padded(m_loc, r_max)
        w_cur, dloss = smod.prune_block(hinv, w_cur, q_loc + j1, valid, j1, B,
                                        row_chunk=row_chunk)
        hinv = hmod.block_downdate(hinv, u_hinv, j1, B)
        total[:, j1:j1 + B] += m_loc
        loss += dloss
    return PruneResult(w_cur.to(w.dtype), total, loss)


def _outlier_row_mask(w: Tensor, h: Tensor, alpha: float) -> Tensor:
    """(c,) bool — the ⌈αc⌉ rows with largest h_i = W_i (H/2) W_iᵀ (Eq. 14),
    ties broken by the lower row index."""
    c = w.shape[0]
    n_out = int(-(-alpha * c // 1)) if alpha > 0 else 0   # ⌈αc⌉
    mask = torch.zeros((c,), dtype=torch.bool, device=w.device)
    if n_out:
        hi = torch.einsum("ib,bk,ik->i", w, 0.5 * h, w)
        mask.index_fill_(0, torch.argsort(-hi, stable=True)[:n_out], True)
    return mask


@graphed(static=("p", "alpha", "percdamp"))
def prune_structured(w: Tensor, h: Tensor, *, p: float, alpha: float = 0.1,
                     percdamp: float = 0.01) -> PruneResult:
    """Thanos Alg. 2 — structured column pruning with outlier-row
    protection: s = ⌈pb/(1−α)⌉ whole columns in one multi-column OBS update
    (Eq. 13), permutation-free with gathers."""
    c, b = w.shape
    s = min(int(-(-p * b // (1.0 - alpha))), b)             # ⌈pb/(1−α)⌉
    h32 = h.to(torch.float32)
    xnorm2 = torch.clamp(torch.diagonal(h32), min=0.0) * 0.5   # ‖X_j‖²
    _, _, hinv, w32, outlier = _setup(w, h, percdamp, alpha)

    # v_j over non-outlier rows (Eq. 15): ‖W_{nonout, j}‖² · ‖X_j‖²
    w_no = torch.where(outlier[:, None], 0.0, w32)
    v = (w_no * w_no).sum(0) * xnorm2
    q = torch.sort(torch.argsort(v, stable=True)[:s]).values  # s smallest

    rhat = hinv[q[:, None], q[None, :]]                       # (s, s) SPD
    u = w_no[:, q]                                            # (c, s)
    lam = torch.cholesky_solve(u.T, hmod.cholesky_nan(rhat)).T   # u R̂⁻¹
    w_new = torch.where(outlier[:, None], w32, w32 - lam @ hinv[q, :])

    col = torch.zeros((b,), dtype=torch.float32, device=w.device)
    col.index_fill_(0, q, 1.0)
    mask = torch.where(outlier[:, None], 0.0, col[None, :])
    w_new = torch.where(mask > 0.5, 0.0, w_new)
    loss = 0.5 * (lam * u).sum()                              # Σ_k S_k
    return PruneResult(w_new.to(w.dtype), mask, loss)

