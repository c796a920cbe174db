"""SparseGPT baseline (Frantar & Alistarh 2023) — paper Alg. 5 (port of
``repro/core/sparsegpt.py``).

Column-sequential OBS pruning with the upper Cholesky factor ``U`` of
H⁻¹ (H⁻¹ = UᵀU): at column j's turn the trailing inverse row it needs is
``U[j,j]·U[j, j:]`` and its denominator ``U[j,j]²``, so the update is
``w[:, j:] -= ((w_j·m_j)/U[j,j]) ⊗ U[j, j:]``.

The sweep is lazy, as in JAX: columns go in blocks of ``bs``; inside a
block each column updates only the block's columns ≥ j, its error is kept
in a panel E, and the block ends with one ``E @ U[j1:j2, j2:]`` product on
the columns after it.  The loss is ½ Σ err² over every column (summed per
block; the JAX loop adds it per column — the same sum in another order).

The JAX ``fori_loop`` over columns becomes a Python loop of a few torch
ops per column (everything fp32), on whichever device ``w`` lies; inside
a prune run on the card each solver (``util.graphs.graphed``, JAX's static
arguments) replays the whole sweep as one CUDA graph a shape.
Two layout choices keep it short without changing a result: the block is
held transposed (bs, c) so a column is a contiguous row, and a pruned
column's exact zeros are written once at the end of its block (no later
step of the block reads or writes a finished column).  Mask refreshes rank
with a stable ascending argsort, which keeps the lower index first among
equal metrics as ``jax.lax.top_k(-metric, k)`` does; every metric is a
square, so −0.0 never enters a ranking.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import hessian as hmod
from repro_torch.core.thanos import PruneResult
from repro_torch.util.graphs import graphed

Tensor = torch.Tensor


def _solve_prep(w: Tensor, h: Tensor, percdamp: float):
    """(U, diag U, fp32 weights with dead features zeroed)."""
    h = h.to(torch.float32)
    u = hmod.inv_cholesky_upper(hmod.dampen(h, percdamp))
    w32 = torch.where(hmod.dead_features(h)[None, :], 0.0,
                      w.to(torch.float32))
    return u, torch.diagonal(u), w32


def _block_sweep(u: Tensor, bs: int,
                 refresh: "Callable[[int, Tensor, Tensor], None] | None"
                 = None):
    """→ block(j1, w_cur, mask_t) → the block's ½ Σ err².

    ``w_cur`` (c, b) is updated in place; ``mask_t`` (bs, c) is the block's
    mask, transposed.  ``refresh(jj, w_t, mask_t)``, when given, runs
    before column jj's update and may rewrite rows of ``mask_t`` (the n:m
    mask refresh); ``w_t`` is the block's weights, transposed.
    """
    b = u.shape[0]

    def block(j1: int, w_cur: Tensor, mask_t: Tensor) -> Tensor:
        j2 = j1 + bs
        w_t = w_cur[:, j1:j2].T.contiguous()                 # (bs, c)
        err = torch.empty_like(w_t)                          # E, transposed
        usq = u[j1:j2, j1:j2]
        for jj in range(bs):
            if refresh is not None:
                refresh(jj, w_t, mask_t)
            torch.mul(w_t[jj], mask_t[jj], out=err[jj])
            err[jj].div_(usq[jj, jj])
            w_t[jj:].sub_(torch.outer(usq[jj, jj:], err[jj]))
        w_t.masked_fill_(mask_t > 0.5, 0.0)
        w_cur[:, j1:j2] = w_t.T
        if j2 < b:
            w_cur[:, j2:] -= err.T @ u[j1:j2, j2:]
        return 0.5 * (err ** 2).sum()

    return block


def _mask_block_size(b: int, requested: int, multiple: int = 1) -> int:
    bs = min(requested, b) if requested > 0 else b
    if b % bs != 0 or bs % multiple != 0:
        bs = b  # fall back to a single block, as the JAX module does
    return bs


@graphed(static=("p", "mask_blocksize", "percdamp"))
def prune_unstructured(w: Tensor, h: Tensor, *, p: float,
                       mask_blocksize: int = 128,
                       percdamp: float = 0.01) -> PruneResult:
    """SparseGPT unstructured: an adaptive mask per B_s-column block, p%
    within each block (Alg. 5 line 7), chosen by w²/d_q with d_q = U_qq²
    over the block's (c, bs) entries in row-major order."""
    c, b = w.shape
    bs = _mask_block_size(b, mask_blocksize)
    k = int(p * c * bs)
    u, udiag, w_cur = _solve_prep(w, h, percdamp)
    sweep = _block_sweep(u, bs)
    mask = torch.zeros((c, b), dtype=torch.float32, device=w.device)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    for j1 in range(0, b, bs):
        metric = (w_cur[:, j1:j1 + bs] / udiag[None, j1:j1 + bs]) ** 2
        mb = torch.zeros((c * bs,), dtype=torch.float32, device=w.device)
        mb.index_fill_(0, torch.argsort(metric.reshape(-1), stable=True)[:k],
                       1.0)
        mb = mb.reshape(c, bs)
        loss = loss + sweep(j1, w_cur, mb.T.contiguous())
        mask[:, j1:j1 + bs] = mb
    return PruneResult(w_cur.to(w.dtype), mask, loss)


@graphed(static=("n", "m", "blocksize", "percdamp"))
def prune_nm(w: Tensor, h: Tensor, *, n: int, m: int, blocksize: int = 128,
             percdamp: float = 0.01) -> PruneResult:
    """SparseGPT n:m: refresh the mask per m-group at the group's first
    column — the n smallest w²/d of each row's group."""
    c, b = w.shape
    if b % m:
        raise ValueError(f"n:m needs b % m == 0, got b={b}, m={m}")
    bs = _mask_block_size(b, blocksize, multiple=m)
    u, udiag, w_cur = _solve_prep(w, h, percdamp)
    mask = torch.zeros((c, b), dtype=torch.float32, device=w.device)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    for j1 in range(0, b, bs):
        d_t = udiag[j1:j1 + bs, None]

        def refresh(jj: int, w_t: Tensor, mask_t: Tensor) -> None:
            if jj % m:
                return
            metric = (w_t[jj:jj + m] / d_t[jj:jj + m]) ** 2       # (m, c)
            idx = torch.argsort(metric, dim=0, stable=True)[:n]
            mask_t[jj:jj + m] = torch.zeros_like(metric).scatter_(0, idx,
                                                                  1.0)

        mask_t = torch.zeros((bs, c), dtype=torch.float32, device=w.device)
        loss = loss + _block_sweep(u, bs, refresh)(j1, w_cur, mask_t)
        mask[:, j1:j1 + bs] = mask_t.T
    return PruneResult(w_cur.to(w.dtype), mask, loss)


@graphed(static=("p", "blocksize", "percdamp"))
def prune_structured(w: Tensor, h: Tensor, *, p: float, blocksize: int = 128,
                     percdamp: float = 0.01) -> PruneResult:
    """Structured (column) SparseGPT baseline of the paper's Tab. 2: remove
    the ⌈pb⌉ columns with the smallest saliency Σ_k w²/d, each compensated
    with the sequential single-column OBS rule."""
    c, b = w.shape
    s = int(-(-p * b // 1))
    bs = _mask_block_size(b, blocksize)
    u, udiag, w_cur = _solve_prep(w, h, percdamp)
    saliency = ((w_cur / udiag[None, :]) ** 2).sum(0)
    col = torch.zeros((b,), dtype=torch.float32, device=w.device)
    col.index_fill_(0, torch.argsort(saliency, stable=True)[:s], 1.0)
    sweep = _block_sweep(u, bs)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    for j1 in range(0, b, bs):
        loss = loss + sweep(j1, w_cur, col[j1:j1 + bs, None].expand(bs, c))
    return PruneResult(w_cur.to(w.dtype), col[None, :].expand(c, b), loss)
