"""Plain PyTorch reference of Thanos' n:m pruning of one linear layer
(arXiv:2504.05346, Alg. 8 with no outlier rows), in float32 with TF32 off.
It imports nothing of the program and is written from the paper's
equations, not from the port's solver:

* H = 2 XᵀX / tokens; features no token excites (diag H = 0) get a unit
  diagonal and their weights are zeroed; H is damped by percdamp times the
  mean of its diagonal.
* Columns are taken in blocks of B (all of them where b < B).  In a block every row prunes, in each
  group of m inputs, the n weights of least |W_ij|·‖X_j‖ (ties to the lower
  index), from the weights as updated so far.
* Each row's pruned set q is removed in one multi-weight OBS step against
  the trailing inverse Hessian T = [H_{j:, j:}]⁻¹: λ = T_qq⁻¹ w_q, w −= λ T_q:,
  and the pruned weights are set to exact zeros.
* T is advanced past the block by the Schur complement,
  T' = T_{BB'} − T_{B'B} T_{BB}⁻¹ T_{BB'} (the port uses a Cholesky-factor
  downdate instead: the same matrix, another formulation).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def hessian(xtx: Tensor, count: float) -> Tensor:
    """H = 2 XᵀX / count from the sum of outer products."""
    return 2.0 * xtx / max(count, 1.0)


def nm_select(metric: Tensor, n: int, m: int) -> Tensor:
    """(c, B) bool: in every group of m columns the n least entries, ties
    to the lower column."""
    c, B = metric.shape
    g = metric.reshape(c, B // m, m)
    rank = torch.zeros(g.shape, dtype=torch.int64, device=metric.device)
    for j in range(m):
        gj = g[..., j:j + 1]
        before = (torch.arange(m, device=metric.device) > j)
        rank += ((gj < g) | ((gj == g) & before)).to(torch.int64)
    return (rank < n).reshape(c, B)


def prune(w: Tensor, h: Tensor, *, n: int = 2, m: int = 4,
          block: int = 64, percdamp: float = 0.01) -> tuple[Tensor, Tensor]:
    """w (c, b) rows = outputs, h (b, b) → (pruned weights, pruned mask),
    float32."""
    w = w.to(torch.float32).clone()
    h = h.to(torch.float32)
    c, b = w.shape
    block = min(block, b)
    if b % block or block % m:
        raise ValueError(f"need m | B | b, got m={m} B={block} b={b}")
    diag = torch.diagonal(h)
    dead = diag <= 0
    xnorm = torch.sqrt(torch.clamp(diag, min=0.0) * 0.5)
    hd = h + torch.diag(dead.to(h.dtype))
    lam = torch.clamp(percdamp * torch.diagonal(hd).mean(), min=1e-8)
    hd = hd + lam * torch.eye(b, device=h.device, dtype=h.dtype)
    w[:, dead] = 0.0
    t = torch.cholesky_inverse(torch.linalg.cholesky(hd))
    mask = torch.zeros((c, b), dtype=torch.bool, device=w.device)
    r = (block // m) * n
    rows = torch.arange(c, device=w.device)[:, None]
    for j1 in range(0, b, block):
        sel = nm_select(w[:, j1:j1 + block].abs() * xnorm[j1:j1 + block],
                        n, m)
        q = torch.nonzero(sel)[:, 1].reshape(c, r)          # ascending
        tqq = t[q[:, :, None], q[:, None, :]]               # (c, r, r)
        u = w[rows, j1 + q]                                  # (c, r)
        lamb = torch.cholesky_solve(u[..., None],
                                    torch.linalg.cholesky(tqq))[..., 0]
        lam_blk = torch.zeros((c, block), dtype=w.dtype, device=w.device)
        lam_blk.scatter_(1, q, lamb)
        w[:, j1:] -= lam_blk @ t[:block]
        w[:, j1:j1 + block].masked_fill_(sel, 0.0)
        mask[:, j1:j1 + block] = sel
        if j1 + block < b:
            tbb, tbr = t[:block, :block], t[:block, block:]
            t = t[block:, block:] - tbr.T @ torch.cholesky_solve(
                tbr, torch.linalg.cholesky(tbb))
    return w, mask
