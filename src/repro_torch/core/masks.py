"""Pruning-mask construction (port of ``repro/core/masks.py``).

* ``wanda_metric``        S_ij = |W_ij|·‖X_j‖₂ (Eq. 5 / 46)
* ``rank_threshold_mask`` the r smallest entries, stable ties, sort-free —
                          the global residual mask ψ_X of Alg. 1 (Eq. 11)
* ``psi_x``               ψ_X(W, r) as a float mask (Eq. 11)
* ``nm_mask``             per-m-group exactly-n mask (Alg. 8 line 10)
* ``phi_padded``          φ indices per row padded to r_max (App. H.1)
* ``mask_sparsity``       p = ‖M‖²_F / (c·b) (Eq. 18)

Every selection is bit-equal to the JAX package's, ties included.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def col_norms_from_hessian(h: Tensor) -> Tensor:
    """‖X_j‖₂ per input feature from H = 2XXᵀ: sqrt(diag(H)/2).  (b,)"""
    return torch.sqrt(torch.clamp(torch.diagonal(h), min=0.0) * 0.5)


def wanda_metric(w: Tensor, xnorm: Tensor) -> Tensor:
    """S_ij = |W_ij|·‖X_j‖₂ for w (c, b) and xnorm (b,).  Returns (c, b)."""
    return torch.abs(w) * xnorm[None, :]


def _orderable_bits(x: Tensor) -> Tensor:
    """Monotone f32 → unsigned 32-bit key held in int64: a ≤ b ⇔
    key(a) ≤ key(b) (IEEE total order on non-NaN values).  The JAX package
    builds the same keys as uint32; int64 holds them without a sign."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def rank_threshold_mask(metric: Tensor, r) -> Tensor:
    """Bool mask of the entries with stable ascending rank < r.

    Equal to ``argsort(metric.ravel(), stable=True)[:r]`` — ties broken by
    row-major flat index — without a global sort: a 32-step binary search
    over the key space finds the r-th smallest key, entries below it are
    taken wholesale and the rest of the budget is filled from the entries
    equal to it in flat order.  ``r`` may be a device scalar; r ≤ 0 selects
    nothing.  Entries must be non-NaN and free of −0.0 (|·|-based metrics).
    """
    flat = metric.reshape(-1)
    u = _orderable_bits(flat)
    r = (r.to(torch.int64) if isinstance(r, Tensor) else
         torch.full((), r, dtype=torch.int64, device=flat.device))
    prefix = torch.zeros((), dtype=torch.int64, device=flat.device)
    for k in range(32):
        cand = prefix | (1 << (31 - k))
        below = (u < cand).sum()
        # ≥ r entries below the candidate ⇒ the r-th smallest is below it
        prefix = torch.where(below >= r, prefix, cand)
    lt = u < prefix
    eq = u == prefix
    n_lt = lt.sum()
    tie_rank = torch.cumsum(eq.to(torch.int64), 0) - 1    # 0-based among ties
    sel = lt | (eq & (tie_rank < r - n_lt))
    return sel.reshape(metric.shape)


def psi_x(w: Tensor, xnorm: Tensor, r) -> Tensor:
    """Global residual mask ψ_X(W, r): 1 at the r smallest-metric positions,
    ties broken by flat index (stable-sort order).  Float (c, b) in w's
    dtype, 1.0 = prune."""
    return rank_threshold_mask(wanda_metric(w, xnorm), r).to(w.dtype)


def nm_mask(w: Tensor, xnorm: Tensor, n: int, m: int) -> Tensor:
    """n:m mask: in every group of m consecutive columns prune exactly the n
    smallest-metric weights (stable ties).  Float (c, b), 1.0 = prune."""
    c, b = w.shape
    if b % m:
        raise ValueError(f"n:m needs b % m == 0, got b={b}, m={m}")
    metric = wanda_metric(w, xnorm).reshape(c, b // m, m)
    order = torch.argsort(metric, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(m, device=w.device).expand(c, b // m, m))
    return (ranks < n).to(w.dtype).reshape(c, b)


def phi_padded(mask_block: Tensor, r_max: int) -> tuple[Tensor, Tensor]:
    """φ(M_i:) per row, padded to r_max (Eq. 75 + Appendix H.1).

    Returns q (c, r_max) int64 column indices of the pruned weights per row,
    ascending, padded with 0, and valid (c, r_max) bool.
    """
    c, B = mask_block.shape
    is_one = mask_block > 0.5
    ar = torch.arange(B, device=mask_block.device)
    key = torch.where(is_one, ar[None, :], B + ar[None, :])
    order = torch.argsort(key, dim=1)[:, :r_max]          # keys are unique
    counts = is_one.sum(dim=1)
    valid = torch.arange(r_max, device=mask_block.device)[None, :] < \
        counts[:, None]
    q = torch.where(valid, order, 0)
    return q, valid


def mask_sparsity(mask: Tensor) -> Tensor:
    """p = ‖M‖²_F / (c·b)   (Eq. 18)."""
    return mask.sum() / mask.numel()


def check_nm(mask: Tensor, n: int, m: int) -> bool:
    """True iff every m-group of every row has exactly n ones."""
    c, b = mask.shape
    return bool((mask.reshape(c, b // m, m).sum(-1) == n).all())
