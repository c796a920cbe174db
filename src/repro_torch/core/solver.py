"""Batched padded multi-weight OBS solve — paper Eq. 10 + Appendix H.1/H.2
(port of ``repro/core/solver.py``).

Every row's pruned indices q index into the trailing inverse Hessian:
``R̂ = Hinv[q, q]``, ``u = w[q]``, ``λ̂ R̂ = u``, ``Δ = −λ̂ Hinv[q, :]``.
Rows are padded to a common ``r_max`` with an identity block in R̂ and zeros
in u (Eq. 77–79), so the whole batch is one batched SPD solve.  The JAX
module inverts the Cholesky factor with batched matmuls because XLA's CPU
triangular solve is slow (``_tri_inv_lower``); the port solves with
``cholesky_ex`` + ``cholesky_solve`` on both devices — the same result, not
the same formulation.  A factor that fails turns its row's multipliers NaN
(``hessian.cholesky_nan``), and ``solution_finite`` detects that after the
solve, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.core.hessian import cholesky_nan

Tensor = torch.Tensor


def _padded_system(hinv: Tensor, w: Tensor, q_abs: Tensor, valid: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """Build the padded per-row systems (R̂', u') of Appendix H.1."""
    u = torch.where(valid, torch.gather(w, 1, q_abs), 0.0)       # (c, r)
    rhat = hinv[q_abs[:, :, None], q_abs[:, None, :]]            # (c, r, r)
    both = valid[:, :, None] & valid[:, None, :]
    pad = (~valid[:, :, None]) & (~valid[:, None, :])
    eye = torch.eye(q_abs.shape[1], dtype=hinv.dtype, device=hinv.device)
    rhat = torch.where(both, rhat, 0.0) + torch.where(pad, eye, 0.0)
    return rhat, u


def solution_finite(*tensors: Tensor) -> bool:
    """Host-level finiteness check over solve outputs (one sync per tensor;
    call it once per layer, never per block)."""
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def batched_multipliers(hinv: Tensor, w: Tensor, q_abs: Tensor,
                        valid: Tensor) -> Tensor:
    """Solve all rows' padded systems; return multipliers λ̂ (c, r_max)."""
    rhat, u = _padded_system(hinv, w, q_abs, valid)
    lam = torch.cholesky_solve(u[..., None], cholesky_nan(rhat))[..., 0]
    return torch.where(valid, lam, 0.0)


def _multipliers_chunked(hinv: Tensor, w: Tensor, q_abs: Tensor,
                         valid: Tensor, row_chunk: int) -> Tensor:
    """λ̂ for all rows, chunked over rows when requested (Appendix H.2)."""
    c = w.shape[0]
    if row_chunk and c > row_chunk and c % row_chunk == 0:
        return torch.cat([
            batched_multipliers(hinv, w[s:s + row_chunk],
                                q_abs[s:s + row_chunk],
                                valid[s:s + row_chunk])
            for s in range(0, c, row_chunk)])
    return batched_multipliers(hinv, w, q_abs, valid)


def _scatter(q: Tensor, valid: Tensor, lam: Tensor, width: int,
             dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    """Λ (c, width): each row's multipliers scatter-added at its pruned
    columns ``q``, and the mask of those columns (where the update is
    clamped to exact zeros).  Invalid slots carry λ̂ = 0 / valid = False, so
    their scatter is a no-op."""
    c = q.shape[0]
    lam_dense = torch.zeros((c, width), dtype=dtype,
                            device=lam.device).scatter_add_(
        1, q, torch.where(valid, lam, 0.0))
    hit = torch.zeros((c, width), dtype=torch.int32, device=q.device
                      ).scatter_add_(1, q, valid.to(torch.int32))
    return lam_dense, hit > 0


def apply_update(hinv: Tensor, w: Tensor, q_abs: Tensor, valid: Tensor,
                 lam: Tensor) -> Tensor:
    """``W − Λ @ Hinv`` with Λ (c, b) the multipliers scatter-added at each
    row's pruned columns; the pruned positions are then set to exact zeros
    (the analytic update sends them to 0 up to roundoff)."""
    lam_dense, hit = _scatter(q_abs, valid, lam, w.shape[1], hinv.dtype)
    return (w - lam_dense @ hinv).masked_fill(hit, 0.0)


def prune_rows_block(hinv: Tensor, w: Tensor, q_abs: Tensor, valid: Tensor,
                     *, row_chunk: int = 0) -> Tensor:
    """Full padded solve + update, optionally chunked over rows (App. H.2)."""
    lam = _multipliers_chunked(hinv, w, q_abs, valid, row_chunk)
    return apply_update(hinv, w, q_abs, valid, lam)


def prune_block(hinv: Tensor, w: Tensor, q_abs: Tensor, valid: Tensor,
                j1: int, block_size: int, *, row_chunk: int = 0
                ) -> tuple[Tensor, Tensor]:
    """Single-solve OBS for one column block: (updated weights, Σ_rows S_k).

    The multipliers feed both the loss (S = ½ λ̂·u, Eq. 61) and the update,
    which reads only the B in-block rows of the trailing inverse:
    ``(c, B) @ Hinv[start:start+B, :]``.  Columns left of j1 are finished
    and masked out of the update; a ragged last block anchors the slice at
    ``min(j1, b − B)``.
    """
    b = w.shape[1]
    lam = _multipliers_chunked(hinv, w, q_abs, valid, row_chunk)
    u = torch.where(valid, torch.gather(w, 1, q_abs), 0.0)
    loss = 0.5 * (lam * u).sum()

    start = min(j1, b - block_size)
    lam_blk, hit = _scatter(q_abs - start, valid, lam, block_size,
                            hinv.dtype)
    delta = lam_blk @ hinv[start:start + block_size]
    delta[:, :j1] = 0.0
    w_new = w - delta
    w_new[:, start:start + block_size].masked_fill_(hit, 0.0)
    return w_new, loss


def obs_loss(hinv: Tensor, w: Tensor, q_abs: Tensor, valid: Tensor
             ) -> Tensor:
    """S_k per row (Eq. 61) in its closed form ½ u R̂⁻¹ uᵀ (R H Rᵀ = R̂): a
    standalone diagnostic; ``prune_block`` gets the loss from its solve."""
    lam = batched_multipliers(hinv, w, q_abs, valid)
    u = torch.where(valid, torch.gather(w, 1, q_abs), 0.0)
    return 0.5 * (lam * u).sum(dim=1)
