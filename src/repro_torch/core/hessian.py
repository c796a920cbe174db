"""Calibration Hessian accumulation and inverse-Hessian machinery (port of
``repro/core/hessian.py``).

``HessianAccumulator`` keeps ``Σ XᵀX`` in fp32 for one linear layer.  Its
``update`` runs the fused K1 kernel on a CUDA tensor and the kernel's plain
version on a CPU tensor (``kernels/ops.hessian_update``); unlike the JAX
accumulator it updates its tensors **in place** — a (b, b) fp32 sum is up to
127 MB at tinyllama's d_ff — and returns itself, so ``acc = acc.update(x)``
reads the same in both packages.

The inverse-Hessian identity (``H⁻¹ = UᵀU``, ``[H_{j:,j:}]⁻¹ = U[j:,j:]ᵀ
U[j:,j:]``) and the rank-B downdate are those of the JAX module.  A failed
factorization must surface as NaNs, as ``jnp.linalg.cholesky`` signals it,
so that ``core.api.prune_layer_guarded`` can detect it afterwards:
``torch.linalg.cholesky`` raises instead, so the port factorizes with
``cholesky_ex`` and fills a failed factor with NaN, without a host sync.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.faults import InsufficientCalibration
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


@dataclasses.dataclass
class HessianAccumulator:
    """Streaming ``Σ XᵀX`` accumulator for one linear layer.

    ``xtx`` (b, b) fp32; ``count`` () fp32 accumulated rows (tokens);
    ``skipped`` () fp32 non-finite batches dropped whole.
    """

    xtx: Tensor
    count: Tensor
    skipped: Tensor

    @staticmethod
    def init(b: int, device="cpu") -> "HessianAccumulator":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return HessianAccumulator(
            xtx=torch.zeros((b, b), dtype=torch.float32, device=device),
            count=z, skipped=z.clone())

    def update(self, x: Tensor, valid: "Tensor | None" = None
               ) -> "HessianAccumulator":
        """Accumulate a calibration batch x (..., b), in place.

        ``valid`` (x's leading shape, bool) excludes rows from the sum and
        the count.  A batch with any NaN/Inf in a valid row is skipped whole
        and counted in ``skipped``.
        """
        flat = x.reshape(-1, x.shape[-1])
        v = None if valid is None else valid.reshape(-1).to(torch.bool)
        kops.hessian_update(flat, v, self.xtx, self.count, self.skipped)
        return self

    def finalize(self, *, mean: bool = True, min_count: int = 0) -> Tensor:
        """H = 2·XXᵀ (token-averaged when ``mean``).

        ``min_count`` is the minimum-sample guard: fewer accumulated tokens
        raise ``InsufficientCalibration`` (one host sync).
        """
        if min_count:
            n, s = float(self.count), float(self.skipped)
            if n < min_count:
                raise InsufficientCalibration(
                    f"Hessian accumulator closed with {n:.0f} calibration "
                    f"tokens < min_count={min_count} "
                    f"({s:.0f} non-finite batch(es) skipped)")
        if not mean:
            return 2.0 * self.xtx
        scale = torch.where(self.count > 0, self.count, 1.0)
        return 2.0 * self.xtx / scale


DAMP_FLOOR = 1e-8


def dampen(h: Tensor, percdamp: float = 0.01,
           floor: float = DAMP_FLOOR) -> Tensor:
    """H + λI with λ = max(percdamp · mean(diag H), floor); dead features
    (zero diagonal) are revived with a unit diagonal first."""
    dead = torch.diagonal(h) <= 0.0
    h = h + torch.diag(dead.to(h.dtype))
    lam = torch.clamp(percdamp * torch.diagonal(h).mean(), min=floor)
    return h + lam * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)


def dead_features(h: Tensor) -> Tensor:
    """Boolean (b,) mask of features with no calibration signal."""
    return torch.diagonal(h) <= 0.0


def cholesky_nan(a: Tensor, *, upper: bool = False) -> Tensor:
    """Cholesky factor of (a batch of) SPD matrices; a matrix that is not
    numerically positive definite yields an all-NaN factor, as JAX's does."""
    fac, info = torch.linalg.cholesky_ex(a, upper=upper)
    return torch.where((info == 0)[..., None, None], fac, torch.nan)


def inv_cholesky_upper(h: Tensor) -> Tensor:
    """``U`` upper-triangular with ``H⁻¹ = UᵀU`` (one O(b³) setup/layer):
    lower factor of H, triangular inverse, then the upper factor of H⁻¹."""
    lh = cholesky_nan(h)
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    linv = torch.linalg.solve_triangular(lh, eye, upper=False)
    hinv = linv.T @ linv
    return cholesky_nan(hinv, upper=True)


def h_finite(h: Tensor) -> bool:
    """Every entry of H is finite (damping cannot repair Inf/NaN)."""
    return bool(torch.isfinite(h).all())


def factor_finite(u: Tensor) -> bool:
    """The Cholesky factor is finite (a failed factorization is NaN)."""
    return bool(torch.isfinite(u).all())


def trailing_inverse(u_hinv: Tensor, j: int) -> Tensor:
    """``[H_{j:,j:}]⁻¹ = U[j:,j:]ᵀ U[j:,j:]``."""
    ut = u_hinv[j:, j:]
    return ut.T @ ut


def trailing_inverse_rows(u_hinv: Tensor, j: int, rows: Tensor) -> Tensor:
    """Rows ``rows`` (relative to the trailing block) of ``[H_{j:,j:}]⁻¹``
    without forming all of it: ``U[j:, j:][:, rows]ᵀ @ U[j:, j:]``."""
    ut = u_hinv[j:, j:]
    return ut[:, rows].T @ ut


def inverse_from_upper(u_hinv: Tensor) -> Tensor:
    """Dense ``H⁻¹ = UᵀU`` — the starting state for ``block_downdate``."""
    return u_hinv.T @ u_hinv


def block_downdate(hinv_trail: Tensor, u_hinv: Tensor, j1: int,
                   block_size: int) -> Tensor:
    """Advance the embedded trailing inverse by one block, **in place**:
    ``Hinv −= U[j1:j1+B, :]ᵀ U[j1:j1+B, :]`` (O(B·b²)).

    The slice start clamps to ``b − B`` for a ragged last block, as the JAX
    ``dynamic_slice`` does; the Thanos loops discard that final state.
    """
    b = u_hinv.shape[0]
    start = min(j1, b - block_size)
    ub = u_hinv[start:start + block_size]
    return hinv_trail.addmm_(ub.T, ub, alpha=-1.0)
