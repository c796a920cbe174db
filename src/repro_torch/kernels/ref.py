"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.sparsity import unpack_indices4

Tensor = torch.Tensor


def nm_expand(values: Tensor, indices: Tensor, n: int, m: int, b: int,
              idx_bits: int = 8) -> Tensor:
    """Dense (..., c, b) from group-major n:m storage (..., c, L) —
    in-group placement.

    A static loop of ``keep`` masked selects, as the JAX oracle and the
    Pallas body run it.  Placement only, no arithmetic: bit-exact in the
    stored dtype.
    """
    keep = m - n
    lead = values.shape[:-1]
    g = b // m
    if idx_bits == 4:
        indices = unpack_indices4(indices, g * keep)
    vals = values.reshape(*lead, g, keep)
    idx = indices.reshape(*lead, g, keep).to(torch.int64)
    iota = torch.arange(m, device=values.device)
    dense = torch.zeros((*lead, g, m), dtype=values.dtype,
                        device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for k in range(keep):
        dense = dense + torch.where(idx[..., k, None] == iota,
                                    vals[..., k, None], zero)
    return dense.reshape(*lead, b)


def nm_matmul_ref(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
                  b: int, idx_bits: int = 8) -> Tensor:
    """y = x @ denseᵀ for n:m compressed W (c, b); x (B, b) → y (B, c).

    The expanded weight keeps the stored dtype and the matmul runs in the
    activation dtype — the same product as a dense kernel, so serving from
    the compressed form is bit-equal to serving the decompressed weights.
    """
    w = nm_expand(values, indices, n, m, b, idx_bits)
    return (x @ w.to(x.dtype).T).to(x.dtype)


def nm_expand_stacked(values: Tensor, indices: Tensor, n: int, m: int,
                      b: int, idx_bits: int = 8) -> Tensor:
    """Dense (E, c, b) from stacked storage (E, c, L): ``nm_expand`` over
    the leading expert axis, bit-exact in the stored dtype."""
    return nm_expand(values, indices, n, m, b, idx_bits)


def nm_matmul_stacked_ref(x: Tensor, values: Tensor, indices: Tensor, n: int,
                          m: int, b: int, idx_bits: int = 8) -> Tensor:
    """Batched expert matmul from compressed storage: x (E, C, b) →
    y (E, C, c), y[e] = x[e] @ dense(e)ᵀ.

    The einsum is the one ``layers.stacked_dense`` runs on dense (E, in,
    out) kernels, on a weight of the same layout, so serving the compressed
    stack is bit-equal to serving the decompressed one.
    """
    w = nm_expand_stacked(values, indices, n, m, b, idx_bits)   # (E, c, b)
    w = w.to(x.dtype).transpose(-1, -2)                         # (E, b, c)
    return torch.einsum("ecd,edf->ecf", x, w).to(x.dtype)


def hessian_ref(x: Tensor) -> Tensor:
    """H = 2·XᵀX for token-major X (tokens, b) — fp32 accumulation."""
    x32 = x.to(torch.float32)
    return 2.0 * (x32.T @ x32)
