"""Plain PyTorch oracles for the kernels (port of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.sparsity import unpack_indices4

Tensor = torch.Tensor


def nm_expand(values: Tensor, indices: Tensor, n: int, m: int, b: int,
              idx_bits: int = 8) -> Tensor:
    """Dense (c, b) from group-major n:m storage — in-group placement.

    A static loop of ``keep`` masked selects, as the JAX oracle and the
    Pallas body run it.  Placement only, no arithmetic: bit-exact in the
    stored dtype.
    """
    keep = m - n
    c = values.shape[0]
    g = b // m
    if idx_bits == 4:
        indices = unpack_indices4(indices, g * keep)
    vals = values.reshape(c, g, keep)
    idx = indices.reshape(c, g, keep).to(torch.int64)
    iota = torch.arange(m, device=values.device)[None, None, :]
    dense = torch.zeros((c, g, m), dtype=values.dtype, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for k in range(keep):
        dense = dense + torch.where(idx[:, :, k, None] == iota,
                                    vals[:, :, k, None], zero)
    return dense.reshape(c, b)


def nm_matmul_ref(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
                  b: int, idx_bits: int = 8) -> Tensor:
    """y = x @ denseᵀ for n:m compressed W (c, b); x (B, b) → y (B, c).

    The expanded weight keeps the stored dtype and the matmul runs in the
    activation dtype — the same product as a dense kernel, so serving from
    the compressed form is bit-equal to serving the decompressed weights.
    """
    w = nm_expand(values, indices, n, m, b, idx_bits)
    return (x @ w.to(x.dtype).T).to(x.dtype)


def hessian_ref(x: Tensor) -> Tensor:
    """H = 2·XᵀX for token-major X (tokens, b) — fp32 accumulation."""
    x32 = x.to(torch.float32)
    return 2.0 * (x32.T @ x32)
