"""K2: the n:m compressed-weight matmul y = x·Wᵀ (port of
``repro/kernels/nm_spmm.py``).

``nm_matmul_cuda`` launches the hand-written kernel in ``csrc/nm_spmm.cu``
(see the note there: what it replaces, what bounds it on the H100 and what
its design does about it).  The plain version is ``ref.nm_matmul_ref``,
re-exported here as ``nm_matmul_plain``: it expands W and multiplies in x's
dtype, where the kernel sums in fp32 — so the two agree within a tolerance,
not bitwise.  The Pallas wrapper's tile chooser and pad/slice do not carry
over: the kernel masks its own ragged edges.

Layout (g = b/m groups, keep = m − n):
    values  (c, g·keep)      x's dtype
    indices (c, g·keep)      uint8, idx_bits = 8
            (c, ⌈g·keep/2⌉)  uint8, idx_bits = 4, low nibble first
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import nm_matmul_ref as nm_matmul_plain

Tensor = torch.Tensor

__all__ = ["nm_matmul_cuda", "nm_matmul_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    fn = _build.load("nm_spmm").nm_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_layout(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
                  b: int, idx_bits: int) -> int:
    keep = m - n
    gk = (b // m) * keep
    if x.dim() != 2 or x.shape[1] != b:
        raise ValueError(f"x must be (B, {b}), got {tuple(x.shape)}")
    if b % m or values.dim() != 2 or values.shape[1] != gk:
        raise ValueError(f"bad compressed layout {tuple(values.shape)} for "
                         f"b={b} {n}:{m}")
    width = (gk + 1) // 2 if idx_bits == 4 else gk
    if idx_bits not in (4, 8) or indices.shape != (values.shape[0], width):
        raise ValueError(f"bad index layout {tuple(indices.shape)} for "
                         f"idx_bits={idx_bits}")
    return gk


def nm_matmul_cuda(x: Tensor, values: Tensor, indices: Tensor, *, n: int,
                   m: int, b: int, idx_bits: int = 8) -> Tensor:
    """Launch K2 on the current stream: x (B, b) → y (B, c) in x's dtype."""
    L = _check_layout(x, values, indices, n, m, b, idx_bits)
    if x.dtype not in _DTYPES or values.dtype != x.dtype:
        raise ValueError(f"K2 takes float32/bfloat16 x with values of the "
                         f"same dtype, got {x.dtype} and {values.dtype}")
    if indices.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"indices must be 8-bit, got {indices.dtype}")
    if not (x.is_cuda and values.device == x.device
            and indices.device == x.device):
        raise ValueError("K2 needs x, values and indices on one CUDA device")
    x = x.contiguous()
    values = values.contiguous()
    indices = indices.contiguous().view(torch.uint8)
    B, c = x.shape[0], values.shape[0]
    y = torch.empty((B, c), dtype=x.dtype, device=x.device)
    if B == 0 or c == 0:
        return y
    vec = int(L % 8 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (values, indices)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn()(x.data_ptr(), values.data_ptr(), indices.data_ptr(),
                   y.data_ptr(), _DTYPES[x.dtype], idx_bits, vec, B, c, b, m,
                   m - n, L, indices.shape[1], stream)
    _build.check(status, "nm_matmul")
    nm_matmul_cuda.launches += 1
    nm_matmul_cuda.by_shape[(B, c, b, str(x.dtype), idx_bits)] += 1
    return y


nm_matmul_cuda.launches = 0
nm_matmul_cuda.by_shape = collections.Counter()

