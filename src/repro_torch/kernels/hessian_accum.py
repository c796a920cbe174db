"""K1: the calibration-Hessian update ``xtx += XᵀX``, fused with the guards
of ``HessianAccumulator.update`` (port of ``repro/kernels/hessian_accum.py``).

``hessian_update_cuda`` launches the hand-written kernel in
``csrc/hessian_xtx.cu`` (see the note there: what it replaces, what bounds it
on the H100 and what its design does about it); ``hessian_update_plain`` is
the same function in plain PyTorch.  Both update the accumulator's tensors
in place — ``xtx`` (b, b) fp32, ``count`` and ``skipped`` () fp32 — and
never synchronise with the host:

* rows whose ``valid`` entry is False count as zero rows and are left out
  of ``count`` (masked before the finiteness check);
* a batch with any non-finite value in a valid row is skipped whole and
  ``skipped`` goes up by one;
* otherwise ``xtx += XᵀX`` (fp32 sums whatever the input type — NOT 2·XᵀX:
  the accumulator stores XᵀX and ``finalize`` doubles it) and ``count``
  goes up by the number of valid rows.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def hessian_update_plain(x: Tensor, valid: "Tensor | None", xtx: Tensor,
                         count: Tensor, skipped: Tensor) -> None:
    """The plain PyTorch version of the fused update; x (tokens, b)."""
    flat = x.to(torch.float32)
    if valid is not None:
        flat = torch.where(valid[:, None], flat, 0.0)
        rows = valid.sum(dtype=torch.float32)
    else:
        rows = torch.full((), float(flat.shape[0]), device=flat.device)
    ok = torch.isfinite(flat).all()
    flat = torch.where(ok, flat, 0.0)
    xtx.add_(flat.T @ flat)
    count.add_(torch.where(ok, rows, 0.0))
    skipped.add_(torch.where(ok, 0.0, 1.0))


def _fn():
    fn = _build.load("hessian_xtx").hessian_xtx_update
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, ctypes.c_int64, ctypes.c_int64,
                       p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def hessian_update_cuda(x: Tensor, valid: "Tensor | None", xtx: Tensor,
                        count: Tensor, skipped: Tensor) -> None:
    """Launch K1 on the current stream; x (tokens, b) fp32 or bf16."""
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"K1 takes 2-D float32/bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    tokens, b = x.shape
    for t in (x, xtx, count, skipped) + ((valid,) if valid is not None else ()):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("K1 needs every tensor on x's CUDA device")
    if xtx.shape != (b, b) or xtx.dtype != torch.float32 or \
            not xtx.is_contiguous():
        raise ValueError(f"xtx must be contiguous float32 ({b}, {b})")
    if count.dtype != torch.float32 or skipped.dtype != torch.float32 or \
            count.numel() != 1 or skipped.numel() != 1:
        raise ValueError("count and skipped must be float32 scalars")
    if valid is not None and (valid.shape != (tokens,) or
                              valid.dtype != torch.bool):
        raise ValueError(f"valid must be bool ({tokens},)")
    if b == 0:
        return
    x = x.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    stats = torch.empty(2, dtype=torch.int32, device=x.device)  # scratch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn()(x.data_ptr(), _DTYPES[x.dtype],
                   None if valid is None else valid.data_ptr(),
                   tokens, b, stats.data_ptr(), xtx.data_ptr(),
                   count.data_ptr(), skipped.data_ptr(), stream)
    _build.check(status, "hessian_xtx_update")
    hessian_update_cuda.launches += 1
    hessian_update_cuda.by_shape[(tokens, b, str(x.dtype))] += 1


hessian_update_cuda.launches = 0
hessian_update_cuda.by_shape = collections.Counter()


def hessian_xtx_cuda(x: Tensor) -> Tensor:
    """H = 2·XᵀX, fp32 (b, b), for token-major CUDA x (tokens, b) — the TPU
    kernel's own contract, through K1 on a zero sum."""
    b = x.shape[-1]
    xtx = torch.zeros((b, b), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    skipped = torch.zeros((), dtype=torch.float32, device=x.device)
    hessian_update_cuda(x.reshape(-1, b), None, xtx, count, skipped)
    return 2.0 * xtx
