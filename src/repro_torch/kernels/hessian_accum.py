"""K1: the calibration-Hessian update ``xtx += XᵀX``, fused with the guards
of ``HessianAccumulator.update`` (port of ``repro/kernels/hessian_accum.py``).

``hessian_update_cuda`` launches the hand-written kernels in
``csrc/hessian_xtx.cu`` (see the note there: what they replace, what bounds
them on the H100 and what their design does about it) under the plan
``_k1_plan`` chooses: bf16 x with b % 8 == 0 on the wgmma kernel, its tile
edge, its token split over a cluster and its fill (TMA, or cp.async where
rows are masked) from a sweep on the card (``tools/k1_plan_sweep.py``);
other bf16 x on the mma.sync kernel's scalar-load form, fp32 x on the CUDA
cores.  ``hessian_update_plain`` is the same function in plain PyTorch.
Both update the accumulator's tensors in place — ``xtx`` (b, b) fp32,
``count`` and ``skipped`` () fp32 — and never synchronise with the host:

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
import functools

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {t: str(t) for t in _DTYPES}


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


# _k1_plan's variants, as the source numbers them: the fp32 kernel, the
# mma.sync kernel's scalar loads, and the wgmma kernel's ring
# configurations (WgBase64 … WgDeep in the source):
# tiles of BM = 64 in 4 stages of 64 tokens (3 blocks an SM) or of 128 in 3
# (2 an SM); 64 in 3 stages of 64 (4 an SM); 64 in 3 stages of 128 (2 an SM).
K1_F32, K1_SCALAR, K1_WG, K1_WG_TIGHT, K1_WG_DEEP = range(5)
VARIANTS = {K1_F32: "fp32 CUDA cores",
            K1_SCALAR: "mma.sync scalar loads", K1_WG: "wgmma",
            K1_WG_TIGHT: "wgmma 4 blocks/SM",
            K1_WG_DEEP: "wgmma 128-token stages"}
_BK = {K1_WG: 64, K1_WG_TIGHT: 64, K1_WG_DEEP: 128}
_SMS = 132                    # an H100's SMs


def k1_smem(variant: int, BM: int) -> int:
    """Dynamic shared memory of a K1 launch, as the source lays it out: the
    wgmma kernel's ring (stages of BM/64 boxes of 64 features for each
    operand, 128 bytes a token) and 1 024 bytes to align it; the mma.sync
    kernel's ring of 3 stages of 64 tokens × (BM + 8) bf16 for each operand;
    none for fp32."""
    if variant in _BK:
        nst = 4 if variant == K1_WG and BM == 64 else 3
        return nst * 2 * (BM // 64) * _BK[variant] * 128 + 1024
    if variant == K1_SCALAR:
        return 3 * 2 * 64 * (BM + 8) * 2
    return 0


# The plan table, from tools/k1_plan_sweep.py on the H100 (PERF.md §6).
# Up to _LONG tokens (the card paths' 1 024 a batch): by b up to each
# bound, the wgmma ring configuration, tile edge and xtx prefetch point
# (eighths of the stages; from b = 3 584 the reductions otherwise wait on
# HBM reads of xtx); at ≥ _LONG_BM128 tokens from b > 2 560, tiles of 128
# (x's column slices, read again by every tile, then outweigh xtx).  From
# _LONG tokens, tiles of 128 throughout.  The token split CS doubles while
# the grid has fewer CTAs than the card has SMs and each CTA keeps
# _WG_MIN_STAGES stages: only a long batch over few tiles splits.
_WG_TABLE = ((1152, K1_WG_DEEP, 64, 0), (1536, K1_WG, 64, 0),
             (2048, K1_WG_TIGHT, 64, 0), (2560, K1_WG, 128, 0),
             (4096, K1_WG_DEEP, 64, 7), (14336, K1_WG, 64, 7),
             (None, K1_WG, 128, 7))
_WG_MASKED = (K1_WG_TIGHT, 64, 0)
_LONG_BM128, _LONG = 2048, 8192
_WG_MIN_STAGES = 8
SPLITS = (1, 2, 4, 8)         # CS: up to the portable cluster size


@functools.lru_cache(maxsize=None)
def _k1_plan(tokens: int, b: int, masked: bool, bf16: bool = True,
             aligned: bool = True) -> "tuple[int, int, int, int, int]":
    """K1's launch plan → (tile edge BM, token split CS, variant, dynamic
    shared-memory bytes, xtx prefetch point pf).

    fp32 x: the CUDA-core kernel (``K1_F32``).  bf16 x with b % 8 == 0, at
    least one token and 16-byte aligned x and xtx (``aligned``): the wgmma
    kernel (masked rows zeroed in shared memory), its ring configuration,
    tile, split and prefetch point from the table above.  Other bf16 x: the
    mma.sync kernel's scalar loads (``K1_SCALAR``), tiles of 64 up to
    b = 2 048, else 128.
    """
    if not bf16:
        return 64, 1, K1_F32, 0, 0
    if b % 8 or tokens <= 0 or not aligned:
        BM = 64 if b <= 2048 else 128
        return BM, 1, K1_SCALAR, k1_smem(K1_SCALAR, BM), 0
    if masked:
        variant, BM, pf = _WG_MASKED
    elif tokens >= _LONG:
        variant, BM, pf = K1_WG, 128, 0
    elif tokens >= _LONG_BM128 and b > 2560:
        variant, BM, pf = K1_WG, 128, 7
    else:
        variant, BM, pf = next(row[1:] for row in _WG_TABLE
                               if row[0] is None or b <= row[0])
    nt = -(-b // BM)
    tiles = nt * (nt + 1) // 2
    stages = -(-tokens // _BK[variant])
    CS = 1
    while (CS < SPLITS[-1] and tiles * CS < _SMS
           and stages >= 2 * CS * _WG_MIN_STAGES):
        CS *= 2
    return BM, CS, variant, k1_smem(variant, BM), pf


_FN = None


def _fn():
    """The bound C entry of the built library (bound once a process)."""
    global _FN
    if _FN is None:
        fn = _build.load("hessian_xtx").hessian_xtx_update
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, ctypes.c_int64, ctypes.c_int64,
                       p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


# The scan's int32 scratch (SCAN_PARTS + 2 · SCAN_BLOCKS in the source),
# one a (device, stream): zero when made, and each launch leaves it so.
_STATS_INTS = 4 + 2 * 264
_STATS: dict = {}


def _launch(x: Tensor, valid: "Tensor | None", xtx: Tensor, count: Tensor,
            skipped: Tensor, plan) -> None:
    """One K1 launch under ``plan`` (checked, contiguous operands)."""
    tokens, b = x.shape
    BM, CS, variant, smem, pf = plan
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    stats = _STATS.get((dev, stream))
    if stats is None:
        stats = torch.zeros(_STATS_INTS, dtype=torch.int32, device=x.device)
        _STATS[(dev, stream)] = stats
    status = _fn()(x.data_ptr(), _DTYPES[x.dtype],
                   None if valid is None else valid.data_ptr(),
                   tokens, b, stats.data_ptr(), xtx.data_ptr(),
                   count.data_ptr(), skipped.data_ptr(), variant, BM, CS,
                   smem, pf, stream)
    _build.check(status, "hessian_xtx_update")


def k1_operands(x: Tensor, valid: "Tensor | None", xtx: Tensor):
    """K1's checked, contiguous x and valid and their launch plan →
    (x, valid, plan)."""
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError(f"K1 takes 2-D float32/bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    tokens, b = x.shape
    if valid is not None:
        if valid.shape != (tokens,) or valid.dtype != torch.bool:
            raise ValueError(f"valid must be bool ({tokens},)")
        valid = valid.contiguous()
    x = x.contiguous()
    plan = _k1_plan(tokens, b, valid is not None, x.dtype == torch.bfloat16,
                    (x.data_ptr() | xtx.data_ptr()) % 16 == 0)
    return x, valid, plan


def hessian_update_cuda(x: Tensor, valid: "Tensor | None", xtx: Tensor,
                        count: Tensor, skipped: Tensor) -> None:
    """Launch K1 on the current stream; x (tokens, b) fp32 or bf16."""
    dev = x.device
    if not (x.is_cuda and xtx.device == dev and count.device == dev
            and skipped.device == dev
            and (valid is None or valid.device == dev)):
        raise ValueError("K1 needs every tensor on x's CUDA device")
    x, valid, plan = k1_operands(x, valid, xtx)
    tokens, b = x.shape
    if xtx.shape != (b, b) or xtx.dtype != torch.float32 or \
            not xtx.is_contiguous():
        raise ValueError(f"xtx must be contiguous float32 ({b}, {b})")
    if count.dtype != torch.float32 or skipped.dtype != torch.float32 or \
            count.numel() != 1 or skipped.numel() != 1:
        raise ValueError("count and skipped must be float32 scalars")
    if b == 0:
        return
    _launch(x, valid, xtx, count, skipped, plan)
    hessian_update_cuda.launches += 1
    hessian_update_cuda.by_shape[(tokens, b, _NAMES[x.dtype])] += 1


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
