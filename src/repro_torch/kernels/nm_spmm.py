"""K2: the n:m compressed-weight matmul y = x·Wᵀ (port of
``repro/kernels/nm_spmm.py``), and K3: the same product over a stacked
expert leaf, y[e] = x[e]·W_eᵀ (port of ``repro/kernels/ops.py::
nm_matmul_stacked``), as one launch per leaf.

``nm_matmul_cuda`` launches the hand-written kernels in ``csrc/nm_spmm.cu``
(see the notes there: what they replace, what bounds them on the H100 and
what their design does about it), as ``_k2_plan`` chooses: bf16 2:4 at
B ≥ ``_ROWS_MIN_B`` activation rows on the many-row kernel (mode 3,
``nm_sp_rows_kernel``); below it on the decode kernel (mode 4,
``nm_sp_dec_kernel``) where the plan measured it faster, else on the 8-row
tensor-core kernel (mode 2); other formats on the warp-per-row kernel
(modes 0 and 1).  The decode regime is bound by the weight bytes read once:
mode 4 streams 64-row tiles through a TMA ring and splits K over a cluster
so that the grid covers the card, with x's few rows a slice of each ring
stage, where mode 2 copied them whole into every 8-row block.  The many-row
regime is bound by the weight bytes at B = 128 (decode at production
batch: the compressed weight read once is 0.625 of the dense bytes) and by
the tensor-core rate by B = 6 000 (whisper's encoder); the 8-row kernel
streamed the weight once per 8 rows, so its time grew with B.  Mode 3
reads each weight tile once for 64–128 rows on Hopper's 2:4 sparse tensor
cores (``wgmma.mma_async.sp``), the served format being exactly what they
take, with the metadata built in registers from the stored positions.  The plain
version is ``ref.nm_matmul_ref``, re-exported here as ``nm_matmul_plain``:
it expands W and multiplies in x's dtype, where the kernels sum in fp32 —
so the two agree within a tolerance, not bitwise.  The Pallas wrapper's
tile chooser and pad/slice do not carry over: the kernels mask their own
ragged edges.

Layout (g = b/m groups, keep = m − n; K3 adds a leading expert axis E):
    values  (c, g·keep)      x's dtype
    indices (c, g·keep)      uint8, idx_bits = 8
            (c, ⌈g·keep/2⌉)  uint8, idx_bits = 4, low nibble first

K3's plain version is ``ref.nm_matmul_stacked_ref`` (``nm_matmul_stacked_
plain``).  A group of 8 capacity rows that is all zero skips its weights
(see the notes in the source); ``stacked_stream_bytes`` counts the bytes a
given x makes K3 move.  ``_k3_plan`` picks the kernel from (E, C, c, b,
idx_bits) alone — the host never sees how many tokens were routed: bf16 2:4
on the decode-occupancy kernel (mode 4,
``nm_stacked_sp_dec_kernel``: a vote, then a persistent grid that streams
only the active groups' 128-row weight tiles by TMA onto the sparse tensor
cores, the K range split over a cluster where the active tiles are few),
elsewhere on the older stacked kernels, which stage each expert's 8
activation rows in shared memory beside a ring of weight stages (bounding
b: 8·⌈b/8⌉·8 elements of x's dtype must fit in 227 KB) — the 8-row
tensor-core kernel (mode 2) or the CUDA-core ring and scalar paths (modes
1, 0).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import nm_matmul_ref as nm_matmul_plain
from repro_torch.kernels.ref import \
    nm_matmul_stacked_ref as nm_matmul_stacked_plain

Tensor = torch.Tensor

__all__ = ["KernelCount", "active_row_groups", "nm_matmul_cuda",
           "nm_matmul_plain", "nm_matmul_stacked_cuda",
           "nm_matmul_stacked_plain", "nm_sp_dec", "nm_sp_rows",
           "nm_stacked_sp_dec", "stacked_stream_bytes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024      # bytes of shared memory a block may use
_MAXB = 8                     # activation rows per pass (MAXB in the source)
_K2_WARPS = 8                 # warps of a K2 tensor-core block (K2_WARPS)
# K3's block and ring, as in the source: K3_THREADS, BLOCK_ROWS, NST
_K3_THREADS, _K3_BLOCK_ROWS, _K3_NST = 256, 128, 3
_K3_STAGE_BYTES = 16 * 1024   # target bytes of one ring stage
_K3_TC_STAGE_BYTES = 20 * 1024  # tensor cores: 16-row stages up to this
_SMS = 132                    # an H100's SMs: the grid the many-row plan fills
# K2's many-row ring, as in the source: stages of SP_KS 32-column steps
# (128-byte rows of values and of each x sub-tile), as many as fit up to
# SP_MAXST, 1 024 bytes to align the ring
_SP_KS, _SP_MAXST = 4, 4
# The least B and c that take the many-row path (mode 3); below them the
# 8-row tensor-core path (mode 2) is kept.  The CTAs a many-row grid aims
# at: 96 for a weight streamed from HBM (> _ROWS_L2_BYTES); 64 for one that
# stays in L2, past which a K split costs more than the SMs it fills — or
# 128 where its unsplit grid has ≥ 32 blocks (two blocks of activation
# rows then read it once from HBM).  Measured with tools/k2_plan_sweep.py
# (PERF.md §6, PR 27).
_ROWS_MIN_B = 64
_ROWS_MIN_C = 64
_ROWS_MIN_CTAS, _ROWS_STREAM_CTAS, _ROWS_FULL_CTAS = 64, 96, 128
_ROWS_L2_BYTES = 32 * 2**20
# K2's decode ring (mode 4), as in the source: DEC_BM output rows a block,
# stages of DEC_KS 32-column steps, 2 … DEC_MAXST of them (static
# mbarriers: 2 · DEC_MAXST + 1 of 8 bytes).  Its plan: the least split
# whose CTAs reach _DEC_CTAS (_DEC_CTAS_WIDE where B > 32: a stage then
# carries 2–8× the x bytes), a ring of _DEC_NST stages — more CTAs an SM
# with shallow rings beat one deep ring (tools/k2_plan_sweep.py --part
# decode, PERF.md §6).
_DEC_KS, _DEC_MAXST, _DEC_BM = 4, 32, 64
_DEC_SPLITS = (1, 2, 4, 8)
_DEC_NST, _DEC_CTAS, _DEC_CTAS_WIDE = 4, 132, 66
# What the decode rule reads of the 8-row kernel's grid: an H100 SM's
# shared memory (1 KB of it reserved a block) and the blocks an SM its
# registers allow (256 threads of 40 registers: 6 in 64 K)
_SMEM_SM, _SMEM_BLOCK_RESERVED, _TC_BLOCKS_SM = 228 * 1024, 1024, 6


class _DecRule(NamedTuple):
    """Where the decode kernel (mode 4) takes a row below _ROWS_MIN_B
    activation rows (``_k2_dec_wins``), read off the 8-row kernel's grid
    and the weight's bytes."""
    one_per: int      # B = 1: the 8-row kernel's blocks an SM, at most
    one_waves: int    # B = 1: its waves over the card's SMs, at least
    few_waves: int    # 2 ≤ B ≤ 8: its waves, at least
    few_b: int        # 2 ≤ B ≤ 8: columns b, at least
    many_bytes: int   # 8 < B: B · the weight's bytes, at least
    wide_max_b: int   # rows too wide for one 8-row block: up to this B


# fitted by tools/k2_dec_rule.py to the sweep tools/k2_decode_sweep.json:
# mode 4 only where it ran in ≤ 0.95 of the replaced mode's time there
# (many_bytes: 62.5 MiB)
_DEC_RULE = _DecRule(one_per=1, one_waves=2, few_waves=2, few_b=2560,
                     many_bytes=65_536_000, wide_max_b=8)


def _bind(lib: ctypes.CDLL, name: str):
    """Entry point ``name`` of a built nm_spmm library, with its types:
    nm_matmul's 4 pointers and 14 ints, nm_matmul_stacked's 5 (its flags
    scratch last) and 15, then the stream."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ptrs, ints = (4, 14) if name == "nm_matmul" else (5, 15)
        fn.argtypes = [p] * ptrs + [i] * ints + [p]
        fn.restype = ctypes.c_int
    return fn


def _fn(name: str):
    return _bind(_build.load("nm_spmm"), name)


def _check_layout(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
                  b: int, idx_bits: int) -> int:
    """Shapes of one 2-D (lead = ()) or stacked (lead = (E,)) call → L."""
    keep = m - n
    gk = (b // m) * keep
    lead = values.shape[:-2]
    if x.dim() != 2 + len(lead) or x.shape[:-2] != lead or x.shape[-1] != b:
        raise ValueError(f"x must be {(*lead, 'B', b)}, got "
                         f"{tuple(x.shape)}")
    if b % m or values.shape[-1] != gk:
        raise ValueError(f"bad compressed layout {tuple(values.shape)} for "
                         f"b={b} {n}:{m}")
    width = (gk + 1) // 2 if idx_bits == 4 else gk
    if idx_bits not in (4, 8) or \
            indices.shape != (*values.shape[:-1], width):
        raise ValueError(f"bad index layout {tuple(indices.shape)} for "
                         f"idx_bits={idx_bits}")
    return gk


def _check_operands(x: Tensor, values: Tensor, indices: Tensor,
                    what: str) -> None:
    if x.dtype not in _DTYPES or values.dtype != x.dtype:
        raise ValueError(f"{what} takes float32/bfloat16 x with values of "
                         f"the same dtype, got {x.dtype} and {values.dtype}")
    if indices.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"indices must be 8-bit, got {indices.dtype}")
    if not (x.is_cuda and values.device == x.device
            and indices.device == x.device):
        raise ValueError(f"{what} needs x, values and indices on one CUDA "
                         "device")


@functools.lru_cache(maxsize=None)
def _k2_plan(c: int, b: int, L: int, idx_stride: int, B: int, esize: int,
             aligned: bool, n: int = 2, m: int = 4,
             x_aligned: bool = True) -> "tuple[int, int, int, int, int]":
    """K2's launch plan → (mode, CS CTAs a cluster, dynamic shared-memory
    bytes, BM output rows and BN activation rows a block), as the source
    lays them out.

    The tensor-core paths need bf16 2:4 with aligned bases of values and
    indices (``aligned``), b % 32 == 0 and index rows of exactly
    L·idx_bits/8 bytes.  mode 3, the many-row path: also a 16-byte aligned
    x (``x_aligned``) and c ≥ ``_ROWS_MIN_C``, and B ≥ ``_ROWS_MIN_B``;
    tiles and split from ``_k2_rows_plan``.  mode 4, the decode path, below
    that, with index rows of whole 16-byte rows too (its tensor map):
    where ``_k2_dec_wins`` takes it from the 8-row path, and on rows too
    wide for one 8-row block (the 8-row plan would split them over a
    cluster, or cannot hold them at all) up to ``_DEC_RULE.wide_max_b``
    rows — past that, and on other index rows, such rows take the
    many-row path; tiles, split and ring from ``_k2_dec_plan``.  mode 2,
    the 8-row path (BM = BN = 8): CS is the
    least of 1, 2, 4, 8 whose column slices keep 16-byte rows of values and
    indices and fit ``_k2_smem`` in 227 KB — 1 at every other serving
    shape: a split measured slower there (``tools/k2_plan_sweep.py``).
    mode 1, the warp-per-row kernel with 16-byte loads (L % 8 == 0, aligned
    bases), and mode 0, its scalar path, for every other layout and dtype
    and where no split fits; CS = 1, no dynamic shared memory, 8 × 8
    blocks.
    """
    bits = 8 * idx_stride // L if L else 0
    tc = (aligned and esize == 2 and (n, m) == (2, 4) and 2 * L == b
          and b % 32 == 0 and bits in (4, 8)
          and idx_stride * 8 == L * bits)
    rows = tc and x_aligned and c >= _ROWS_MIN_C
    if rows and B >= _ROWS_MIN_B:
        return _k2_rows_plan(c, b, B, bits)
    dec = rows and idx_stride % 16 == 0
    if tc:
        for CS in (1, 2, 4, 8):
            if b % (32 * CS) or idx_stride % CS or (idx_stride // CS) % 16:
                continue
            smem = _k2_smem(b, L, idx_stride, B, CS)
            if smem + 64 <= _SMEM_LIMIT:
                if rows and CS > 1:
                    break
                if dec and _k2_dec_wins(c, b, B, idx_stride, smem):
                    return _k2_dec_plan(c, b, B, bits)
                return 2, CS, smem, _MAXB, _MAXB
        if dec and B <= _DEC_RULE.wide_max_b:
            return _k2_dec_plan(c, b, B, bits)
        if rows:
            return _k2_rows_plan(c, b, B, bits)
    return int(aligned and L % 8 == 0), 1, 0, _MAXB, _MAXB


def _k2_rows_plan(c: int, b: int, B: int,
                  bits: int) -> "tuple[int, int, int, int, int]":
    """The many-row plan (mode 3): BN = 64 activation rows a block up to
    B = 64, else 128.  Blocks of 256 output rows where they alone give the
    card's 132 SMs four CTAs each (compute-bound: each x tile then serves
    twice the weight rows; fewer waves lose that to the last one) and their
    ring holds 3 stages.  Else 128-row blocks and the least split CS ∈
    {1, 2, 4, 8} (each CTA keeps ≥ one 32-column step) that reaches the
    target: _ROWS_STREAM_CTAS for a weight streamed from HBM,
    _ROWS_MIN_CTAS for one that stays in L2 — _ROWS_FULL_CTAS on a grid of
    ≥ 32 blocks, blocks of 64 activation rows coming before each doubling
    of CS; where none reaches it, the most CTAs."""
    BN = 64 if B <= 64 else 128
    if (_k2_rows_nst(256, BN, bits) >= 3
            and -(-c // 256) * -(-B // BN) >= 4 * _SMS):
        return 3, 1, _k2_rows_smem(256, BN, bits), 256, BN
    blocks = -(-c // 128) * -(-B // BN)
    in_l2 = c * b * (16 + bits) // 16 <= _ROWS_L2_BYTES   # values + indices
    full = in_l2 and blocks >= 32
    target = (_ROWS_FULL_CTAS if full else _ROWS_MIN_CTAS) if in_l2 \
        else _ROWS_STREAM_CTAS
    tiles = (BN, 64) if full and BN == 128 else (BN,)
    best = None
    for CS in (1, 2, 4, 8):
        if b // 32 < CS:
            break
        for bn in tiles:
            ctas = -(-c // 128) * -(-B // bn) * CS
            plan = (3, CS, _k2_rows_smem(128, bn, bits), 128, bn)
            if ctas >= target:
                return plan
            if best is None or ctas > best[0]:
                best = (ctas, plan)
    return best[1]


def _k2_dec_wins(c: int, b: int, B: int, idx_stride: int, smem: int,
                 rule: "_DecRule | None" = None) -> bool:
    """Whether the decode kernel (mode 4) takes a row (c, b) at B <
    _ROWS_MIN_B rows from the 8-row kernel, whose unsplit plan needs
    ``smem`` bytes a block, by ``rule`` (``_DEC_RULE``): read off that
    plan's grid of c/8 blocks — the blocks an SM fits and the waves they
    take over the card — at B ≤ 8, where the 8-row kernel streams the
    weight once, and off the bytes past it, where it streams them once for
    every 8 rows."""
    rule = _DEC_RULE if rule is None else rule
    per = min(_TC_BLOCKS_SM, _SMEM_SM // (smem + _SMEM_BLOCK_RESERVED))
    waves = -(-(-(-c // _MAXB)) // (_SMS * per))
    if B == 1:
        return per <= rule.one_per and waves >= rule.one_waves
    if B <= _MAXB:
        return waves >= rule.few_waves and b >= rule.few_b
    return B * c * (b + idx_stride) >= rule.many_bytes


def _k2_dec_plan(c: int, b: int, B: int,
                 bits: int) -> "tuple[int, int, int, int, int]":
    """The decode plan (mode 4): N = 8·⌈B/8⌉ activation rows, blocks of
    _DEC_BM output rows, the least split CS ∈ {1, 2, 4, 8} (each CTA
    keeping ≥ one stage) whose CTAs reach _DEC_CTAS (_DEC_CTAS_WIDE where
    B > 32), else the most, and a ring of _DEC_NST stages, cut to the
    CTA's own stages (at least 2)."""
    N = 8 * -(-B // 8)
    BM = _DEC_BM
    nks = -(-b // (32 * _DEC_KS))
    target = _DEC_CTAS if B <= 32 else _DEC_CTAS_WIDE
    CS = 1
    for cs in _DEC_SPLITS:
        if nks < cs:
            break
        CS = cs
        if -(-c // BM) * cs >= target:
            break
    nst = max(2, min(_DEC_NST, -(-nks // CS)))
    return 4, CS, _k2_dec_smem(BM, N, bits, nst, CS), BM, N


def _k2_rows_stage(BM: int, BN: int, bits: int) -> int:
    """Bytes of a stage of K2's many-row ring (sp_stage in the source): x
    (BN rows of 2 × 128 bytes), values (BM rows of 128 bytes) and index
    bytes."""
    return 2 * BN * 128 + BM * _SP_KS * 32 + BM * _SP_KS * (
        8 if bits == 4 else 16)


def _k2_rows_nst(BM: int, BN: int, bits: int) -> int:
    """Stages of K2's many-row ring (sp_nst in the source): as many as fit
    in 227 KB beside 1 024 bytes of alignment and the mbarriers, at most
    _SP_MAXST; the pipeline needs 3."""
    return min(_SP_MAXST,
               (_SMEM_LIMIT - 1024 - 64) // _k2_rows_stage(BM, BN, bits))


def _k2_rows_smem(BM: int, BN: int, bits: int) -> int:
    """Dynamic shared memory of K2's many-row path (sp_smem in the source):
    its ring and 1 024 bytes of alignment; the fp32 output tile of the
    epilogue reuses it."""
    return (_k2_rows_nst(BM, BN, bits) * _k2_rows_stage(BM, BN, bits)
            + 1024)


def _k2_dec_stage(BM: int, N: int, bits: int) -> int:
    """Bytes of a stage of K2's decode ring (dec_stage in the source): x
    (N rows of DEC_KS · 64 bytes), values (BM rows of DEC_KS · 32 bytes)
    and index bytes."""
    return _DEC_KS // 2 * N * 128 + BM * _DEC_KS * 32 + BM * _DEC_KS * (
        8 if bits == 4 else 16)


def _k2_dec_red(BM: int, N: int, CS: int) -> int:
    """Bytes of the decode path's receive buffer (dec_red in the source):
    a split's partial rows, BM · N fp32; none unsplit."""
    return BM * N * 4 if CS > 1 else 0


def _k2_dec_smem(BM: int, N: int, bits: int, nst: int, CS: int) -> int:
    """Dynamic shared memory of K2's decode path with an ``nst``-stage ring
    (dec_smem in the source): the ring, 1 024 bytes of alignment and a
    split's receive buffer."""
    return nst * _k2_dec_stage(BM, N, bits) + 1024 + _k2_dec_red(BM, N, CS)


def _k2_dec_nst_max(BM: int, N: int, bits: int, CS: int) -> int:
    """The deepest decode ring that fits in 227 KB beside its mbarriers."""
    return min(_DEC_MAXST, (_SMEM_LIMIT - 1024 - 8 * (2 * _DEC_MAXST + 1)
                            - _k2_dec_red(BM, N, CS))
               // _k2_dec_stage(BM, N, bits))


def _k2_dec_nst(smem: int, BM: int, N: int, bits: int, CS: int) -> int:
    """The ring depth a decode plan's shared memory holds."""
    return (smem - 1024 - _k2_dec_red(BM, N, CS)) // _k2_dec_stage(BM, N,
                                                                    bits)


def _k2_smem(b: int, L: int, idx_stride: int, B: int, CS: int) -> int:
    """Dynamic shared memory of K2's tensor-core path (tc_smem in the
    source): a block's 8 weight-row slices, min(B, 8) x row slices padded
    to ≡ 16 (mod 128) bytes, the partial tiles of its warps and its own."""
    return (8 * ((2 * L + idx_stride) // CS)
            + min(_MAXB, B) * _pad_to(2 * (b // CS), 16)
            + (_K2_WARPS + 1) * 64 * 4)


def _k2_ctas(c: int, B: int, plan: "tuple[int, int, int, int, int]") -> int:
    """CTAs (blocks) of a K2 launch under ``plan``: BM output rows and BN
    activation rows a block, CS blocks a cluster."""
    return -(-c // plan[3]) * plan[1] * -(-B // plan[4])


def _launch_k2(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
               b: int, idx_bits: int, plan) -> Tensor:
    """One K2 launch under ``plan`` (checked operands, contiguous) → y."""
    B, c, L = x.shape[0], values.shape[0], values.shape[1]
    y = torch.empty((B, c), dtype=x.dtype, device=x.device)
    if B == 0 or c == 0:
        return y
    mode, CS, smem, BM, BN = plan
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn("nm_matmul")(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
        _DTYPES[x.dtype], idx_bits, mode, B, c, b, m, m - n, L,
        indices.shape[1], CS, smem, BM, BN, stream)
    _build.check(status, "nm_matmul")
    return y


def _k2_operands(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
                b: int, idx_bits: int):
    """K2's checked, contiguous operands and their launch plan →
    (x, values, indices, plan)."""
    if values.dim() != 2:
        raise ValueError(f"K2 takes 2-D values, got {tuple(values.shape)}")
    L = _check_layout(x, values, indices, n, m, b, idx_bits)
    _check_operands(x, values, indices, "K2")
    x = x.contiguous()
    values = values.contiguous()
    indices = indices.contiguous().view(torch.uint8)
    plan = _k2_plan(values.shape[0], b, L, indices.shape[1], x.shape[0],
                    x.element_size(),
                    all(t.data_ptr() % 16 == 0 for t in (values, indices)),
                    n, m, x.data_ptr() % 16 == 0)
    return x, values, indices, plan


def nm_matmul_cuda(x: Tensor, values: Tensor, indices: Tensor, *, n: int,
                   m: int, b: int, idx_bits: int = 8) -> Tensor:
    """Launch K2 on the current stream: x (B, b) → y (B, c) in x's dtype."""
    x, values, indices, plan = _k2_operands(x, values, indices, n, m, b,
                                           idx_bits)
    y = _launch_k2(x, values, indices, n, m, b, idx_bits, plan)
    if y.numel() == 0:
        return y
    key = (x.shape[0], values.shape[0], b, str(x.dtype), idx_bits)
    nm_matmul_cuda.launches += 1
    nm_matmul_cuda.by_shape[key] += 1
    if plan[0] in (3, 4):
        kern = nm_sp_rows if plan[0] == 3 else nm_sp_dec
        kern.launches += 1
        kern.by_shape[key] += 1
    return y


class KernelCount:
    """The launches of one ``__global__`` of a wrapper that runs several:
    ``launches`` and ``by_shape`` as the wrapper counts them, named after
    the kernel (``__name__``), so that a launch tally carries it too."""

    def __init__(self, name: str) -> None:
        self.__name__ = name
        self.launches = 0
        self.by_shape: collections.Counter = collections.Counter()


nm_matmul_cuda.launches = 0
nm_matmul_cuda.by_shape = collections.Counter()
# the K2 launches that ran the many-row kernel (plan mode 3), a subset of
# nm_matmul_cuda's
nm_sp_rows = KernelCount("nm_sp_rows_kernel")
# the K2 launches that ran the decode kernel (plan mode 4)
nm_sp_dec = KernelCount("nm_sp_dec_kernel")


def _pad_to(nbytes: int, rem: int) -> int:
    """The least stride ≥ nbytes that is ≡ rem (mod 128) (pad_to in the
    source)."""
    return (nbytes + 127 - rem) // 128 * 128 + rem


class _K3DecRule(NamedTuple):
    """Where K3 takes the decode-occupancy kernel (mode 4) and its launch,
    read off (E, C, c, b, idx_bits) only: bf16 2:4 at every C; clusters
    of the least CS ∈ {1, 2, 4} (each CTA keeping ≥ one stage) whose
    128-row tiles × CS reach ``tiles``, else the largest (the kernel splits
    K over a cluster only where the active items × CS fit its grid at
    once); a ring of ``nst`` stages in a cluster's CTAs (CS > 1) or
    ``nst1`` in an unclustered one, cut to a CTA's share of the K range at
    that split (at least 2), and cut further where it would not fit beside
    the list of row groups.  The grid is every CTA that is co-resident, so
    a shallower ring can put two CTAs on an SM."""
    tiles: int
    nst: int
    nst1: int


# fitted by tools/k3_plan_sweep.py to its digest tools/k3_plan_sweep.json
_K3_DEC_RULE = _K3DecRule(tiles=12, nst=6, nst1=4)
# K3's decode kernel, as in the source: tiles of K3D_BM output rows, a ring
# of K3D_MAXST stages at most; its cluster sizes
_K3D_BM, _K3D_MAXST = 128, 16
_K3D_SPLITS = (1, 2, 4)


def _k3_dec_stage(bits: int) -> int:
    """Bytes of a stage of K3's decode ring: K2's decode stage at 128 rows
    and N = 8."""
    return _k2_dec_stage(_K3D_BM, _MAXB, bits)


def _k3_dec_smem(nst: int, CS: int, EG: int, bits: int) -> int:
    """Dynamic shared memory of K3's decode path (k3d_smem in the source):
    1 024 bytes of alignment, the ring, a split's receive buffer (K3D_BM ·
    8 fp32) and the list of the E · ⌈C/8⌉ row groups, 2 bytes each, in
    whole 16 bytes."""
    return (1024 + nst * _k3_dec_stage(bits)
            + (_K3D_BM * _MAXB * 4 if CS > 1 else 0) + -(-2 * EG // 16) * 16)


def _k3_dec_fits(nst: int, CS: int, EG: int, bits: int) -> bool:
    """Whether a decode plan's shared memory fits in 227 KB beside the
    mbarriers (2 · K3D_MAXST + 1 of 8 bytes) and 64 bytes of static data."""
    return (_k3_dec_smem(nst, CS, EG, bits) + 8 * (2 * _K3D_MAXST + 1) + 64
            <= _SMEM_LIMIT)


def _k3_dec_plan(E: int, C: int, c: int, b: int, bits: int,
                 rule: "_K3DecRule | None" = None
                 ) -> "tuple[int, int, int]":
    """K3's decode plan (mode 4) → (4, CS, nst) by ``rule``
    (``_K3_DEC_RULE``)."""
    rule = _K3_DEC_RULE if rule is None else rule
    nks = -(-b // (32 * _DEC_KS))
    tiles = -(-c // _K3D_BM)
    CS = 1
    for cs in _K3D_SPLITS:
        if nks < cs:
            break
        CS = cs
        if tiles * cs >= rule.tiles:
            break
    nst = max(2, min(rule.nst if CS > 1 else rule.nst1, -(-nks // CS)))
    EG = E * -(-C // _MAXB)
    while nst > 2 and not _k3_dec_fits(nst, CS, EG, bits):
        nst -= 1
    return 4, CS, nst


def _k3_dec_ok(L: int, idx_stride: int, b: int, esize: int, aligned: bool,
               n: int, m: int, E: int, C: int) -> bool:
    """Whether K3's decode kernel takes the layout: bf16 2:4, b % 32 == 0,
    index rows of exactly L·idx_bits/8 bytes and whole 16-byte rows (its
    tensor map), 16-byte aligned x, values and indices (``aligned``), E ·
    ⌈C/8⌉ < 65 536 row groups whose list fits beside a 2-stage ring."""
    bits = 8 * idx_stride // L if L else 0
    EG = E * -(-C // _MAXB)
    return (aligned and esize == 2 and (n, m) == (2, 4) and 2 * L == b
            and b % 32 == 0 and bits in (4, 8)
            and idx_stride * 8 == L * bits and idx_stride % 16 == 0
            and 0 < EG < 65536 and _k3_dec_fits(2, 4, EG, bits))


@functools.lru_cache(maxsize=None)
def _k3_plan(L: int, idx_stride: int, b: int, esize: int, aligned: bool,
             n: int = 2, m: int = 4, E: int = 0, C: int = 0, c: int = 0,
             x_aligned: bool = True) -> tuple:
    """K3's launch plan → (mode, G lanes a row, SR rows a ring stage,
    dynamic shared-memory bytes) as the source lays them out, or mode 4's
    (4, CS, nst).

    mode 4, the decode-occupancy path: where ``_k3_dec_ok`` takes the
    layout (x also aligned, ``x_aligned``), at every C —
    tools/k3_plan_sweep.py timed it no slower than mode 2 at every
    occupancy it ran, decode and prefill (C = 8 … 640); plan from
    ``_k3_dec_plan``.  Without (E, C, c) no decode plan is made.
    mode 2, the tensor-core path: bf16 2:4 with 16-byte rows of values and
    indices (and aligned bases, ``aligned``) and b % 32 == 0; 16 output rows
    a stage where they fit in ``_K3_TC_STAGE_BYTES``, else 8, x rows
    padded in shared memory.  mode 1, the ring on the CUDA cores (any n:m and
    dtype with 16-byte rows): G = 32 when a row's 8-value chunks fill whole
    warp steps (or are many), else 16, so the down leaf's 48 chunks fill
    half-warps; a stage holds the fewest multiple of the block's
    rows-at-once that reaches ``_K3_STAGE_BYTES``.  mode 0, the scalar path
    (G = 32), when rows are not 16-byte aligned or a ring would not fit in
    227 KB.  The 64 bytes added to each check are the mbarriers' static
    shared memory.
    """
    if (E and C and c
            and _k3_dec_ok(L, idx_stride, b, esize, aligned and x_aligned,
                           n, m, E, C)):
        return _k3_dec_plan(E, C, c, b, 8 * idx_stride // L)
    xs = _MAXB * -(-b // 8) * 8 * esize
    row = L * esize + idx_stride
    ring_ok = aligned and L % 8 == 0 and (L * esize) % 16 == 0 and \
        idx_stride % 16 == 0
    if ring_ok and esize == 2 and (n, m) == (2, 4) and b % 32 == 0:
        SR = 16 if 16 * row <= _K3_TC_STAGE_BYTES else 8
        smem = (_K3_NST * SR * row + _MAXB * _pad_to(2 * b, 16)
                + 2 * 8 * SR * 8 * 4)
        if smem + 64 <= _SMEM_LIMIT:
            return 2, 32, SR, smem
    if ring_ok:
        chunks = L // 8
        G = 32 if chunks % 32 == 0 or chunks > 48 else 16
        ng = _K3_THREADS // G
        SR = min(ng * max(1, _K3_STAGE_BYTES // (ng * row)), _K3_BLOCK_ROWS)
        smem = xs + _K3_NST * SR * row
        if smem + 64 <= _SMEM_LIMIT:
            return 1, G, SR, smem
    return 0, 32, 0, xs


def active_row_groups(x: Tensor) -> Tensor:
    """(E, ⌈C/8⌉) bool: the groups of 8 capacity rows of x (E, C, b) that
    hold a value ≠ 0 — the row groups whose weights K3 streams."""
    E, C, b = x.shape
    pad = -(-C // _MAXB) * _MAXB - C
    nz = (x != 0).any(dim=-1)                                 # (E, C)
    nz = torch.nn.functional.pad(nz, (0, pad))
    return nz.reshape(E, -1, _MAXB).any(dim=-1)


def stacked_stream_bytes(x: Tensor, values: Tensor, indices: Tensor) -> int:
    """Bytes K3 moves for this x: the values and indices of expert e once
    for every active row group of e (``active_row_groups``), all of x (a
    block reads its rows to decide) and all of y (written, zeros where
    skipped).  y has x's dtype and shape (E, C, c)."""
    E, C, _ = x.shape
    c = values.shape[1]
    per_expert = (values[0].numel() * values.element_size()
                  + indices[0].numel() * indices.element_size())
    groups = int(active_row_groups(x).sum())
    return (groups * per_expert + x.numel() * x.element_size()
            + E * C * c * x.element_size())


def _k3_operands(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
                 b: int, idx_bits: int):
    """K3's checked, contiguous operands and their launch plan →
    (x, values, indices, plan)."""
    if values.dim() != 3:
        raise ValueError(f"K3 takes stacked (E, c, L) values, got "
                         f"{tuple(values.shape)}")
    L = _check_layout(x, values, indices, n, m, b, idx_bits)
    _check_operands(x, values, indices, "K3")
    x = x.contiguous()
    values = values.contiguous()
    indices = indices.contiguous().view(torch.uint8)
    E, C, c = x.shape[0], x.shape[1], values.shape[1]
    plan = _k3_plan(L, indices.shape[2], b, x.element_size(),
                    all(t.data_ptr() % 16 == 0 for t in (values, indices)),
                    n, m, E, C, c, x.data_ptr() % 16 == 0)
    if plan[0] != 4 and plan[3] + 64 > _SMEM_LIMIT:
        raise ValueError(f"K3 stages x in shared memory: b={b} in {x.dtype} "
                         f"needs {plan[3]} bytes > {_SMEM_LIMIT - 64}")
    return x, values, indices, plan


def _launch_k3(x: Tensor, values: Tensor, indices: Tensor, n: int, m: int,
               b: int, idx_bits: int, plan) -> Tensor:
    """One K3 launch under ``plan`` (checked operands, contiguous) → y.  A
    decode plan (mode 4) takes E · ⌈C/8⌉ bytes of scratch for its vote."""
    E, C, _ = x.shape
    c, L = values.shape[1], values.shape[2]
    y = torch.empty((E, C, c), dtype=x.dtype, device=x.device)
    if E == 0 or C == 0 or c == 0:
        return y
    if plan[0] == 4:
        _, CS, nst = plan
        flags = torch.empty((E * -(-C // _MAXB),), dtype=torch.uint8,
                            device=x.device)
        G = SR = 0
        fp = flags.data_ptr()
    else:
        _, G, SR, _ = plan
        CS = nst = fp = 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _fn("nm_matmul_stacked")(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), y.data_ptr(),
        fp, _DTYPES[x.dtype], idx_bits, plan[0], E, C, c, b, m, m - n, L,
        indices.shape[2], G, SR, CS, nst, stream)
    _build.check(status, "nm_matmul_stacked")
    return y


def nm_matmul_stacked_cuda(x: Tensor, values: Tensor, indices: Tensor, *,
                           n: int, m: int, b: int,
                           idx_bits: int = 8) -> Tensor:
    """Launch K3 on the current stream, one product launch for the whole
    stack (its decode plan adds the vote): x (E, C, b) → y (E, C, c) in x's
    dtype."""
    x, values, indices, plan = _k3_operands(x, values, indices, n, m, b,
                                            idx_bits)
    y = _launch_k3(x, values, indices, n, m, b, idx_bits, plan)
    if y.numel() == 0:
        return y
    E, C, c = y.shape
    key = (E, C, c, b, str(x.dtype), idx_bits)
    nm_matmul_stacked_cuda.launches += 1
    nm_matmul_stacked_cuda.by_shape[key] += 1
    if plan[0] == 4:
        nm_stacked_sp_dec.launches += 1
        nm_stacked_sp_dec.by_shape[key] += 1
    return y


nm_matmul_stacked_cuda.launches = 0
nm_matmul_stacked_cuda.by_shape = collections.Counter()
# the K3 launches that ran the decode-occupancy kernel (plan mode 4), a
# subset of nm_matmul_stacked_cuda's
nm_stacked_sp_dec = KernelCount("nm_stacked_sp_dec_kernel")
