"""K2, the n:m compressed matmul, in its served format (bf16 2:4): the
launch plan ``nm_spmm._k2_plan`` on the CPU — below ``_ROWS_MIN_B``
activation rows the decode path (mode 4) where the measured rule takes it
and the 8-row tensor-core path (mode 2) elsewhere, the many-row path
(mode 3) from there on; the plain version and the port's ``ops.nm_matmul``
against the JAX package's Pallas kernel (interpret mode, through
``ops.nm_matmul``'s padding) at the batch sizes and ragged widths the
card's tests use, many rows included; and, on a card only, the 8-row
tensor-core kernel against its plain version (the many-row and decode
kernels' card tests are ``tests/test_torch_k2_rows_cuda.py`` and
``tests/test_torch_k2_dec_cuda.py``).

Tolerances: bf16 rtol 2e-2 / atol 1e-2 (the plain version multiplies in
bf16, the Pallas body and the CUDA kernel sum in fp32), as
``tests/test_torch_kernels.py`` holds K2; a NaN weight gives NaN in every
output it feeds, on every side.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.masks import nm_mask as j_nm_mask  # noqa: E402
from repro.core.sparsity import pack_nm as j_pack_nm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels import nm_spmm as K2  # noqa: E402
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402

# (c, b) of every K2 launch on the two paths: tinyllama-1.1b (q/o, k/v,
# gate/up, down) and qwen3-moe-30b-a3b's attention (q, k/v, o)
PATH_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
               (4096, 2048), (512, 2048), (2048, 4096)]
SMS = 132                  # an H100's SMs
SMEM = 227 * 1024          # shared memory a block may use
BATCHES = [1, 2, 3, 4, 5, 8, 9, 17]
BF16 = {"rtol": 2e-2, "atol": 1e-2}
# (c, b) of every K2 row of PERF.md's kernel table: the paths' shapes
# (tinyllama and qwen3-moe above; deepseek-v3, gemma3, zamba2, xlstm,
# whisper, danube, mistral, internvl)
TABLE_SHAPES = PATH_SHAPES + [
    (1536, 7168), (24576, 1536), (576, 7168), (7168, 16384), (18432, 7168),
    (7168, 18432), (1024, 1152), (256, 1152), (6912, 1152), (1152, 1024),
    (1152, 6912), (14704, 3584), (3584, 7168), (3584, 3584), (14336, 3584),
    (3584, 14336), (8192, 2048), (4096, 4096), (4, 4096), (2048, 4096),
    (2048, 2048), (1024, 1024), (4096, 1024), (1024, 4096), (2560, 2560),
    (640, 2560), (6912, 2560), (2560, 6912), (12288, 12288), (1024, 12288),
    (28672, 12288), (12288, 28672), (8192, 8192), (1024, 8192),
    (28672, 8192), (8192, 28672)]
# the perf ladders' nm rungs at B = 128 (mistral-large-123b, xlstm-1.3b) and
# whisper-medium's encoder at B = 4 × 1500 frames
LADDER_SHAPES = [(12288, 12288), (1024, 12288), (28672, 12288),
                 (12288, 28672), (8192, 2048), (4096, 4096), (4, 4096),
                 (2048, 4096), (2048, 2048)]
WHISPER_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096)]
# the decode sweep's digest (tools/k2_plan_sweep.py --part decode on an
# H100, 4-bit indices) and the fit of the plan's decode rule to it
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import k2_dec_rule  # noqa: E402

SWEEP = k2_dec_rule.load()
MEASURED = {(r["c"], r["b"], r["B"]): r for r in SWEEP["rows"]}


def _plan(c, b, B, idx_bits=4, esize=2, aligned=True, nm=(2, 4),
          x_aligned=True):
    nn, m = nm
    L = (b // m) * (m - nn)
    stride = (L + 1) // 2 if idx_bits == 4 else L
    return K2._k2_plan(c, b, L, stride, B, esize, aligned, nn, m, x_aligned)


def _wide(c, b, B, bits=4):
    """Whether the 8-row plan (what an unaligned x takes) splits the rows
    over a cluster or cannot hold them."""
    tc8 = _plan(c, b, B, bits, x_aligned=False)
    return tc8[0] != 2 or tc8[1] > 1


def _assert_measured(c, b, B, plan, bits=4):
    """Where the decode sweep timed (c, b, B) at ``bits``-bit indices: a
    decode plan only if it ran there in at most k2_dec_rule.MARGIN of the
    time of the mode it replaces (the 8-row plan; the many-row plan on
    rows too wide for one 8-row block).  The sweep timed 4-bit indices
    only (the served format)."""
    row = MEASURED.get((c, b, B))
    if row is None or plan[0] != 4 or bits != SWEEP["bits"]:
        return
    t4 = k2_dec_rule.plan_time(row, K2._k2_dec_plan(c, b, B, 4))
    before = row["mode3"] if _wide(c, b, B) else row["mode2"]
    assert t4 <= k2_dec_rule.MARGIN * before, (plan, t4, before)


def _assert_tc(plan, B=1, c=2048, b=2048, bits=4, x_aligned=True):
    """A tensor-core path: the many-row one from _ROWS_MIN_B rows (x
    aligned, c ≥ _ROWS_MIN_C) and on rows too wide for one 8-row block
    past the decode rule's wide_max_b; below it the decode one (64-row
    tiles, N = 8·⌈B/8⌉), only where the sweep measured it faster, or the
    8-row one; a cluster split of 1–8 CTAs, in 227 KB."""
    mode, CS, smem, BM, BN = plan
    rows = x_aligned and c >= K2._ROWS_MIN_C
    if mode == 3:
        assert rows and (B >= K2._ROWS_MIN_B or (
            _wide(c, b, B, bits) and B > K2._DEC_RULE.wide_max_b)), plan
        assert BM in (128, 256) and BN in (64, 128), plan
        assert K2._k2_rows_nst(BM, BN, 4) >= 3
    elif mode == 4:
        assert rows and B < K2._ROWS_MIN_B, plan
        assert BM == 64 and BN == 8 * -(-B // 8), plan
        _assert_measured(c, b, B, plan, bits)
    else:
        assert mode == 2 and (BM, BN) == (8, 8), plan
        assert not rows or B < K2._ROWS_MIN_B, plan
    assert CS in (1, 2, 4, 8)
    assert 0 < smem and smem + 64 <= SMEM


def _plan_before(c, b, L, idx_stride, B, esize, aligned, n=2, m=4):
    """``_k2_plan`` as it was before the many-row path, verbatim: the plan
    B ≤ 4 must keep."""
    bits = 8 * idx_stride // L if L else 0
    if (aligned and esize == 2 and (n, m) == (2, 4) and 2 * L == b
            and b % 32 == 0 and bits in (4, 8)
            and idx_stride * 8 == L * bits):
        for CS in (1, 2, 4, 8):
            if b % (32 * CS) or idx_stride % CS or (idx_stride // CS) % 16:
                continue
            smem = K2._k2_smem(b, L, idx_stride, B, CS)
            if smem + 64 <= K2._SMEM_LIMIT:
                return 2, CS, smem
    return int(aligned and L % 8 == 0), 1, 0


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("c,b", PATH_SHAPES)
def test_k2_plan_path_shapes(c, b, B):
    """Every path launch (bf16 2:4, 4-bit indices) takes a tensor-core
    path within 227 KB of shared memory: the 8-row path unsplit, on a grid
    of 8-row blocks (≥ 132 of them from c = 1056 on; (256, 2048) and (512,
    2048) run 32 and 64 blocks — a cluster split measured slower there).
    The decode path takes none of them: at these widths it ran no faster
    than the 8-row path in the decode sweep ((2048, 5632) at B = 4: 1.01×
    its time; (5632, 2048) 1.17×)."""
    plan = _plan(c, b, B)
    _assert_tc(plan, B, c, b)
    assert plan[0] == 2 and plan[1] == 1
    assert K2._k2_ctas(c, B, plan) == -(-c // 8)
    if c >= 8 * SMS:
        assert K2._k2_ctas(c, B, plan) >= SMS


@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(2048, 2048, 8), (2048, 2048, 9),
                                   (256, 2048, 17), (2048, 5632, 17),
                                   (5632, 2048, 9), (37, 128, 3),
                                   (300, 256, 5), (300, 512, 1)])
def test_k2_plan_more_rows_and_ragged_c(c, b, B, idx_bits):
    """B > 8 and ragged c keep a tensor-core path: below _ROWS_MIN_B the
    8-row one (a grid dimension over row groups of 8) or, where the rule
    takes it, the decode one (64-row tiles, N ≥ B), the many-row one (BM ×
    BN blocks) from there on; the grid covers every row group."""
    plan = _plan(c, b, B, idx_bits)
    _assert_tc(plan, B, c, b, idx_bits)
    assert K2._k2_ctas(c, B, plan) == \
        -(-c // plan[3]) * plan[1] * -(-B // plan[4])


@pytest.mark.parametrize("c,b,B,CS", [(256, 16384, 1, 1), (256, 16384, 8, 2),
                                      (37, 16384, 17, 2), (64, 32768, 8, 4),
                                      (64, 65536, 8, 8)])
def test_k2_plan_splits_wide_rows(c, b, B, CS):
    """Rows too wide for one block's 227 KB (8 weight rows and min(B, 8)
    x rows) split over a cluster of the least CS that fits, on the 8-row
    path: x unaligned keeps it at every B."""
    plan = _plan(c, b, B, x_aligned=False)
    _assert_tc(plan, B, c, b, x_aligned=False)
    assert plan[1] == CS


@pytest.mark.parametrize("case", [
    dict(esize=4),                               # fp32
    dict(nm=(5, 8)),                             # another n:m
    dict(nm=(2, 8)),
    dict(aligned=False),                         # an unaligned base
    dict(b=1000),                                # b % 32 ≠ 0
    dict(b=100),                                 # odd L (50 kept values)
    dict(b=1 << 18, x_aligned=False),            # too wide even split 8 ways
])
def test_k2_plan_other_formats_take_the_old_kernel(case):
    """fp32, n:m other than 2:4, rows that are not 16-byte aligned and rows
    too wide for any split of the 8-row path (with an x the many-row path
    does not take) take the warp-per-row kernel: its vector path (mode 1)
    where L % 8 == 0 and the bases are aligned, else the scalar path
    (mode 0)."""
    b = case.pop("b", 2048)
    kw = dict(esize=2, aligned=True, nm=(2, 4)) | case
    nn, m = kw["nm"]
    L = (b // m) * (m - nn)
    mode, CS, smem, BM, BN = _plan(2048, b, 4, **kw)
    assert (CS, smem, BM, BN) == (1, 0, 8, 8)
    assert mode == int(kw["aligned"] and L % 8 == 0)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(c, b, 128) for c, b in LADDER_SHAPES]
                         + [(c, b, 6000) for c, b in WHISPER_SHAPES])
def test_k2_plan_many_rows_at_ladder_and_whisper_shapes(c, b, B, bits):
    """Every ladder shape at B = 128 and every whisper encoder shape at
    B = 6 000 takes the many-row path in 227 KB, each CTA with ≥ one
    32-column step of its K range — but xlstm's 4-row gate (c = 4 <
    _ROWS_MIN_C), which keeps the 8-row path."""
    plan = _plan(c, b, B, bits)
    _assert_tc(plan, B, c, b, bits)
    if c < K2._ROWS_MIN_C:
        assert plan[0] == 2
        return
    assert b // 32 >= plan[1]
    assert plan[2] == K2._k2_rows_smem(plan[3], plan[4], bits)


@pytest.mark.parametrize("c,b,B", [(c, b, 128) for c, b in LADDER_SHAPES
                                    if c >= 64]
                         + [(c, b, 6000) for c, b in WHISPER_SHAPES]
                         + [(1024, 12288, 64), (2048, 2048, 64),
                            (300, 1056, 129), (37 * 128, 512, 70),
                            (28672, 12288, 64), (8192, 28672, 4),
                            (7168, 16384, 4), (12288, 28672, 1)])
def test_k2_plan_many_rows_fill_the_card(c, b, B):
    """256-row blocks where they alone give each of the 132 SMs 4 CTAs;
    else 128-row blocks and the least split that reaches 96 CTAs for a
    weight streamed from HBM, 64 for one that stays in L2 — 128 where its
    unsplit grid has ≥ 32 blocks, 64 activation rows a block tried before
    each larger split; where no split reaches it, the most CTAs any of
    them gives.  (The many-row plan itself: below 64 rows the wide rows
    here take the decode path, and the many-row plan only where their
    index rows are not 16-byte rows.)"""
    plan = K2._k2_rows_plan(c, b, B, 4)
    ctas = K2._k2_ctas(c, B, plan)
    BN = 64 if B <= 64 else 128
    if -(-c // 256) * -(-B // BN) >= 4 * SMS:
        assert plan[1:] == (1, K2._k2_rows_smem(256, BN, 4), 256, BN)
        return
    assert plan[3] == 128
    in_l2 = c * b * 20 // 16 <= 32 * 2**20
    full = in_l2 and -(-c // 128) * -(-B // BN) >= 32
    target = (128 if full else 64) if in_l2 else 96
    cands = [(CS, bn, -(-c // 128) * -(-B // bn) * CS)
             for CS in (1, 2, 4, 8) if b // 32 >= CS
             for bn in ((BN, 64) if full and BN == 128 else (BN,))]
    if max(n for _, _, n in cands) < target:
        assert ctas == max(n for _, _, n in cands), (plan, ctas)
        return
    assert ctas >= target
    assert all(n < target for CS, _, n in cands if CS < plan[1]), plan
    if not full:
        assert plan[4] == BN


@pytest.mark.parametrize("B", [K2._ROWS_MIN_B, 129, 6000])
@pytest.mark.parametrize("case", [
    dict(x_aligned=False),                       # x one element off
    dict(aligned=False),                         # values / indices
    dict(esize=4),                               # fp32
    dict(nm=(5, 8)),
    dict(nm=(2, 8)),
    dict(b=1000),                                # b % 32 ≠ 0
    dict(b=100),
    dict(c=K2._ROWS_MIN_C - 1),                  # a few output rows
])
def test_k2_plan_many_rows_other_formats_never(case, B):
    """A misaligned x or weight base, fp32, n:m other than 2:4,
    b % 32 ≠ 0 and c < _ROWS_MIN_C never take the many-row path, at any B:
    a misaligned x and a small c keep the 8-row tensor-core path, the rest
    the warp-per-row kernel."""
    kw = dict(case)
    b = kw.pop("b", 2048)
    c = kw.pop("c", 2048)
    plan = _plan(c, b, B, **kw)
    assert plan[0] != 3
    if "x_aligned" in case or "c" in case:
        assert plan[0] == 2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("c,b", TABLE_SHAPES)
def test_k2_plan_unchanged_at_small_batch(c, b, B, bits):
    """For B ∈ {1, 4} (prefill and decode on every serving path), at every
    (c, b) of PERF.md's kernel table, the plan is the measured rule's: the
    decode plan (``_k2_dec_plan``) on rows too wide for one 8-row block
    (which the 8-row plan split over a cluster: they ran the many-row path
    before) and where the decode sweep measured it ≥ 5 % faster than the
    8-row plan (_assert_measured: the sweep timed 4-bit indices);
    elsewhere exactly the 8-row plan from before the many-row path
    (BM = BN = 8)."""
    L = b // 2
    stride = L // 2 if bits == 4 else L
    plan = K2._k2_plan(c, b, L, stride, B, 2, True, 2, 4)
    before = _plan_before(c, b, L, stride, B, 2, True)
    wide = before[0] != 2 or before[1] > 1
    if plan[0] == 4:
        assert plan == K2._k2_dec_plan(c, b, B, bits)
        _assert_measured(c, b, B, plan, bits)
        return
    assert not wide or c < K2._ROWS_MIN_C, plan
    assert plan[:3] == before
    assert plan[3:] == (8, 8)


@pytest.mark.parametrize("c,b,B", [(7168, 16384, 4), (7168, 18432, 4),
                                   (12288, 28672, 1), (8192, 28672, 4),
                                   (3584, 14336, 4), (2048, 1 << 18, 4)])
def test_k2_plan_wide_rows_leave_the_8_row_path(c, b, B):
    """Rows the 8-row path would split over a cluster (or cannot hold in
    227 KB at all) leave it at every B when x is aligned and c ≥
    _ROWS_MIN_C: for the decode path up to B = 8 (_DEC_RULE.wide_max_b:
    at every such row of the decode sweep ≥ 5 % faster than the many-row
    path there), for the many-row path past it and where the index rows
    are not 16-byte rows (b = 1 056 · k + 32: mode 2 cannot take them
    either); an unaligned x keeps the 8-row split."""
    plan = _plan(c, b, B)
    assert plan == K2._k2_dec_plan(c, b, B, 4), plan
    _assert_measured(c, b, B, plan)
    past = _plan(c, b, K2._DEC_RULE.wide_max_b + 1)
    assert past == K2._k2_rows_plan(c, b, K2._DEC_RULE.wide_max_b + 1, 4)
    tc8 = _plan(c, b, B, x_aligned=False)
    assert tc8[0] in (1, 2) and (tc8[0] == 1 or tc8[1] > 1)
    b2 = b + 32                      # 4-bit index rows of b/4 ≡ 8 (mod 16)
    rows = _plan(c, b2, B)
    assert rows[0] == 3 and rows[3] == 128, rows


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 4, 8, 63])
@pytest.mark.parametrize("c,b", TABLE_SHAPES)
def test_k2_dec_plan_table(c, b, B, bits):
    """At every (c, b) of PERF.md's kernel table and B ∈ {1, 4, 8, 63}:
    the mode the measured rule gives — mode 4 only where the decode sweep
    timed it ≥ 5 % faster than the mode it replaces (_assert_tc) —; a
    decode plan of 64-row tiles and N = 8·⌈B/8⌉ whose ring of ≤ 4 stages
    (and a split's receive buffer) fits in 227 KB, whose split is the
    least that lands 132 CTAs (66 past 32 rows) — or the most, each CTA
    keeping a stage."""
    plan = _plan(c, b, B, bits)
    _assert_tc(plan, B, c, b, bits)
    if plan[0] != 4:
        return
    assert plan == K2._k2_dec_plan(c, b, B, bits)
    mode, CS, smem, BM, N = plan
    assert smem + 8 * (2 * K2._DEC_MAXST + 1) <= SMEM
    nst = K2._k2_dec_nst(smem, BM, N, bits, CS)
    assert 2 <= nst <= 4 and smem == K2._k2_dec_smem(BM, N, bits, nst, CS)
    ctas = K2._k2_ctas(c, B, plan)
    target = 132 if B <= 32 else 66
    stages = -(-b // 128)
    assert CS <= stages
    if ctas < target:
        assert CS == min(8, max(cs for cs in (1, 2, 4, 8) if cs <= stages))
    else:
        assert CS == 1 or ctas // 2 < target


@pytest.mark.parametrize("B", [1, 4, 8, 63])
@pytest.mark.parametrize("case", [
    dict(x_aligned=False),                       # x one element off
    dict(aligned=False),                         # values / indices
    dict(esize=4),                               # fp32
    dict(nm=(5, 8)),
    dict(nm=(2, 8)),
    dict(b=1000),                                # b % 32 ≠ 0
    dict(b=28672 + 32),                          # 4-bit index rows ≢ 0 (16)
    dict(c=K2._ROWS_MIN_C - 1),                  # a few output rows
])
def test_k2_dec_plan_other_formats_never(case, B):
    """A misaligned x or weight base, fp32, n:m other than 2:4,
    b % 32 ≠ 0, index rows that are not 16-byte rows (the index bytes'
    tensor map needs them) and c < _ROWS_MIN_C never take the decode path,
    on a row it would take otherwise (28 672 × 12 288 up to B = 8; past it,
    where rows that wide take the many-row path, 28 672 × 8 192)."""
    kw = dict(case)
    base = (28672, 12288) if B <= K2._DEC_RULE.wide_max_b else (28672, 8192)
    b = kw.pop("b", base[1])
    c = kw.pop("c", base[0])
    assert _plan(*base, B)[0] == 4
    assert _plan(c, b, B, **kw)[0] != 4


def test_k2_dec_constants_match_the_source():
    """The decode ring's constants and layout mirror csrc/nm_spmm.cu: the
    steps a stage, the stages at most, and a stage's bytes."""
    import re
    from pathlib import Path

    src = (Path(K2.__file__).parent / "csrc" / "nm_spmm.cu").read_text()
    assert int(re.search(r"constexpr int DEC_KS = (\d+);", src)[1]) == \
        K2._DEC_KS
    assert int(re.search(r"constexpr int DEC_MAXST = (\d+);", src)[1]) == \
        K2._DEC_MAXST
    assert "return DEC_KS / 2 * N * 128 + BM * DEC_KS * 32 +" in src
    assert K2._k2_dec_stage(64, 8, 4) == 2 * 8 * 128 + 64 * 128 + 64 * 32
    assert int(re.search(r"constexpr int DEC_BM = (\d+);", src)[1]) == \
        K2._DEC_BM


def test_k2_dec_rule_is_the_sweeps_fit():
    """The plan's decode rule (``_DEC_RULE``) is what tools/k2_dec_rule.py
    fits to the decode sweep's digest: for each batch class the thresholds
    that save the most time with every row taken ≥ 5 % faster there than
    the mode it replaces — so a retuned sweep that moves them fails here
    until the rule is restated."""
    assert k2_dec_rule.fit(SWEEP) == K2._DEC_RULE
    cases = k2_dec_rule.cases(SWEEP)
    assert {c["cls"] for c in cases} == {"one", "few", "many", "wide"}
    taken = [c for c in cases if k2_dec_rule.takes(c, K2._DEC_RULE)]
    assert taken and all(c["t4"] <= k2_dec_rule.MARGIN * c["before"]
                         for c in taken)


def _jax_packed(c, b, idx_bits, seed, nan_at=None):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(c, b)) / np.sqrt(b), jnp.bfloat16)
    xn = jnp.asarray(rng.uniform(0.5, 2.0, size=(b,)), jnp.float32)
    mask = j_nm_mask(w.astype(jnp.float32), xn, 2, 4)
    wm = jnp.where(mask > 0.5, 0, w)
    if nan_at is not None:
        r = nan_at
        col = int(np.flatnonzero(np.asarray(mask[r]) < 0.5)[0])  # kept
        wm = wm.at[r, col].set(jnp.nan)
    jp = j_pack_nm(wm, mask, 2, 4, idx_bits=idx_bits)
    return rng, jp, params_from_numpy(jax_tree_to_numpy({"p": jp}),
                                      device="cpu")["p"]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("c,b", [(37, 128), (300, 256)])
def test_k2_plain_vs_pallas_served_format(c, b, B):
    """The served format at every batch size of the card's tests and at
    ragged c: the port's K2 path on the CPU (the plain version) against
    the Pallas kernel in interpret mode."""
    rng, jp, tp = _jax_packed(c, b, 4, seed=c * 100 + B)
    x = jnp.asarray(rng.normal(size=(B, b)), jnp.bfloat16)
    y_t = K2.nm_matmul_plain(t(x), tp.values, tp.indices, 2, 4, b, 4)
    y_j = jops.nm_matmul(x, jp, impl="pallas")
    assert y_t.shape == (B, c) and y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32), **BF16)


@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("B", [64, 128, 129])
@pytest.mark.parametrize("c,b", [(37, 128), (300, 256)])
def test_k2_plain_vs_pallas_many_rows(c, b, B, idx_bits):
    """The many-row regime's yardstick: the plain version (what the card
    holds mode 3 against) against the Pallas kernel in interpret mode at
    B ∈ {64, 128, 129}, ragged c, 4- and 8-bit indices."""
    rng, jp, tp = _jax_packed(c, b, idx_bits, seed=c * 1000 + B + idx_bits)
    x = jnp.asarray(rng.normal(size=(B, b)), jnp.bfloat16)
    y_t = K2.nm_matmul_plain(t(x), tp.values, tp.indices, 2, 4, b, idx_bits)
    y_j = jops.nm_matmul(x, jp, impl="pallas")
    assert y_t.shape == (B, c) and y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32), **BF16)


@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("B", [3, 9, 33])
@pytest.mark.parametrize("c,b", [(37, 128), (100, 96), (300, 1056)])
def test_k2_ops_vs_pallas_decode_rows(c, b, B, idx_bits):
    """The port's ``ops.nm_matmul`` (what ``layers.dense`` calls; the plain
    version on the CPU) against JAX's ``ops.nm_matmul`` through its Pallas
    kernel in interpret mode, at ragged c and b (96 and 1 056 columns: 3
    and 33 steps of 32, a last ring stage of the decode path cut) and at
    decode batch sizes on either side of its N = 8 and 32 tiles."""
    from repro_torch.kernels import ops as tops

    rng, jp, tp = _jax_packed(c, b, idx_bits, seed=c * 10 + b + B + idx_bits)
    x = jnp.asarray(rng.normal(size=(B, b)), jnp.bfloat16)
    y_t = tops.nm_matmul(t(x), tp)
    y_j = jops.nm_matmul(x, jp, impl="pallas")
    assert y_t.shape == (B, c) and y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32), **BF16)


@pytest.mark.parametrize("idx_bits", [4, 8])
def test_k2_nan_weight_gives_nan(idx_bits):
    """A NaN among the kept weights of output row 5 gives NaN in column 5
    of y for every activation row, in the plain version and in the Pallas
    kernel alike; every other output stays finite."""
    rng, jp, tp = _jax_packed(37, 128, idx_bits, seed=7, nan_at=5)
    x = jnp.asarray(rng.normal(size=(3, 128)), jnp.bfloat16)
    y_t = n(K2.nm_matmul_plain(t(x), tp.values, tp.indices, 2, 4, 128,
                               idx_bits))
    y_j = np.asarray(jops.nm_matmul(x, jp, impl="pallas"), np.float32)
    for y in (y_t, y_j):
        assert np.isnan(y[:, 5]).all()
        assert np.isfinite(np.delete(y, 5, axis=1)).all()
    np.testing.assert_allclose(y_t, y_j, equal_nan=True, **BF16)


# ---------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_packed(dev, c, b, idx_bits, seed):
    from repro_torch.core.masks import nm_mask

    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((c, b), generator=g, device=dev) / b ** 0.5).to(
        torch.bfloat16)
    mask = nm_mask(w.float(), torch.ones(b, device=dev), 2, 4)
    return g, w, mask, tsp.pack_nm(w, mask, 2, 4, idx_bits=idx_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("c,b", [(2048, 2048), (256, 2048), (37, 128),
                                 (129, 256), (300, 512)])
def test_k2_tc_vs_plain_on_card(cuda, c, b, B, idx_bits):
    """The tensor-core paths (the plan checked: _assert_tc) against the
    plain version, and two launches bitwise the same."""
    g, _, _, pk = _card_packed(cuda, c, b, idx_bits, c + b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    _assert_tc(_plan(c, b, B, idx_bits), B, c, b, idx_bits)
    before = K2.nm_matmul_cuda.launches
    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                            idx_bits=idx_bits)
    y_2 = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                            idx_bits=idx_bits)
    assert K2.nm_matmul_cuda.launches == before + 2
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, idx_bits)
    assert y_k.shape == (B, c) and y_k.dtype == torch.bfloat16
    torch.testing.assert_close(y_k.float(), y_p.float(), **BF16)
    assert torch.equal(y_k, y_2)


@pytest.mark.cuda
@pytest.mark.parametrize("CS", [2, 4, 8])
@pytest.mark.parametrize("B", [1, 4, 9])
@pytest.mark.parametrize("c,b", [(256, 2048), (37, 1024), (300, 512)])
def test_k2_tc_cluster_split_on_card(cuda, c, b, B, CS):
    """The cluster split (c ≤ 512, CS CTAs summing through distributed
    shared memory in rank order) against the plain version, launched with
    an explicit plan, and two launches bitwise the same."""
    g, _, _, pk = _card_packed(cuda, c, b, 4, c * CS + b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    L, stride = pk.values.shape[1], pk.indices.shape[1]
    plan = (2, CS, K2._k2_smem(b, L, stride, B, CS), 8, 8)
    y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
    y_2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
    torch.testing.assert_close(y_k.float(), y_p.float(), **BF16)
    assert torch.equal(y_k, y_2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_k2_tc_wide_rows_split_on_card(cuda, B):
    """b = 16384 at B = 8 is planned on the 8-row path as a 2-CTA cluster
    (the rows do not fit one block; what an unaligned x takes), which the
    wrapper's own plan hands to the decode path: both against the plain
    version."""
    c, b = 64, 16384
    g, _, _, pk = _card_packed(cuda, c, b, 4, b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    tc8 = _plan(c, b, B, x_aligned=False)
    assert tc8[:2] == (2, 2 if B == 8 else 1)
    assert _plan(c, b, B)[0] == (4 if B == 8 else 2)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
    y_8 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, tc8)
    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                            idx_bits=4)
    torch.testing.assert_close(y_8.float(), y_p.float(), **BF16)
    torch.testing.assert_close(y_k.float(), y_p.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(2048, 2048, 4), (256, 2048, 1),
                                   (37, 128, 9)])
def test_k2_tc_nan_weight_on_card(cuda, c, b, B, idx_bits):
    """A NaN kept weight gives NaN in its output column (no skip), as in
    the plain version; the other outputs agree with it."""
    g, w, mask, _ = _card_packed(cuda, c, b, idx_bits, 3 * c + b)
    r = c // 2
    col = int((mask[r] < 0.5).nonzero()[0])
    w[r, col] = torch.nan
    pk = tsp.pack_nm(w, mask, 2, 4, idx_bits=idx_bits)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                            idx_bits=idx_bits)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, idx_bits)
    assert bool(torch.isnan(y_k[:, r]).all())
    torch.testing.assert_close(y_k.float(), y_p.float(), equal_nan=True,
                               **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["strided", "offset"])
@pytest.mark.parametrize("c,b,B", [(2048, 2048, 4), (256, 2048, 3),
                                   (300, 512, 9)])
def test_k2_tc_x_views_on_card(cuda, c, b, B, view):
    """x as a strided view (copied by the wrapper) or as a contiguous view
    at an offset of one element (not 16-byte aligned: the kernel stages it
    element by element)."""
    g, _, _, pk = _card_packed(cuda, c, b, 4, c * b + B)
    if view == "strided":
        x = torch.randn((B, b + 8), generator=g, device=cuda).to(
            torch.bfloat16)[:, 3:3 + b]
    else:
        x = torch.randn((B * b + 1,), generator=g, device=cuda).to(
            torch.bfloat16)[1:].view(B, b)
        assert x.data_ptr() % 16 != 0
    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                            idx_bits=4)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
    torch.testing.assert_close(y_k.float(), y_p.float(), **BF16)
