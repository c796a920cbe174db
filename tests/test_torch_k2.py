"""K2, the n:m compressed matmul, in its served format (bf16 2:4): the
launch plan ``nm_spmm._k2_plan`` on the CPU — the 8-row tensor-core path
(mode 2) below ``_ROWS_MIN_B`` activation rows, the many-row path (mode 3)
from there on, and today's plan unchanged at B ∈ {1, 4}; the plain version
against the JAX package's Pallas kernel (interpret mode, through
``ops.nm_matmul``'s padding) at the batch sizes and ragged widths the
card's tests use, many rows included; and, on a card only, the 8-row
tensor-core kernel against its plain version (the many-row kernel's card
tests are ``tests/test_torch_k2_rows_cuda.py``).

Tolerances: bf16 rtol 2e-2 / atol 1e-2 (the plain version multiplies in
bf16, the Pallas body and the CUDA kernel sum in fp32), as
``tests/test_torch_kernels.py`` holds K2; a NaN weight gives NaN in every
output it feeds, on every side.
"""
from __future__ import annotations

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


def _plan(c, b, B, idx_bits=4, esize=2, aligned=True, nm=(2, 4),
          x_aligned=True):
    nn, m = nm
    L = (b // m) * (m - nn)
    stride = (L + 1) // 2 if idx_bits == 4 else L
    return K2._k2_plan(c, b, L, stride, B, esize, aligned, nn, m, x_aligned)


def _assert_tc(plan, B=1, c=2048):
    """The 8-row tensor-core path below _ROWS_MIN_B rows (or _ROWS_MIN_C
    output rows), the many-row path from there on; a cluster split of 1–8
    CTAs, in 227 KB."""
    mode, CS, smem, BM, BN = plan
    if B >= K2._ROWS_MIN_B and c >= K2._ROWS_MIN_C:
        assert mode == 3 and BM in (128, 256) and BN in (64, 128), plan
        assert K2._k2_rows_nst(BM, BN, 4) >= 3
    else:
        assert mode == 2 and (BM, BN) == (8, 8), plan
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
    """Every path launch (bf16 2:4, 4-bit indices) takes the tensor-core
    path, unsplit, within 227 KB of shared memory, on a grid of 8-row
    blocks: ≥ 132 of them from c = 1056 on.  (256, 2048) and (512, 2048)
    run 32 and 64 blocks — a cluster split measured slower there
    (tools/k2_plan_sweep.py), as at every path shape."""
    plan = _plan(c, b, B)
    _assert_tc(plan)
    assert plan[1] == 1
    assert K2._k2_ctas(c, B, plan) == -(-c // 8)
    if c >= 8 * SMS:
        assert K2._k2_ctas(c, B, plan) >= SMS


@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(2048, 2048, 8), (2048, 2048, 9),
                                   (256, 2048, 17), (2048, 5632, 17),
                                   (5632, 2048, 9), (37, 128, 3),
                                   (300, 256, 5), (300, 512, 1)])
def test_k2_plan_more_rows_and_ragged_c(c, b, B, idx_bits):
    """B > 8 and ragged c keep a tensor-core path: the 8-row one (a grid
    dimension over row groups of 8) below _ROWS_MIN_B, the many-row one
    (BM × BN blocks) from there on; the grid covers every row group."""
    plan = _plan(c, b, B, idx_bits)
    _assert_tc(plan, B, c)
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
    _assert_tc(plan)
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
    _assert_tc(plan, B, c)
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
    them gives."""
    plan = _plan(c, b, B)
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
    """For B ∈ {1, 4} (prefill and decode on every serving path) the plan
    is exactly the one before the many-row path, at every path shape and
    every (c, b) of PERF.md's kernel table (BM = BN = 8) — but rows too wide
    for one 8-row block, which that plan split over a cluster: they take
    the many-row path, measured 1.4–2.1× faster (PERF.md §6, PR 27)."""
    L = b // 2
    stride = L // 2 if bits == 4 else L
    plan = K2._k2_plan(c, b, L, stride, B, 2, True, 2, 4)
    before = _plan_before(c, b, L, stride, B, 2, True)
    if before[0] == 2 and before[1] > 1:
        assert plan == K2._k2_rows_plan(c, b, B, bits) and plan[0] == 3
        return
    assert plan[:3] == before
    assert plan[3:] == (8, 8)


@pytest.mark.parametrize("c,b,B", [(7168, 16384, 4), (7168, 18432, 4),
                                   (12288, 28672, 1), (8192, 28672, 4),
                                   (3584, 14336, 4), (2048, 1 << 18, 4)])
def test_k2_plan_wide_rows_take_many_rows(c, b, B):
    """Rows the 8-row path would split over a cluster (or cannot hold in
    227 KB at all) take the many-row path at every B when x is aligned and
    c ≥ _ROWS_MIN_C; an unaligned x keeps the 8-row split."""
    plan = _plan(c, b, B)
    assert plan[0] == 3 and plan[3] == 128, plan
    tc8 = _plan(c, b, B, x_aligned=False)
    assert tc8[0] in (1, 2) and (tc8[0] == 1 or tc8[1] > 1)


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
    """The tensor-core paths (the plan checked: 8-row below _ROWS_MIN_B,
    many-row from there on) against the plain version, and two launches
    bitwise the same."""
    g, _, _, pk = _card_packed(cuda, c, b, idx_bits, c + b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    assert _plan(c, b, B, idx_bits)[0] == (3 if B >= K2._ROWS_MIN_B else 2)
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
    wrapper's own plan hands to the many-row path: both against the plain
    version."""
    c, b = 64, 16384
    g, _, _, pk = _card_packed(cuda, c, b, 4, b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    tc8 = _plan(c, b, B, x_aligned=False)
    assert tc8[:2] == (2, 2 if B == 8 else 1)
    assert _plan(c, b, B)[0] == (3 if B == 8 else 2)
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
