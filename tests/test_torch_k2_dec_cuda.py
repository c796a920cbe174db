"""K2's decode path on a card: plan mode 4, ``nm_sp_dec_kernel`` (bf16 2:4
on the sparse tensor cores, B < ``_ROWS_MIN_B`` activation rows), marked
``cuda`` (skips without one; this file imports no JAX, so it runs where JAX
is absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_k2_dec_cuda.py

Ragged shapes run the decode plan ``_k2_dec_plan`` directly (the wrapper
takes the 8-row kernel there: the plan's measured rule keeps mode 4 for
rows where it is faster); the wrapper's counted launches run at rows the
rule sends to mode 4 (too wide for one 8-row block, up to B = 8; a
(3 584, 3 584) weight at B = 4, whose 8-row grid takes two waves), their
plan checked first.  Every case holds the kernel against the plain
version at bf16 rtol 2e-2 / atol 1e-2 (the plain version multiplies in
bf16, the kernel sums in fp32) and against the fp32 product of the same
operands: its max relative error at most the dense bf16 product's plus
2⁻⁸ (one bf16 step), as chip_smoke holds each K2 product of a model
step.  The metadata is built in the kernel from the stored positions, so
a wrong layout shows only where every 2:4 position pair sits in every
slot of a metadata word: one case builds exactly that, at N = 8 and 64.
"""
from __future__ import annotations

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.masks import nm_mask  # noqa: E402
from repro_torch.core.sparsity import pack_nm  # noqa: E402
from repro_torch.kernels import nm_spmm as K2  # noqa: E402
from repro_torch.kernels.ref import nm_expand  # noqa: E402

BF16 = {"rtol": 2e-2, "atol": 1e-2}
PAIRS = list(itertools.combinations(range(4), 2))   # the six 2:4 pairs
# (c, b) ragged against the tiles (BM = 64) and the ring's stages of
# four 32-column steps (b = 1 088, 192 and 576: 34, 6 and 18 steps, a last
# stage cut; b a multiple of 64, so that 4-bit index rows are whole 16-byte
# rows, as the index bytes' tensor map needs)
RAGGED = [(200, 1088), (100, 192), (1000, 576)]
# ragged c and b (898 steps: 225 stages, the last one cut) on rows too wide
# for one 8-row block: the wrapper's plan is mode 4 up to B = 8
# (_DEC_RULE.wide_max_b), the many-row mode 3 above
WIDE = (300, 28736)
BATCHES = [1, 2, 3, 4, 5, 8, 9, 17, 31, 33, 63]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _packed(dev, c, b, bits, seed, nan_row=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((c, b), generator=g, device=dev) / b ** 0.5).to(
        torch.bfloat16)
    mask = nm_mask(w.float(), torch.ones(b, device=dev), 2, 4)
    if nan_row is not None:
        w[nan_row, int((mask[nan_row] < 0.5).nonzero()[0])] = torch.nan
    return g, pack_nm(w, mask, 2, 4, idx_bits=bits)


def _x(g, dev, B, b):
    return torch.randn((B, b), generator=g, device=dev).to(torch.bfloat16)


def _launch(x, pk, b, bits, mode=4):
    """One counted launch, its plan checked to be ``mode``."""
    plan = K2._k2_operands(x, pk.values, pk.indices, 2, 4, b, bits)[3]
    assert plan[0] == mode, plan
    n, dec = K2.nm_matmul_cuda.launches, K2.nm_sp_dec.launches
    y = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                          idx_bits=bits)
    torch.cuda.synchronize()
    assert K2.nm_matmul_cuda.launches == n + 1
    assert K2.nm_sp_dec.launches == dec + (mode == 4)
    return y, plan


def _direct(x, pk, b, bits, plan=None):
    """One uncounted launch of the decode plan (``_k2_dec_plan`` unless
    given)."""
    c = pk.values.shape[0]
    plan = plan or K2._k2_dec_plan(c, b, x.shape[0], bits)
    y = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
    torch.cuda.synchronize()
    return y


def _check(y, x, pk, b, bits, equal_nan=False):
    """y against the plain version and against the fp32 product."""
    c = pk.values.shape[0]
    assert y.shape == (x.shape[0], c) and y.dtype == torch.bfloat16
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, bits)
    torch.testing.assert_close(y.float(), y_p.float(), equal_nan=equal_nan,
                               **BF16)
    if equal_nan:
        return
    w = nm_expand(pk.values, pk.indices, 2, 4, b, bits)
    y32 = x.float() @ w.float().T
    scale = float(y32.abs().max())
    rel = float((y.float() - y32).abs().max()) / scale
    dense = float(((x @ w.T).float() - y32).abs().max()) / scale
    assert rel <= dense + 2 ** -8, (rel, dense)


def _plans(c, b, B, bits):
    """Every decode split and depth the kernel takes at (c, b, B): CS ∈
    {1, 2, 4, 8} with ≥ one stage a CTA, rings of 2, 3 and the deepest that
    fits, on its 64-row tiles."""
    N, BM = 8 * -(-B // 8), K2._DEC_BM
    nks = -(-b // (32 * K2._DEC_KS))
    return [(4, CS, K2._k2_dec_smem(BM, N, bits, d, CS), BM, N)
            for CS in K2._DEC_SPLITS if nks >= CS
            for d in sorted({2, 3, K2._k2_dec_nst_max(BM, N, bits, CS)})]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("c,b", RAGGED)
def test_dec_vs_plain(cuda, c, b, B, bits):
    """The decode plan at ragged c, b and every B below the many-row
    threshold, against the plain version and the fp32 product."""
    g, pk = _packed(cuda, c, b, bits, c + b + B + bits)
    x = _x(g, cuda, B, b)
    _check(_direct(x, pk, b, bits), x, pk, b, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", BATCHES)
def test_dec_through_the_wrapper(cuda, B, bits):
    """The wrapper's own plan on ragged rows too wide for one 8-row block:
    mode 4 up to B = 8, counted on nm_sp_dec (the many-row mode 3 above,
    not counted there), against the plain version and the fp32 product."""
    c, b = WIDE
    g, pk = _packed(cuda, c, b, bits, b + B + bits)
    x = _x(g, cuda, B, b)
    y, _ = _launch(x, pk, b, bits,
                   mode=4 if B <= K2._DEC_RULE.wide_max_b else 3)
    _check(y, x, pk, b, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [1, 4, 9, 33, 63])
def test_dec_every_tile_split_and_depth(cuda, B, bits):
    """Every cluster split and ring depth under an explicit plan
    (uncounted) at a ragged shape (34 column steps: 9 stages over CS CTAs,
    the last one cut), two launches bitwise equal."""
    c, b = 300, 1088
    g, pk = _packed(cuda, c, b, bits, B + bits)
    x = _x(g, cuda, B, b)
    for plan in _plans(c, b, B, bits):
        y = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
        y2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
        torch.cuda.synchronize()
        _check(y, x, pk, b, bits)
        assert torch.equal(y, y2), plan


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 63])
@pytest.mark.parametrize("bits", [4, 8])
def test_dec_every_position_pair_in_every_slot(cuda, bits, B):
    """Row r's group j keeps the pair PAIRS[(r // 16 + j // 8) % 6]: over
    96 rows and 192 columns every pair sits in every row of an m16 tile
    (the low and high halves of a metadata word, and both threads of a
    pair) and in every group slot of a 32-column step, at N = 8 and 64.
    Kept values are ±[0.5, 1.5], so one wrong position moves the output
    well past the tolerance."""
    c, b = 96, 192
    g = torch.Generator(device=cuda).manual_seed(bits * 1000 + B)
    mask = torch.ones((c, b))
    for r in range(c):
        for j in range(b // 4):
            for p in PAIRS[(r // 16 + j // 8) % 6]:
                mask[r, 4 * j + p] = 0.0
    mask = mask.to(cuda)
    mag = torch.rand((c, b), generator=g, device=cuda) + 0.5
    sign = torch.randint(0, 2, (c, b), generator=g, device=cuda) * 2 - 1
    w = (mag * sign * (mask < 0.5)).to(torch.bfloat16)
    pk = pack_nm(w, mask, 2, 4, idx_bits=bits)
    x = _x(g, cuda, B, b)
    _check(_direct(x, pk, b, bits), x, pk, b, bits)
    for plan in _plans(c, b, B, bits):
        y = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
        _check(y, x, pk, b, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(200, 1088, 1), (1000, 576, 4),
                                   (100, 192, 63), (*WIDE, 4)])
def test_dec_nan_weight_gives_nan(cuda, c, b, B, bits):
    """A NaN kept weight gives NaN in its output column for every
    activation row, as in the plain version; the rest agrees with it."""
    r = c // 2
    g, pk = _packed(cuda, c, b, bits, 7 * c + B, nan_row=r)
    x = _x(g, cuda, B, b)
    y = _direct(x, pk, b, bits)
    assert bool(torch.isnan(y[:, r]).all())
    assert bool(torch.isfinite(torch.cat([y[:, :r], y[:, r + 1:]], 1)).all())
    _check(y, x, pk, b, bits, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 4, 17])
def test_dec_x_views(cuda, B):
    """x as a strided view is copied by the wrapper into an aligned tensor
    (mode 4 up to B = 8, the many-row mode 3 above); x one element off
    16-byte alignment (a contiguous view at an offset, which
    ``.contiguous()`` keeps) takes the 8-row mode 2, split over a cluster.
    (At B = 1 the strided view is one row, contiguous already, and off
    alignment too.)"""
    c, b = 300, 28672
    g, pk = _packed(cuda, c, b, 4, B)
    strided = torch.randn((B, b + 8), generator=g, device=cuda).to(
        torch.bfloat16)[:, 3:3 + b]
    offset = torch.randn((B * b + 1,), generator=g, device=cuda).to(
        torch.bfloat16)[1:].view(B, b)
    assert offset.data_ptr() % 16 != 0
    y, _ = _launch(strided, pk, b, 4,
                   mode=4 if B <= K2._DEC_RULE.wide_max_b else 3)
    _check(y, strided, pk, b, 4)
    y, _ = _launch(offset, pk, b, 4, mode=2)
    _check(y, offset, pk, b, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,B", [(*WIDE, 1), (*WIDE, 8), (3584, 3584, 4),
                                   (7168, 16384, 4)])
def test_dec_replay_bitwise_the_direct_call(cuda, c, b, B):
    """Two launches, and a CUDA-graph replay of the launch, bitwise equal to
    the direct call (the cluster split sums in rank order, no atomics);
    the plan is printed by the assertion if it differs."""
    g, pk = _packed(cuda, c, b, 4, c * B)
    x = _x(g, cuda, B, b)
    y1, plan = _launch(x, pk, b, 4)
    y2, _ = _launch(x, pk, b, 4)
    assert torch.equal(y1, y2), plan
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                          idx_bits=4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                               idx_bits=4)
    yg.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg, y1), plan


@pytest.mark.cuda
def test_dec_refuses_a_plan_it_cannot_launch(cuda):
    """A decode plan whose shared memory holds no whole ring, whose N is
    not 8·⌈B/8⌉ or whose split leaves a CTA without a stage raises; it
    does not run another mode."""
    c, b, B = 200, 1088, 4
    g, pk = _packed(cuda, c, b, 4, 5)
    x = _x(g, cuda, B, b)
    good = (4, 1, K2._k2_dec_smem(64, 8, 4, 3, 1), 64, 8)
    assert torch.equal(_direct(x, pk, b, 4, good),
                       K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4,
                                     good))
    for bad in [(4, 1, good[2] + 16, 64, 8), (4, 1, good[2], 64, 16),
                (4, 1, K2._k2_dec_smem(64, 8, 4, 1, 1), 64, 8),
                (4, 16, good[2], 64, 8), (4, 1, good[2], 96, 8)]:
        with pytest.raises(RuntimeError):
            K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, bad)
