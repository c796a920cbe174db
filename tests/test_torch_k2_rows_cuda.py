"""K2's many-row path on a card: plan mode 3, ``nm_sp_rows_kernel`` (bf16
2:4 on the sparse tensor cores), marked ``cuda`` (skips without one; this
file imports no JAX, so it runs where JAX is absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_k2_rows_cuda.py

Every case checks its plan first (mode 3, or the 8-row mode 2 where the
many-row kernel must not run), then holds the kernel against the plain
version at bf16 rtol 2e-2 / atol 1e-2 (the plain version multiplies in
bf16, the kernel sums in fp32) and against the fp32 product of the same
operands: its max relative error at most the dense bf16 product's plus
2⁻⁸ (one bf16 step), as chip_smoke holds each K2 product of a model
step.  The metadata is built in the kernel from the stored positions, so
a wrong layout shows only where every 2:4 position pair sits in every
slot of a metadata word: one case builds exactly that.
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
T = K2._ROWS_MIN_B                       # the least B on the many-row path
PAIRS = list(itertools.combinations(range(4), 2))   # the six 2:4 pairs
# (c, b) ragged against the tiles (BM = 64/128) and the ring's stages of
# two 32-column steps (b = 96 and 1 056: 3 and 33 steps)
RAGGED = [(200, 1056), (100, 96), (1000, 512)]


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


def _launch(x, pk, b, bits, mode=3):
    """One counted launch, its plan checked to be ``mode``."""
    plan = K2._k2_operands(x, pk.values, pk.indices, 2, 4, b, bits)[3]
    assert plan[0] == mode, plan
    n, rows = K2.nm_matmul_cuda.launches, K2.nm_sp_rows.launches
    y = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                          idx_bits=bits)
    torch.cuda.synchronize()
    assert K2.nm_matmul_cuda.launches == n + 1
    assert K2.nm_sp_rows.launches == rows + (mode == 3)
    return y, plan


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


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B", [T, T + 1, 127, 129, 6000])
@pytest.mark.parametrize("c,b", RAGGED)
def test_rows_vs_plain(cuda, c, b, B, bits):
    """The wrapper's own plan at ragged c, b and B: mode 3, against the
    plain version and the fp32 product."""
    g, pk = _packed(cuda, c, b, bits, c + b + B + bits)
    x = _x(g, cuda, B, b)
    y, _ = _launch(x, pk, b, bits)
    _check(y, x, pk, b, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("BM,BN,CS,bits",
                         [(128, bn, cs, 4) for bn in (128, 64)
                          for cs in (1, 2, 4, 8)]
                         + [(128, 128, 2, 8), (128, 64, 4, 8),
                            (256, 128, 1, 4), (256, 64, 1, 4),
                            (256, 64, 1, 8)])
def test_rows_every_tile_and_split(cuda, BM, BN, CS, bits):
    """Every tile and cluster split under an explicit plan (uncounted) at a
    ragged shape (33 column steps over CS CTAs; 256-row blocks run unsplit
    and hold 3 stages but at 8-bit × 128 rows), two launches bitwise
    equal."""
    c, b, B = 300, 1056, 129
    g, pk = _packed(cuda, c, b, bits, BM + BN + CS)
    x = _x(g, cuda, B, b)
    plan = (3, CS, K2._k2_rows_smem(BM, BN, bits), BM, BN)
    y = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
    y2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits, plan)
    torch.cuda.synchronize()
    _check(y, x, pk, b, bits)
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(100, 16384, 4), (300, 28672, 1),
                                   (200, 14336, 4)])
def test_rows_wide_rows_at_small_batch(cuda, c, b, B, bits):
    """Rows too wide for one 8-row block (its plan would split them over a
    cluster) leave the 8-row path at decode and prefill batch too: for the
    decode path (mode 4) up to B = 8, measured faster there than the
    many-row path, whose own plan still runs them where asked."""
    g, pk = _packed(cuda, c, b, bits, c + B + bits)
    x = _x(g, cuda, B, b)
    y, _ = _launch(x, pk, b, bits, mode=4)
    _check(y, x, pk, b, bits)
    y = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, bits,
                      K2._k2_rows_plan(c, b, B, bits))
    torch.cuda.synchronize()
    _check(y, x, pk, b, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [T, 129])
@pytest.mark.parametrize("bits", [4, 8])
def test_rows_every_position_pair_in_every_slot(cuda, bits, B):
    """Row r's group j keeps the pair PAIRS[(r // 16 + j // 8) % 6]: over
    96 rows and 192 columns every pair sits in every row of an m16 tile
    (the low and high halves of a metadata word, and both threads of a
    pair) and in every group slot of a 32-column step.  Kept values are
    ±[0.5, 1.5], so one wrong position moves the output well past the
    tolerance."""
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
    y, _ = _launch(x, pk, b, bits)
    _check(y, x, pk, b, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("c,b,B", [(200, 1056, T), (1000, 512, 129),
                                   (100, 96, 6000)])
def test_rows_nan_weight_gives_nan(cuda, c, b, B, bits):
    """A NaN kept weight gives NaN in its output column for every
    activation row, as in the plain version; the rest agrees with it."""
    r = c // 2
    g, pk = _packed(cuda, c, b, bits, 7 * c + B, nan_row=r)
    x = _x(g, cuda, B, b)
    y, _ = _launch(x, pk, b, bits)
    assert bool(torch.isnan(y[:, r]).all())
    assert bool(torch.isfinite(torch.cat([y[:, :r], y[:, r + 1:]], 1)).all())
    _check(y, x, pk, b, bits, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [T, 129])
def test_rows_x_views(cuda, B):
    """x as a strided view is copied by the wrapper into an aligned tensor
    (mode 3); x one element off 16-byte alignment (a contiguous view at an
    offset, which ``.contiguous()`` keeps) takes the 8-row mode 2."""
    c, b = 300, 512
    g, pk = _packed(cuda, c, b, 4, B)
    strided = torch.randn((B, b + 8), generator=g, device=cuda).to(
        torch.bfloat16)[:, 3:3 + b]
    offset = torch.randn((B * b + 1,), generator=g, device=cuda).to(
        torch.bfloat16)[1:].view(B, b)
    assert offset.data_ptr() % 16 != 0
    y, _ = _launch(strided, pk, b, 4, mode=3)
    _check(y, strided, pk, b, 4)
    y, _ = _launch(offset, pk, b, 4, mode=2)
    _check(y, offset, pk, b, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,B", [(200, 1056, 129), (1000, 512, 6000),
                                   (300, 1056, T)])
def test_rows_replay_bitwise_the_direct_call(cuda, c, b, B):
    """Two launches, and a CUDA-graph replay of the launch, bitwise equal to
    the direct call (the cluster split sums in rank order, no atomics);
    the plan's split is printed by the assertion if it differs."""
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
