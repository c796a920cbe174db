"""K1 on a card: the wgmma kernel (``xtx_wg_kernel``) in every ring
configuration, tile edge and token split, against the plain version;
marked ``cuda`` (skips without one; this file imports no JAX, so it runs
where JAX is absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_k1_cuda.py

Tolerance as every K1 check: rtol 1e-3 / atol 2e-2 (fp32 sums of the same
exact bf16 products in another order).  Exact where the sums are: xtx
symmetric bitwise, count and skipped, two launches on the same inputs
bitwise equal, and the layout probe — integer products at every position of
a diagonal and an off-diagonal tile, summed exactly in fp32, so a wrong
operand layout or staging swizzle shows as a wrong entry.
"""
from __future__ import annotations

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import hessian_accum as K1  # noqa: E402

TOL = {"rtol": 1e-3, "atol": 2e-2}
# (variant, BM) of every ring configuration
RINGS = [(K1.K1_WG, 64), (K1.K1_WG, 128), (K1.K1_WG_TIGHT, 64),
         (K1.K1_WG_DEEP, 64)]
WG = (K1.K1_WG, K1.K1_WG_TIGHT, K1.K1_WG_DEEP)
# (tokens, b): ragged against the 64-token stages and the 64/128 tiles, a
# single stage, and more stages than any split
RAGGED = [(37, 104), (1041, 776), (300, 1096), (80, 200)]
SPLITS = K1.SPLITS


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _plan(variant, BM, CS, pf=0):
    return BM, CS, variant, K1.k1_smem(variant, BM), pf


def _acc(dev, b, base=None):
    xtx = torch.zeros((b, b), device=dev) if base is None else base.clone()
    return [xtx, torch.zeros((), device=dev), torch.zeros((), device=dev)]


def _run(x, valid, acc, plan):
    K1._launch(x, valid, *acc, plan)
    torch.cuda.synchronize()


def _x(dev, tokens, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((tokens, b), generator=g, device=dev).to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,BM,CS", [
    (v, BM, CS) for (v, BM), CS in itertools.product(RINGS, SPLITS)])
@pytest.mark.parametrize("tokens,b", RAGGED)
def test_every_plan_against_plain(cuda, variant, BM, CS, tokens, b):
    """Each configuration, tile and split: against the plain version, onto a
    non-zero symmetric xtx (the reduce adds, it does not store), xtx
    exactly symmetric, count exact, a second launch bitwise the first.  The
    split CTAs prefetch xtx at half their stages (the result is the same)."""
    x = _x(cuda, tokens, b, 1000 * BM + CS)
    g = torch.Generator(device=cuda).manual_seed(b + CS)
    s = torch.randn((b, b), generator=g, device=cuda)
    base = s + s.T
    plan = _plan(variant, BM, CS, 4 if CS > 1 else 0)
    acc_k, acc_p = _acc(cuda, b, base), _acc(cuda, b, base)
    _run(x, None, acc_k, plan)
    K1.hessian_update_plain(x, None, *acc_p)
    torch.testing.assert_close(acc_k[0], acc_p[0], **TOL)
    assert torch.equal(acc_k[0], acc_k[0].T)
    assert float(acc_k[1]) == tokens and float(acc_k[2]) == 0.0
    again = _acc(cuda, b, base)
    _run(x, None, again, plan)
    assert torch.equal(again[0], acc_k[0])


@pytest.mark.cuda
@pytest.mark.parametrize("variant,BM,CS", [
    (v, BM, CS) for (v, BM), CS in itertools.product(RINGS, (1, 2, 4))])
@pytest.mark.parametrize("tokens,b", [(80, 768), (80, 2048), (300, 200)])
def test_masked_rows_with_nan_garbage(cuda, variant, BM, CS, tokens, b):
    """The row mask, applied to each TMA-filled stage in shared memory:
    masked rows hold NaN and count as zero rows in both operands; a NaN in
    a valid row skips the batch and leaves xtx bitwise as it was."""
    g = torch.Generator(device=cuda).manual_seed(7 * BM + CS)
    x = _x(cuda, tokens, b, BM + CS)
    valid = torch.rand((tokens,), generator=g, device=cuda) < 0.6
    x[~valid] = torch.nan
    plan = _plan(variant, BM, CS)
    acc_k, acc_p = _acc(cuda, b), _acc(cuda, b)
    _run(x, valid, acc_k, plan)
    K1.hessian_update_plain(x, valid, *acc_p)
    torch.testing.assert_close(acc_k[0], acc_p[0], **TOL)
    assert torch.equal(acc_k[0], acc_k[0].T)
    assert float(acc_k[1]) == float(valid.sum()) and float(acc_k[2]) == 0.0
    before = acc_k[0].clone()
    x[int(valid.nonzero()[0]), b // 2] = torch.nan   # a poisoned valid row
    _run(x, valid, acc_k, plan)
    assert torch.equal(acc_k[0], before)
    assert float(acc_k[1]) == float(valid.sum()) and float(acc_k[2]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("variant,BM,CS", [
    (K1.K1_WG, 64, 4), (K1.K1_WG_DEEP, 64, 2), (K1.K1_WG, 128, 1)])
def test_nan_batch_skipped_whole(cuda, variant, BM, CS):
    """A non-finite value anywhere in an unmasked batch: xtx untouched,
    skipped += 1, count unchanged — at a split, so every CTA holds it."""
    x = _x(cuda, 1024, 1024, 5)
    x[700, 3] = torch.inf
    acc = _acc(cuda, 1024)
    _run(x, None, acc, _plan(variant, BM, CS))
    assert float(acc[0].abs().max()) == 0.0
    assert float(acc[1]) == 0.0 and float(acc[2]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("variant,BM,CS", [
    (v, BM, CS) for (v, BM), CS in itertools.product(RINGS, (1, 4))])
def test_layout_probe_every_tile_position(cuda, variant, BM, CS):
    """One token row for each pair r < c of 2·BM columns: 1 at r, w(r, c)
    at c (small integers), so xtx[r, c] = w(r, c) exactly — every position
    of the diagonal tiles and of the off-diagonal one — and each diagonal
    entry an exact integer sum.  Exact equality with the plain version."""
    b = 2 * BM
    pairs = torch.tensor(list(itertools.combinations(range(b), 2)),
                         device=cuda)
    tokens = pairs.shape[0]
    w = ((pairs[:, 0] * 7 + pairs[:, 1] * 3) % 13 + 1).float()
    x = torch.zeros((tokens, b), device=cuda)
    rows = torch.arange(tokens, device=cuda)
    x[rows, pairs[:, 0]] = 1.0
    x[rows, pairs[:, 1]] = w
    x = x.to(torch.bfloat16)
    acc_k, acc_p = _acc(cuda, b), _acc(cuda, b)
    _run(x, None, acc_k, _plan(variant, BM, CS))
    K1.hessian_update_plain(x, None, *acc_p)
    assert torch.equal(acc_k[0], acc_p[0]), \
        (acc_k[0] != acc_p[0]).nonzero()[:8].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,b,masked", [
    (1024, 512, False), (1024, 1024, False), (1024, 1152, False),
    (1024, 1536, False), (1024, 2048, False), (1024, 2560, False),
    (1024, 5632, False), (80, 768, True), (80, 2048, True),
    (16384, 2048, False)])
def test_wrapper_plans_the_wgmma_kernel(cuda, tokens, b, masked):
    """The counted wrapper at path shapes: planned on the wgmma kernel,
    one launch counted, against the plain version."""
    x = _x(cuda, tokens, b, tokens + b)
    valid = None
    if masked:
        valid = torch.arange(tokens, device=cuda) % 3 != 0
        x[~valid] = torch.nan
    _, _, plan = K1.k1_operands(x, valid, torch.empty((b, b), device=cuda))
    assert plan[2] in WG, plan
    acc_k, acc_p = _acc(cuda, b), _acc(cuda, b)
    n = K1.hessian_update_cuda.launches
    K1.hessian_update_cuda(x, valid, *acc_k)
    K1.hessian_update_plain(x, valid, *acc_p)
    torch.cuda.synchronize()
    assert K1.hessian_update_cuda.launches == n + 1
    torch.testing.assert_close(acc_k[0], acc_p[0], **TOL)
    assert torch.equal(acc_k[0], acc_k[0].T)
    assert float(acc_k[1]) == float(acc_p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,b", [(100, 770), (64, 1024)])
def test_fallbacks_keep_the_scalar_kernel(cuda, tokens, b):
    """b % 8 ≠ 0, or x not 16-byte aligned: the mma.sync kernel's scalar
    loads, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(tokens + b)
    flat = torch.randn(tokens * b + 1, generator=g, device=cuda).to(
        torch.bfloat16)
    x = flat[1:].view(tokens, b) if b % 8 == 0 else flat[:-1].view(tokens, b)
    _, _, plan = K1.k1_operands(x, None, torch.empty((b, b), device=cuda))
    assert plan[2] == K1.K1_SCALAR, plan
    acc_k, acc_p = _acc(cuda, b), _acc(cuda, b)
    K1.hessian_update_cuda(x, None, *acc_k)
    K1.hessian_update_plain(x, None, *acc_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc_k[0], acc_p[0], **TOL)
    assert torch.equal(acc_k[0], acc_k[0].T)
