"""The kernels' plain PyTorch versions against the JAX package's Pallas
kernels (run in interpret mode, as tests/test_kernels.py runs them) and its
oracles; the dispatch rules of ``repro_torch.kernels.ops``; and, on a card
only, each CUDA kernel against its plain version.

Tolerances: K2 fp32 rtol/atol 1e-5 (the same expansion, sums in another
order); K2 bf16 rtol 2e-2 / atol 1e-2 (the plain version multiplies in
bf16, the Pallas body in fp32); K1 rtol 1e-3 / atol 2e-2 (fp32 sums of
different association), as tests/test_kernels.py holds the Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.masks import nm_mask as j_nm_mask  # noqa: E402
from repro.core.sparsity import pack_nm as j_pack_nm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.hessian_accum import hessian_xtx as j_hessian_xtx  # noqa
from repro.kernels.nm_spmm import nm_matmul as j_nm_matmul  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels import hessian_accum as K1  # noqa: E402
from repro_torch.kernels import nm_spmm as K2  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402


def _packed(c, b, nn, m, dtype, seed=0, idx_bits=4):
    """JAX-packed masked matrix and its port counterpart."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(c, b)), dtype)
    xn = jnp.asarray(rng.uniform(0.5, 2.0, size=(b,)), jnp.float32)
    mask = j_nm_mask(w.astype(jnp.float32), xn, nn, m)
    wm = jnp.where(mask > 0.5, 0, w)
    jp = j_pack_nm(wm, mask, nn, m, idx_bits=idx_bits)
    return wm, jp, params_from_numpy(jax_tree_to_numpy({"p": jp}),
                                   device="cpu")["p"]


def _tol(dtype):
    return ({"rtol": 2e-2, "atol": 1e-2} if dtype == jnp.bfloat16
            else {"rtol": 1e-5, "atol": 1e-5})


# the grid of tests/test_kernels.py::TestNmSpmm::test_vs_oracle
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("c,b,B,nn,m,bb,bc", [
    (128, 256, 8, 2, 4, 128, 64),
    (256, 512, 4, 4, 8, 256, 128),
    (64, 128, 16, 1, 4, 64, 32),
    (128, 128, 2, 2, 4, 128, 128),
])
def test_nm_plain_vs_pallas_and_oracle(dtype, c, b, B, nn, m, bb, bc,
                                       idx_bits):
    rng = np.random.default_rng(c + b)
    _, jp, tp = _packed(c, b, nn, m, dtype, seed=b, idx_bits=idx_bits)
    x = jnp.asarray(rng.normal(size=(B, b)), dtype)
    y_t = K2.nm_matmul_plain(t(x), tp.values, tp.indices, nn, m, b, idx_bits)
    assert y_t.dtype == t(np.asarray(x)).dtype and y_t.shape == (B, c)
    y_pal = j_nm_matmul(x, jp.values, jp.indices, n=nn, m=m, b=b,
                        idx_bits=idx_bits, block_b=bb, block_c=bc,
                        interpret=True)
    y_ref = jref.nm_matmul_ref(x, jp.values, jp.indices, nn, m, b, idx_bits)
    for y_j in (y_pal, y_ref):
        np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32),
                                   **_tol(dtype))


# the grid of tests/test_kernels.py::test_parity_ref_pallas_dense_nondivisible
@pytest.mark.parametrize("nn,m", [(2, 4), (4, 8), (3, 4), (5, 8)])
@pytest.mark.parametrize("c,b,B", [(37, 24, 5), (64, 96, 3), (129, 520, 7)])
def test_nm_plain_nondivisible(c, b, B, nn, m):
    """Ragged shapes: the plain version needs no padding (fp32, 1e-5)."""
    if b % m:
        pytest.skip("b must be a multiple of m by format")
    rng = np.random.default_rng(c * 1000 + b + m)
    wm, jp, tp = _packed(c, b, nn, m, jnp.float32, seed=b + m)
    x = jnp.asarray(rng.normal(size=(B, b)), jnp.float32)
    y_t = tops.nm_matmul(t(x), tp)
    y_pal = jops.nm_matmul(x, jp, impl="pallas")
    for y_j in (y_pal, x @ wm.T):
        np.testing.assert_allclose(n(y_t), np.asarray(y_j), rtol=1e-5,
                                   atol=1e-5)


def test_ops_leading_dims_and_dispatch():
    _, _, tp = _packed(32, 64, 2, 4, jnp.float32)
    x = torch.randn(2, 3, 64)
    y = tops.nm_matmul(x, tp)
    assert y.shape == (2, 3, 32)
    torch.testing.assert_close(y, tops.nm_matmul(x, tp, impl="ref"),
                               rtol=0, atol=0)
    # 'kernel' demands a CUDA tensor: no quiet fallback on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tops.nm_matmul(x, tp, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        K2.nm_matmul_cuda(x[0], tp.values, tp.indices, n=2, m=4, b=64,
                          idx_bits=4)
    with pytest.raises(ValueError, match="impl"):
        tops.NmKernelConfig(impl="pallas")


# the grid of tests/test_kernels.py::TestHessianAccum::test_vs_oracle
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("tok,b,bb,bt", [
    (512, 256, 128, 256),
    (256, 128, 128, 128),
    (1024, 64, 64, 256),
])
def test_hessian_plain_vs_pallas(dtype, tok, b, bb, bt):
    """2·XᵀX: plain vs Pallas interpret (rtol 1e-3 / atol 2e-2)."""
    rng = np.random.default_rng(tok)
    x = jnp.asarray(rng.normal(size=(tok, b)), dtype)
    h_t = tops.hessian_xtx(t(x))
    h_j = j_hessian_xtx(x, block_b=bb, block_t=bt, interpret=True)
    assert h_t.dtype == torch.float32
    np.testing.assert_allclose(n(h_t), np.asarray(h_j), rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(n(h_t), np.asarray(jref.hessian_ref(x)),
                               rtol=1e-3, atol=2e-2)


def test_hessian_update_plain_guards():
    """The fused update: invalid rows masked before the finiteness check,
    a non-finite valid row skips the batch whole (exact)."""
    x = torch.randn(16, 8)
    valid = torch.arange(16) % 3 != 0
    x[~valid] = torch.nan
    xtx, cnt, skp = torch.zeros(8, 8), torch.zeros(()), torch.zeros(())
    K1.hessian_update_plain(x, valid, xtx, cnt, skp)
    xv = x[valid]
    torch.testing.assert_close(xtx, xv.T @ xv)
    assert float(cnt) == float(valid.sum()) and float(skp) == 0.0
    x2 = torch.randn(16, 8)
    x2[3, 5] = torch.inf
    K1.hessian_update_plain(x2, None, xtx, cnt, skp)
    torch.testing.assert_close(xtx, xv.T @ xv)
    assert float(cnt) == float(valid.sum()) and float(skp) == 1.0
    with pytest.raises(ValueError, match="CUDA"):
        K1.hessian_update_cuda(x2, None, xtx, cnt, skp)


# ---------------------------------------------------------------- on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,B,nn,m", [(2048, 2048, 4, 2, 4),
                                        (37, 96, 3, 5, 8), (129, 520, 7, 2, 4)])
def test_nm_kernel_vs_plain_on_card(cuda, c, b, B, nn, m, dtype, idx_bits):
    """K2 vs its plain version on the card: fp32 1e-4 (sum order), bf16
    rtol 2e-2 / atol 1e-2."""
    from repro_torch.core.masks import nm_mask

    g = torch.Generator(device=cuda).manual_seed(c + b)
    w = (torch.randn((c, b), generator=g, device=cuda) / b ** 0.5).to(dtype)
    mask = nm_mask(w.float(), torch.ones(b, device=cuda), nn, m)
    pk = tsp.pack_nm(w, mask, nn, m, idx_bits=idx_bits)
    x = torch.randn((B, b), generator=g, device=cuda).to(dtype)
    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=nn, m=m, b=b,
                            idx_bits=idx_bits)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, nn, m, b, idx_bits)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hessian_kernel_vs_plain_on_card(cuda, dtype):
    """K1 vs its plain version on the card (rtol 1e-3 / atol 2e-2), with
    masked rows; a NaN batch is skipped exactly."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((300, 200), generator=g, device=cuda).to(dtype)
    valid = torch.rand((300,), generator=g, device=cuda) < 0.7
    acc_k = [torch.zeros((200, 200), device=cuda),
             torch.zeros((), device=cuda), torch.zeros((), device=cuda)]
    acc_p = [a.clone() for a in acc_k]
    K1.hessian_update_cuda(x, valid, *acc_k)
    K1.hessian_update_plain(x, valid, *acc_p)
    x[5, 5] = torch.nan
    K1.hessian_update_cuda(x, None, *acc_k)
    K1.hessian_update_plain(x, None, *acc_p)
    torch.testing.assert_close(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
    assert float(acc_k[1]) == float(acc_p[1]) == float(valid.sum())
    assert float(acc_k[2]) == float(acc_p[2]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,c,b,nn,m", [(128, 8, 768, 2048, 2, 4),
                                          (5, 3, 37, 96, 2, 4),
                                          (5, 3, 37, 96, 5, 8),
                                          (3, 17, 33, 100, 2, 4)])
def test_nm_stacked_kernel_vs_plain_on_card(cuda, E, C, c, b, nn, m, dtype,
                                            idx_bits):
    """K3 vs its plain version on the card (K2's tolerances), one launch
    per stacked leaf through ``ops.nm_matmul_stacked`` with impl auto."""
    from repro_torch.core.masks import nm_mask

    g = torch.Generator(device=cuda).manual_seed(E + c + b)
    w = (torch.randn((E, c, b), generator=g, device=cuda) / b ** 0.5).to(dtype)
    mask = nm_mask(w.reshape(E * c, b).float(), torch.ones(b, device=cuda),
                   nn, m).reshape(E, c, b)
    pk = tsp.pack_nm_stacked(w, mask, nn, m, idx_bits=idx_bits)
    x = torch.randn((E, C, b), generator=g, device=cuda).to(dtype)
    before = K2.nm_matmul_stacked_cuda.launches
    y_k = tops.nm_matmul_stacked(x, pk)
    assert K2.nm_matmul_stacked_cuda.launches == before + 1
    y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, nn, m, b,
                                     idx_bits)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    assert y_k.shape == (E, C, c) and y_k.dtype == dtype
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tok,b", [(37, 100), (37, 770), (80, 100),
                                   (80, 770)])
def test_hessian_kernel_odd_shapes_on_card(cuda, tok, b, dtype, masked):
    """K1 at ragged tokens and b (rows not 16-byte aligned): vs the plain
    version (rtol 1e-3 / atol 2e-2), xtx exactly symmetric, garbage in
    masked rows ignored, a NaN in a valid row skips the batch."""
    g = torch.Generator(device=cuda).manual_seed(tok * b)
    x = torch.randn((tok, b), generator=g, device=cuda).to(dtype)
    valid = (torch.rand((tok,), generator=g, device=cuda) < 0.6
             if masked else None)
    if masked:
        x[~valid] = torch.nan
    acc_k = [torch.zeros((b, b), device=cuda),
             torch.zeros((), device=cuda), torch.zeros((), device=cuda)]
    acc_p = [a.clone() for a in acc_k]
    for _ in range(2):
        K1.hessian_update_cuda(x, valid, *acc_k)
        K1.hessian_update_plain(x, valid, *acc_p)
    torch.testing.assert_close(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
    assert torch.equal(acc_k[0], acc_k[0].T)
    assert float(acc_k[1]) == float(acc_p[1])
    before = acc_k[0].clone()
    row = 0 if valid is None else int(valid.nonzero()[0])
    x[row, b // 2] = torch.nan
    K1.hessian_update_cuda(x, valid, *acc_k)
    assert torch.equal(acc_k[0], before) and float(acc_k[2]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,c,b,nn,m", [(6, 3, 37, 128, 2, 4),
                                          (6, 17, 300, 128, 5, 8),
                                          (5, 17, 37, 96, 2, 4),
                                          (4, 3, 33, 104, 5, 8)])
def test_nm_stacked_kernel_skips_zero_groups_on_card(cuda, E, C, c, b, nn,
                                                     m, dtype, idx_bits):
    """K3 with a mix of all-zero and filled row groups (whole experts and,
    at C = 17, the middle group of live experts): vs the plain version
    (K2's tolerances), and every output row of an all-zero group is
    bitwise +0.  (128, 300) rows cover a ragged second 128-row block."""
    from repro_torch.core.masks import nm_mask

    g = torch.Generator(device=cuda).manual_seed(E * C + c + b)
    w = (torch.randn((E, c, b), generator=g, device=cuda) / b ** 0.5).to(dtype)
    mask = nm_mask(w.reshape(E * c, b).float(), torch.ones(b, device=cuda),
                   nn, m).reshape(E, c, b)
    pk = tsp.pack_nm_stacked(w, mask, nn, m, idx_bits=idx_bits)
    x = torch.randn((E, C, b), generator=g, device=cuda).to(dtype)
    idle = torch.arange(E, device=cuda) % 2 == 0
    x[idle] = 0.0
    x[1, 0, 0] = -0.0
    if C > 8:
        x[~idle, 8:16] = 0.0
    y_k = K2.nm_matmul_stacked_cuda(x, pk.values, pk.indices, n=nn, m=m,
                                    b=b, idx_bits=idx_bits)
    y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, nn, m, b,
                                     idx_bits)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=tol[0],
                               atol=tol[1])
    bits = y_k.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    assert bool((bits[idle] == 0).all())
    if C > 8:
        assert bool((bits[~idle, 8:16] == 0).all())
