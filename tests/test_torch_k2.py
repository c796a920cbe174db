"""K2, the n:m compressed matmul, in its served format (bf16 2:4): the
launch plan ``nm_spmm._k2_plan`` on the CPU; the plain version against the
JAX package's Pallas kernel (interpret mode, through ``ops.nm_matmul``'s
padding) at the batch sizes and ragged widths the card's tests use; and, on
a card only, the tensor-core kernel against its plain version.

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


def _plan(c, b, B, idx_bits=4, esize=2, aligned=True, nm=(2, 4)):
    nn, m = nm
    L = (b // m) * (m - nn)
    stride = (L + 1) // 2 if idx_bits == 4 else L
    return K2._k2_plan(c, b, L, stride, B, esize, aligned, nn, m)


def _assert_tc(plan):
    mode, CS, smem = plan
    assert mode == 2, plan
    assert CS in (1, 2, 4, 8)
    assert 0 < smem and smem + 64 <= SMEM


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
    """B > 8 (a grid dimension over row groups of 8) and ragged c keep the
    tensor-core path; the grid covers every row group."""
    plan = _plan(c, b, B, idx_bits)
    _assert_tc(plan)
    assert K2._k2_ctas(c, B, plan) == -(-c // 8) * plan[1] * -(-B // 8)


@pytest.mark.parametrize("c,b,B,CS", [(256, 16384, 1, 1), (256, 16384, 8, 2),
                                      (37, 16384, 17, 2), (64, 32768, 8, 4),
                                      (64, 65536, 8, 8)])
def test_k2_plan_splits_wide_rows(c, b, B, CS):
    """Rows too wide for one block's 227 KB (8 weight rows and min(B, 8)
    x rows) split over a cluster of the least CS that fits."""
    plan = _plan(c, b, B)
    _assert_tc(plan)
    assert plan[1] == CS


@pytest.mark.parametrize("case", [
    dict(esize=4),                               # fp32
    dict(nm=(5, 8)),                             # another n:m
    dict(nm=(2, 8)),
    dict(aligned=False),                         # an unaligned base
    dict(b=1000),                                # b % 32 ≠ 0
    dict(b=100),                                 # odd L (50 kept values)
    dict(b=1 << 18),                             # too wide even split 8 ways
])
def test_k2_plan_other_formats_take_the_old_kernel(case):
    """fp32, n:m other than 2:4, rows that are not 16-byte aligned and rows
    too wide for any split take the warp-per-row kernel: its vector path
    (mode 1) where L % 8 == 0 and the bases are aligned, else the scalar
    path (mode 0)."""
    b = case.pop("b", 2048)
    kw = dict(esize=2, aligned=True, nm=(2, 4)) | case
    nn, m = kw["nm"]
    L = (b // m) * (m - nn)
    mode, CS, smem = _plan(2048, b, 4, **kw)
    assert (CS, smem) == (1, 0)
    assert mode == int(kw["aligned"] and L % 8 == 0)


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
    """The tensor-core path (its plan checked) against the plain version,
    and two launches bitwise the same."""
    g, _, _, pk = _card_packed(cuda, c, b, idx_bits, c + b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    assert _plan(c, b, B, idx_bits)[0] == 2
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
    plan = (2, CS, K2._k2_smem(b, L, stride, B, CS))
    y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
    y_2 = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
    torch.testing.assert_close(y_k.float(), y_p.float(), **BF16)
    assert torch.equal(y_k, y_2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_k2_tc_wide_rows_split_on_card(cuda, B):
    """b = 16384 at B = 8 is planned as a 2-CTA cluster (the rows do not
    fit one block): the wrapper's own launch against the plain version."""
    c, b = 64, 16384
    g, _, _, pk = _card_packed(cuda, c, b, 4, b + B)
    x = torch.randn((B, b), generator=g, device=cuda).to(torch.bfloat16)
    assert _plan(c, b, B)[1] == (2 if B == 8 else 1)
    y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=2, m=4, b=b,
                            idx_bits=4)
    y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
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
