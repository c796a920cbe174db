"""The port's stacked n:m expert format and K3's plain version against the
JAX package: ``pack_nm_stacked``/``unpack_nm_stacked`` byte-identical, the
plain stacked matmul against the Pallas path (interpret mode) and the JAX
oracle, ``compress_params`` grouping expert slices into one leaf (and
downgrading partial stacks), ``compressed_bytes``, and
``convert.params_from_numpy`` carrying stacked nodes across.

Tolerances: packs and expansions exactly; the stacked matmul fp32 rtol/atol
1e-5 (sums in another order), bf16 rtol 2e-2 / atol 1e-2; compressed
serving on the plain path bitwise equal to the decompressed stack.
"""
from __future__ import annotations

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro.serve.compressed import compressed_bytes as j_bytes  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core.schedule import get_path, set_path  # noqa: E402
from repro_torch.kernels import nm_spmm as K  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve.compressed import (CompressionDowngrade,  # noqa: E402
                                          compress_params, compressed_bytes,
                                          decompress_params)
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402

# K3's decode sweep's digest (tools/k3_plan_sweep.py on an H100) and the
# fit of the plan's decode rule to it
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import k3_plan_sweep  # noqa: E402

SWEEP = k3_plan_sweep.load()


def _nm_mask(w, nn, m):
    """(…, b) n:m mask (1.0 = pruned): the nn smallest |w| of each group,
    as tests/test_stacked_compressed.py makes it."""
    shape = w.shape
    wa = np.abs(np.asarray(w, np.float32)).reshape(*shape[:-1],
                                                   shape[-1] // m, m)
    order = np.argsort(wa, axis=-1)
    mask = np.zeros_like(wa)
    for k in range(nn):
        np.put_along_axis(mask, order[..., k:k + 1], 1.0, axis=-1)
    return mask.reshape(shape)


def _stack(E, c, b, nn, m, dtype=jnp.float32, seed=0, idx_bits=4):
    """A masked (E, c, b) stack packed by both packages."""
    w = np.random.default_rng(seed).normal(size=(E, c, b))
    mask = _nm_mask(w, nn, m)
    sparse = jnp.asarray(w * (1 - mask), dtype)
    jp = jsp.pack_nm_stacked(sparse, jnp.asarray(mask), nn, m,
                             idx_bits=idx_bits)
    tp = tsp.pack_nm_stacked(t(sparse), torch.from_numpy(mask), nn, m,
                             idx_bits=idx_bits)
    return sparse, mask, jp, tp


# the grid of tests/test_stacked_compressed.py::test_pack_unpack_roundtrip
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("nn,m", [(2, 4), (4, 8)])
@pytest.mark.parametrize("idx_bits", [4, 8])
def test_pack_stacked_byte_identical(E, nn, m, idx_bits):
    """Values and index bytes identical to JAX's, the round trip exact,
    and expert e bitwise ``pack_nm(w[e], mask[e])`` (tolerance: none)."""
    c, b = 7, 2 * m
    sparse, mask, jp, tp = _stack(E, c, b, nn, m, seed=E * m,
                                  idx_bits=idx_bits)
    assert (tp.E, tp.b, tp.n, tp.m, tp.idx_bits) == (E, b, nn, m, idx_bits)
    np.testing.assert_array_equal(n(tp.values), np.asarray(jp.values))
    np.testing.assert_array_equal(n(tp.indices),
                                  np.asarray(jp.indices).view(np.uint8))
    np.testing.assert_array_equal(n(tsp.unpack_nm_stacked(tp)),
                                  np.asarray(sparse))
    np.testing.assert_array_equal(n(tp.unpacked_indices()),
                                  np.asarray(jp.unpacked_indices()))
    for e in range(E):
        one = tsp.pack_nm(t(sparse[e]), torch.from_numpy(mask[e]), nn, m,
                          idx_bits=idx_bits)
        assert torch.equal(one.values, tp.values[e])
        assert torch.equal(one.indices, tp.indices[e])
    with pytest.raises(ValueError, match="stacked"):
        tsp.pack_nm_stacked(tp.values[0], tp.values[0], nn, m)


@pytest.mark.parametrize("dtype,idx_bits,ratio", [
    (jnp.bfloat16, 4, 0.625), (jnp.float32, 4, 0.5625),
    (jnp.bfloat16, 8, 0.75)])
def test_stacked_compression_ratio(dtype, idx_bits, ratio):
    _, _, jp, tp = _stack(3, 8, 32, 2, 4, dtype, idx_bits=idx_bits)
    assert tsp.compression_ratio(tp) == ratio == jsp.compression_ratio(jp)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("E,C,c,b,nn,m", [(3, 6, 5, 16, 2, 4),
                                          (2, 3, 9, 24, 5, 8)])
def test_stacked_plain_vs_pallas_and_oracle(E, C, c, b, nn, m, dtype,
                                            idx_bits):
    """Plain K3 vs JAX ``nm_matmul_stacked(impl='pallas')`` in interpret
    mode and ``nm_matmul_stacked_ref``; the expansion bit-exact."""
    _, _, jp, tp = _stack(E, c, b, nn, m, dtype, seed=c + b,
                          idx_bits=idx_bits)
    x = jnp.asarray(np.random.default_rng(E + C).normal(size=(E, C, b)),
                    dtype)
    y_t = K.nm_matmul_stacked_plain(t(x), tp.values, tp.indices, nn, m, b,
                                    idx_bits)
    assert y_t.shape == (E, C, c) and y_t.dtype == t(np.asarray(x)).dtype
    y_pal = jops.nm_matmul_stacked(x, jp, impl="pallas")
    y_ref = jref.nm_matmul_stacked_ref(x, jp.values, jp.indices, nn, m, b,
                                       idx_bits)
    tol = ({"rtol": 2e-2, "atol": 1e-2} if dtype == jnp.bfloat16
           else {"rtol": 1e-5, "atol": 1e-5})
    for y_j in (y_pal, y_ref):
        np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32), **tol)
    np.testing.assert_array_equal(
        n(tref.nm_expand_stacked(tp.values, tp.indices, nn, m, b, idx_bits)),
        np.asarray(jref.nm_expand_stacked(jp.values, jp.indices, nn, m, b,
                                          idx_bits), np.float32))


def _reduced_dispatch(T, dtype, idx_bits):
    """qwen3-moe REDUCED's two expert leaves (gate/up (8, 32, 64), down
    (8, 64, 32)), packed by both packages, and the x the port's moe_ffn
    hands K3 at T tokens (a random router): [(jax pack, port pack, x)] for
    the gate/up and the down leaf."""
    cfg = j_get_config("qwen3-moe-30b-a3b", reduced=True)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    _, _, jgu, tgu = _stack(E, f, d, 2, 4, dtype, seed=T, idx_bits=idx_bits)
    _, _, jdn, tdn = _stack(E, d, f, 2, 4, dtype, seed=T + 1,
                            idx_bits=idx_bits)
    rng = np.random.default_rng(7 * T)
    tdt = tgu.values.dtype
    p = {"router": {"w": torch.from_numpy(rng.normal(size=(d, E)).astype(
            np.float32)).to(tdt)},
         "gate": {"w": tgu}, "up": {"w": tgu}, "down": {"w": tdn}}
    seen = []
    real = tops.nm_matmul_stacked

    def spy(x, packed, **kw):
        seen.append(x.clone())
        return real(x, packed, **kw)

    tops.nm_matmul_stacked = spy
    try:
        x = torch.from_numpy(rng.normal(size=(T, 1, d)).astype(
            np.float32)).to(tdt)
        tmoe.moe_ffn(p, x, cfg)
    finally:
        tops.nm_matmul_stacked = real
    assert len(seen) == 3
    return [(jgu, tgu, seen[0]), (jdn, tdn, seen[2])]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("T", [1, 4])
def test_stacked_plain_vs_pallas_at_decode_occupancy(T, idx_bits, dtype):
    """K3's inputs at decode occupancy — x from the REDUCED moe_ffn
    dispatch of T = 1 and 4 tokens: C = 8 capacity rows of 8 experts, the
    rows of the 6 (T = 1) or more experts no token was routed to exactly
    zero — through the port's plain version against JAX's
    ``nm_matmul_stacked(impl='pallas')`` in interpret mode and its oracle;
    the idle groups' outputs zero.  Tolerances as the stacked cases above."""
    tol = ({"rtol": 2e-2, "atol": 1e-2} if dtype == jnp.bfloat16
           else {"rtol": 1e-5, "atol": 1e-5})
    for jp, tp, x in _reduced_dispatch(T, dtype, idx_bits):
        act = K.active_row_groups(x)
        assert x.shape[1] == 8 and 0 < int(act.sum()) <= min(2 * T, 8)
        y_t = K.nm_matmul_stacked_plain(x, tp.values, tp.indices, 2, 4,
                                        tp.b, idx_bits)
        assert int((y_t[~act[:, 0]] != 0).sum()) == 0
        xj = jnp.asarray(n(x), dtype)
        for y_j in (jops.nm_matmul_stacked(xj, jp, impl="pallas"),
                    jref.nm_matmul_stacked_ref(xj, jp.values, jp.indices, 2,
                                               4, jp.b, idx_bits)):
            np.testing.assert_allclose(n(y_t), np.asarray(y_j, np.float32),
                                       **tol)


def test_stacked_dense_compressed_bitwise_and_dispatch():
    """``stacked_dense`` on the packed stack == on the decompressed one,
    bitwise (plain path); ``impl='kernel'`` on a CPU tensor raises."""
    sparse, _, _, tp = _stack(3, 5, 16, 2, 4, seed=2)
    dense = t(sparse).transpose(-1, -2)            # (E, in, out)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 6, 16)).astype(np.float32))
    y_c = L.stacked_dense({"w": tp}, x)
    torch.testing.assert_close(y_c, L.stacked_dense({"w": dense}, x),
                               rtol=0, atol=0)
    torch.testing.assert_close(y_c, tops.nm_matmul_stacked(x, tp,
                                                           impl="ref"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tops.nm_matmul_stacked(x, tp, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        K.nm_matmul_stacked_cuda(x, tp.values, tp.indices, n=2, m=4, b=16,
                                 idx_bits=4)
    with pytest.raises(ValueError, match="x must be"):
        K.nm_matmul_stacked_cuda(x[0], tp.values, tp.indices, n=2, m=4,
                                 b=16, idx_bits=4)


def _expert_problem(E=2, d_in=8, d_out=4, dtype=torch.float32):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(E, d_in, d_out))).to(dtype)
    params = {"moe": {"gate": {"w": w}}}
    masks = {("moe", "gate", "w", e): torch.from_numpy(
        _nm_mask(w[e].T.float().numpy(), 2, 4).T.copy()) for e in range(E)}
    return params, masks


def test_compress_params_packs_expert_stack_and_inverts():
    params, masks = _expert_problem(E=4, d_in=16, d_out=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", CompressionDowngrade)
        comp = compress_params(params, masks, 2, 4)
    leaf = comp["moe"]["gate"]["w"]
    assert isinstance(leaf, tsp.NmStackedCompressed)
    assert (leaf.E, leaf.n, leaf.m, leaf.b) == (4, 2, 4, 16)
    expect = params["moe"]["gate"]["w"] * (1 - torch.stack(
        [masks[("moe", "gate", "w", e)] for e in range(4)]))
    restored = decompress_params(comp)["moe"]["gate"]["w"]
    assert restored.shape == (4, 16, 8)
    torch.testing.assert_close(restored, expect, rtol=0, atol=0)
    cb, db = compressed_bytes(comp)
    assert db == 4 * 16 * 8 * 4 and cb / db == 0.5625   # fp32, 4-bit idx
    bf16 = compress_params(
        {"w": params["moe"]["gate"]["w"].to(torch.bfloat16)},
        {("w", e): masks[("moe", "gate", "w", e)] for e in range(4)}, 2, 4)
    cb, db = compressed_bytes(bf16)
    assert cb / db == 0.625                              # the paper's ratio


def test_compress_params_partial_stack_downgrades():
    params, masks = _expert_problem()
    del masks[("moe", "gate", "w", 1)]
    with pytest.warns(CompressionDowngrade, match="experts \\[1\\]"):
        comp = compress_params(params, masks, 2, 4)
    assert isinstance(comp["moe"]["gate"]["w"], torch.Tensor)
    with pytest.raises(ValueError, match="SERVE DENSE"):
        compress_params(params, masks, 2, 4, strict=True)


def test_set_path_integer_tail_copies_the_stack():
    w = torch.zeros((3, 2, 2))
    tree = {"a": {"w": w}}
    new = set_path(tree, ("a", "w", 1), torch.ones((2, 2)))
    assert float(w.abs().sum()) == 0.0                  # the input kept
    assert float(get_path(new, ("a", "w", 1)).sum()) == 4.0
    assert float(get_path(new, ("a", "w", 0)).sum()) == 0.0


def test_params_from_numpy_carries_stacked_nodes():
    """A JAX qwen3-moe REDUCED tree with every expert stack compressed
    crosses with the same bytes: bf16 through its bits, int8 indices as
    uint8 (tolerance: none)."""
    dtype = "bfloat16"
    cfg = j_get_config("qwen3-moe-30b-a3b", reduced=True).replace(
        dtype=dtype)
    jparams = j_build(cfg).init(jax.random.PRNGKey(0))
    masks = {}
    for i in range(cfg.num_layers):
        for name in ("gate", "up", "down"):
            w = np.asarray(jparams["blocks"][i]["moe"][name]["w"],
                           np.float32)
            for e in range(cfg.num_experts):
                masks[("blocks", i, "moe", name, "w", e)] = jnp.asarray(
                    _nm_mask(w[e].T, 2, 4).T)
    jcomp = j_compress(jparams, masks, 2, 4)
    tcomp = params_from_numpy(jax_tree_to_numpy(jcomp), device="cpu")
    for i in range(cfg.num_layers):
        for name in ("gate", "up", "down"):
            a = tcomp["blocks"][i]["moe"][name]["w"]
            b = jcomp["blocks"][i]["moe"][name]["w"]
            assert isinstance(a, tsp.NmStackedCompressed)
            assert (a.n, a.m, a.b, a.E, a.idx_bits) == \
                (b.n, b.m, b.b, b.E, b.idx_bits)
            assert a.indices.dtype == torch.uint8
            assert str(a.values.dtype) == f"torch.{dtype}"
            np.testing.assert_array_equal(n(a.values),
                                          np.asarray(b.values, np.float32))
            np.testing.assert_array_equal(
                n(a.indices), np.asarray(b.indices).view(np.uint8))
    assert compressed_bytes(tcomp) == tuple(int(v) for v in j_bytes(jcomp))


def test_stacked_stream_bytes_counts_active_row_groups():
    """K3's data-dependent byte count against a hand count: E = 4 experts
    of c = 6 rows, b = 16, 2:4 with 4-bit indices (L = 8 kept values, 4
    index bytes a row), C = 10 capacity rows = two row groups (8 + 2)."""
    w = np.random.default_rng(3).normal(size=(4, 6, 16))
    pk = tsp.pack_nm_stacked(torch.from_numpy(w).to(torch.bfloat16),
                             torch.from_numpy(_nm_mask(w, 2, 4)), 2, 4,
                             idx_bits=4)
    assert pk.values.shape == (4, 6, 8) and pk.indices.shape == (4, 6, 4)
    x = torch.zeros((4, 10, 16), dtype=torch.bfloat16)
    x[0, 3, 5] = 1.0            # expert 0, first group
    x[0, 9, 0] = -2.0           # expert 0, second group
    x[2, 8, 15] = 0.5           # expert 2, second group only
    x[3, 1, 1] = -0.0           # −0 counts as zero: expert 3 stays idle
    assert K.active_row_groups(x).tolist() == [[True, True], [False, False],
                                               [False, True],
                                               [False, False]]
    per_expert = 6 * 8 * 2 + 6 * 4          # values + index bytes
    x_bytes, y_bytes = 4 * 10 * 16 * 2, 4 * 10 * 6 * 2
    assert K.stacked_stream_bytes(x, pk.values, pk.indices) == \
        3 * per_expert + x_bytes + y_bytes
    assert K.stacked_stream_bytes(torch.zeros_like(x), pk.values,
                                  pk.indices) == x_bytes + y_bytes


# qwen3-moe-30b-a3b's two full-width leaves at decode capacity (C = 8):
# (E, C, c) of gate/up (b = 2048) and of down (b = 768)
GATE_UP, DOWN = (128, 8, 768), (128, 8, 2048)


@pytest.mark.parametrize("L,stride,b,esize,aligned,nm,dec,plan", [
    # the two full-width qwen3-moe leaves, bf16 2:4 4-bit: tensor cores,
    # 8-row stages of 20 KB (gate/up) or 16-row stages of 15 KB (down),
    # x rows padded to ≡ 16 mod 128 bytes, partial tiles of 8 warps × 2
    (1024, 512, 2048, 2, True, (2, 4), (),
     (2, 32, 8, 3 * 8 * 2560 + 8 * 4112 + 2 * 8 * 8 * 8 * 4)),
    (384, 192, 768, 2, True, (2, 4), (),
     (2, 32, 16, 3 * 16 * 960 + 8 * 1552 + 2 * 8 * 16 * 8 * 4)),
    # fp32 or 5:8 with 16-byte rows: the ring on the CUDA cores — 32-lane
    # rows in 8-row stages, or half-warps (48 chunks) in 16-row stages
    (1024, 1024, 2048, 4, True, (2, 4), (),
     (1, 32, 8, 8 * 2048 * 4 + 3 * 8 * 5120)),
    (384, 192, 768, 4, True, (2, 4), (),
     (1, 16, 16, 8 * 768 * 4 + 3 * 16 * 1728)),
    (384, 192, 1024, 2, True, (5, 8), (),
     (1, 16, 16, 8 * 1024 * 2 + 3 * 16 * 960)),
    # 4-bit index rows of 24 bytes, or unaligned bases: the scalar path
    (48, 24, 96, 2, True, (2, 4), (), (0, 32, 0, 8 * 96 * 2)),
    (1024, 512, 2048, 2, False, (2, 4), (), (0, 32, 0, 8 * 2048 * 2)),
    (50, 25, 100, 4, True, (2, 4), (), (0, 32, 0, 8 * 104 * 4)),
    # the same leaves with (E, C, c) at decode capacity, 4- and 8-bit
    # indices: the decode-occupancy kernel, (4, CS, nst) — gate/up's
    # 6 tiles of 128 rows in clusters of 2 (16 stages: 8 a split CTA, a
    # ring of 6), down's 16 unclustered (6 stages, a ring of 4)
    (1024, 512, 2048, 2, True, (2, 4), GATE_UP, (4, 2, 6)),
    (1024, 1024, 2048, 2, True, (2, 4), GATE_UP, (4, 2, 6)),
    (384, 192, 768, 2, True, (2, 4), DOWN, (4, 1, 4)),
    (384, 384, 768, 2, True, (2, 4), DOWN, (4, 1, 4)),
    # prefills of 512 and 8 192 tokens (C = 40, 640) too; with x off
    # 16-byte alignment: the mode-2 kernel
    (1024, 512, 2048, 2, True, (2, 4), (128, 40, 768), (4, 2, 6)),
    (1024, 512, 2048, 2, True, (2, 4), (128, 640, 768), (4, 2, 6)),
    # 64 000 row groups: their list (125 KB) leaves a ring of 4 stages
    (1024, 512, 2048, 2, True, (2, 4), (8000, 64, 768), (4, 2, 4)),
    (1024, 512, 2048, 2, True, (2, 4), (*GATE_UP, False),
     (2, 32, 8, 3 * 8 * 2560 + 8 * 4112 + 2 * 8 * 8 * 8 * 4)),
    # fp32, or 4-bit index rows of 24 bytes (no whole 16-byte rows for the
    # tensor map): never the decode kernel
    (1024, 1024, 2048, 4, True, (2, 4), GATE_UP,
     (1, 32, 8, 8 * 2048 * 4 + 3 * 8 * 5120)),
    (48, 24, 96, 2, True, (2, 4), (5, 8, 37), (0, 32, 0, 8 * 96 * 2)),
])
def test_k3_launch_plan(L, stride, b, esize, aligned, nm, dec, plan):
    """K3's launch plan: without (E, C, c) the path, G lanes a row, SR rows
    a stage, and the shared memory the source lays out (x + 3 ring stages
    [+ the partial tiles of the tensor-core path]); with them, the decode
    kernel's plan where the rule takes the leaf."""
    assert K._k3_plan(L, stride, b, esize, aligned, *nm, *dec) == plan


def test_k3_dec_constants_match_the_source():
    """The decode path's constants and shared-memory layout mirror
    csrc/nm_spmm.cu: the ring's stages at most, the splits and tiles it
    takes, a stage's bytes (K2's decode stage at 128 rows and N = 8) and
    the layout."""
    import re

    src = (Path(K.__file__).parent / "csrc" / "nm_spmm.cu").read_text()
    assert int(re.search(r"constexpr int K3D_MAXST = (\d+);", src)[1]) == \
        K._K3D_MAXST
    assert "(CS != 1 && CS != 2 && CS != 4)" in src
    assert K._K3D_SPLITS == (1, 2, 4)
    assert int(re.search(r"constexpr int K3D_BM = (\d+);", src)[1]) == \
        K._K3D_BM
    assert ("return 1024 + static_cast<size_t>(nst) * dec_stage(K3D_BM, "
            "K3D_N, idx_bits) +") in src
    assert K._k3_dec_stage(4) == 2 * 8 * 128 + 128 * 128 + 128 * 32
    assert K._k3_dec_stage(8) == 2 * 8 * 128 + 128 * 128 + 128 * 64
    assert K._k3_dec_smem(4, 2, 128, 4) == 1024 + 4 * 22528 + 4096 + 256
    assert K._k3_dec_smem(3, 1, 5, 8) == 1024 + 3 * 26624 + 16


def test_k3_dec_rule_is_the_sweeps_fit():
    """The plan's decode rule (``_K3_DEC_RULE``) is what
    tools/k3_plan_sweep.py fits to its digest: of the split targets and
    rings whose plans ran no slower than the mode-2 kernel at any row of any
    C the sweep ran, the one that takes the least time summed over the
    sweep's C = 8 rows — so a retuned sweep that moves it, or at which
    mode 2 wins a row, fails here until the rule is restated."""
    assert k3_plan_sweep.fit(SWEEP) == K._K3_DEC_RULE._asdict()
    assert k3_plan_sweep.slower(SWEEP, K._K3_DEC_RULE._asdict()) == []


@pytest.mark.parametrize("row", k3_plan_sweep.decode_rows(SWEEP),
                         ids=lambda r: f"{r['leaf']}-T{r['T']}-C{r['C']}")
def test_k3_plan_at_the_sweeps_rows(row):
    """At each occupancy the sweep timed (4-bit indices, x from the
    dispatch, decode and prefill), the wrapper's plan for the leaf: the
    decode kernel under the plan the tool's ``rule_plan`` reads off the
    rule, timed there no slower than the mode-2 kernel (the slower of its two
    timings in the row)."""
    c, b, C = row["c"], row["b"], row["C"]
    L = b // 2
    plan = K._k3_plan(L, L // 2, b, 2, True, 2, 4, 128, C, c)
    rule = K._K3_DEC_RULE
    assert plan == (4, *k3_plan_sweep.rule_plan(rule._asdict(), c, b))
    assert k3_plan_sweep.times(row)[plan[1:]] <= max(row["mode2"],
                                                     row["mode2_again"])
