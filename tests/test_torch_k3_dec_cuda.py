"""K3 at decode occupancy on a card: plan mode 4, ``nm_stacked_sp_dec_kernel``
(bf16 2:4 on the sparse tensor cores, only the active row groups' 128-row
weight tiles streamed), marked ``cuda`` (skips without one; this file
imports no JAX, so it runs where JAX is absent):

    python -m pytest -q --noconftest -m cuda tests/test_torch_k3_dec_cuda.py

The two full-width qwen3-moe-30b-a3b leaves run with x from the port's own
``moe_ffn`` dispatch (a random router) at the sweep's token counts, through
the wrapper (its plan checked to be mode 4, counted on
``nm_stacked_sp_dec``), and at C = 48; ragged shapes run every cluster
size and ring depth under explicit plans (uncounted), and the kernel's own
choice between splitting K over a cluster (few active items) and one CTA an
item (many) is held on both sides.  Every case holds the kernel
against the plain version at bf16 rtol 2e-2 / atol 1e-2 (the plain version
multiplies in bf16, the kernel sums in fp32) and against the fp32 product of
the same operands: its max relative error at most the dense bf16 product's
plus 2⁻⁸ (one bf16 step).  Every output of a row group whose x is all zero
(−0 included) is bitwise +0, even with a NaN weight in that expert (the
CAVEAT of the source); a NaN kept weight of an active expert gives NaN in
its output column.  A CUDA graph captured on one routing and replayed on
another computes the second routing, bitwise the direct call.  The
mode-2 tensor-core kernel, which the wrapper plans for an x off 16-byte
alignment, is held to the plain version on the same leaves and shapes.
"""
from __future__ import annotations

import itertools
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.masks import nm_mask  # noqa: E402
from repro_torch.core.sparsity import (pack_nm_stacked,  # noqa: E402
                                       unpack_nm_stacked)
from repro_torch.kernels import nm_spmm as K2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

BF16 = {"rtol": 2e-2, "atol": 1e-2}
ARCH = "qwen3-moe-30b-a3b"
# the sweep's token counts, all at capacity C = 8 (moe.capacity)
TOKENS = (1, 2, 4, 8, 16, 32, 64, 115)
# (E, C, c, b) ragged against the 128-row tiles, the row groups and the
# stages (ZERO_K3's 2:4 shapes that mode 4 takes: b = 96's 4-bit index rows
# of 24 bytes are not whole 16-byte rows, so that shape is 8-bit only)
RAGGED = [(6, 3, 37, 128), (4, 17, 200, 512), (5, 17, 37, 96),
          (3, 8, 300, 1088)]
PAIRS = list(itertools.combinations(range(4), 2))   # the six 2:4 pairs


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _pack(dev, E, c, b, bits, seed, nan=None):
    """A random (E, c, b) stack, 2:4 by magnitude, packed; ``nan`` = (e, r)
    puts NaN in one kept weight of expert e's row r."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn((E, c, b), generator=g, device=dev)
         / math.sqrt(b)).to(torch.bfloat16)
    mask = nm_mask(w.reshape(E * c, b).float(), torch.ones((b,), device=dev),
                   2, 4).reshape(E, c, b)
    if nan is not None:
        e, r = nan
        w[e, r, int((mask[e, r] < 0.5).nonzero()[0])] = torch.nan
    return g, pack_nm_stacked(w, mask, 2, 4, idx_bits=bits)


def _bits(b: int) -> tuple:
    """The index widths whose rows are whole 16-byte rows at b."""
    return tuple(bits for bits in (4, 8) if (b // 2 * bits // 8) % 16 == 0)


def _check(y, x, pk, bits, equal_nan=False):
    """y against the plain version and against the fp32 product; every
    output of an all-zero row group bitwise +0."""
    b = x.shape[-1]
    assert y.shape == (*x.shape[:2], pk.values.shape[1])
    assert y.dtype == torch.bfloat16
    y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, 2, 4, b, bits)
    idle = ~K2.active_row_groups(x)                         # (E, G)
    rows = idle.repeat_interleave(8, dim=1)[:, :x.shape[1]]  # (E, C)
    assert bool((y.view(torch.int16)[rows] == 0).all())
    y_p = torch.where(rows[..., None], torch.zeros_like(y_p), y_p)
    torch.testing.assert_close(y.float(), y_p.float(), equal_nan=equal_nan,
                               **BF16)
    if equal_nan:
        return
    w = unpack_nm_stacked(pk)
    y32 = torch.bmm(x.float(), w.float().transpose(1, 2))
    scale = max(float(y32.abs().max()), 1e-30)
    rel = float((y.float() - y32).abs().max()) / scale
    dense = float((torch.bmm(x, w.transpose(1, 2)).float() - y32).abs()
                  .max()) / scale
    assert rel <= dense + 2 ** -8, (rel, dense)


def _plan(x, pk, bits):
    return K2._k3_operands(x, pk.values, pk.indices, 2, 4, x.shape[-1],
                           bits)[3]


def _launch(x, pk, bits, mode=4):
    """Two counted launches, bitwise equal, the plan checked to be
    ``mode``."""
    plan = _plan(x, pk, bits)
    assert plan[0] == mode, plan
    n, dec = K2.nm_matmul_stacked_cuda.launches, K2.nm_stacked_sp_dec.launches
    ys = [K2.nm_matmul_stacked_cuda(x, pk.values, pk.indices, n=2, m=4,
                                    b=x.shape[-1], idx_bits=bits)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert K2.nm_matmul_stacked_cuda.launches == n + 2
    assert K2.nm_stacked_sp_dec.launches == dec + 2 * (mode == 4)
    assert torch.equal(ys[0].view(torch.int16), ys[1].view(torch.int16)), plan
    return ys[0], plan


def _mode2(pk, b):
    """The mode-2 tensor-core plan for the pack."""
    L, stride = pk.values.shape[-1], pk.indices.shape[-1]
    plan = K2._k3_plan(L, stride, b, 2, True)
    assert plan[0] == 2
    return plan


def _direct(x, pk, bits, plan):
    """Two uncounted launches under ``plan``, bitwise equal."""
    b = x.shape[-1]
    ys = [K2._launch_k3(x, pk.values, pk.indices, 2, 4, b, bits, plan)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0].view(torch.int16), ys[1].view(torch.int16)), plan
    return ys[0]


def _plans(E, C, c, b, bits):
    """Every cluster size with ≥ one stage a CTA, rings of 2 and the
    deepest that fits (cut to K3D_MAXST)."""
    nks = -(-b // (32 * K2._DEC_KS))
    EG = E * -(-C // 8)
    out = []
    for CS in K2._K3D_SPLITS:
        if nks < CS:
            continue
        top = max(d for d in range(2, K2._K3D_MAXST + 1)
                  if K2._k3_dec_fits(d, CS, EG, bits))
        for nst in sorted({2, top}):
            out.append((4, CS, nst))
    return out


def _x(g, dev, E, C, b, active):
    """x (E, C, b) with rows only in the (e, row group) pairs of
    ``active``; the rest exactly zero."""
    x = torch.zeros((E, C, b), device=dev, dtype=torch.bfloat16)
    for e, grp in active:
        r = slice(8 * grp, min(C, 8 * grp + 8))
        x[e, r] = torch.randn(x[e, r].shape, generator=g, device=dev).to(
            torch.bfloat16)
    return x


@pytest.fixture(scope="module")
def leaves(cuda):
    """{bits: (gate/up pack (128, 768, 2048), down pack (128, 2048, 768))}
    and the dispatch's x at every token count: {(bits, T): (x into gate/up,
    x into down)}, made by the port's moe_ffn at full width."""
    cfg = get_config(ARCH)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    packs, xs = {}, {}
    for bits in (4, 8):
        _, gu = _pack(cuda, E, f, d, bits, 11 + bits)
        _, dn = _pack(cuda, E, d, f, bits, 12 + bits)
        packs[bits] = (gu, dn)
    g = torch.Generator(device=cuda).manual_seed(3)
    p = {"router": {"w": (torch.randn((d, E), generator=g, device=cuda)
                          / math.sqrt(d)).to(torch.bfloat16)},
         "gate": {"w": packs[4][0]}, "up": {"w": packs[4][0]},
         "down": {"w": packs[4][1]}}
    seen: list = []
    real = ops.nm_matmul_stacked

    def spy(x, packed, **kw):
        seen.append(x.clone())
        return real(x, packed, **kw)

    ops.nm_matmul_stacked = spy
    try:
        with torch.no_grad():
            for T in TOKENS:
                seen.clear()
                x = torch.randn((T, 1, d), generator=g, device=cuda).to(
                    torch.bfloat16)
                moe_mod.moe_ffn(p, x, cfg)
                assert len(seen) == 3 and seen[0].shape[1] == 8
                for bits in (4, 8):
                    xs[(bits, T)] = (seen[0], seen[2])
    finally:
        ops.nm_matmul_stacked = real
    return packs, xs


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["gate_up", "down"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T", TOKENS)
def test_leaves_from_the_dispatch(leaves, T, bits, leaf):
    """Both full-width leaves on x from moe_ffn's dispatch at T tokens
    (C = 8): through the wrapper on mode 4, counted, two launches bitwise
    equal; the idle groups +0.  The mode-2 kernel on the same x."""
    packs, xs = leaves
    i = 0 if leaf == "gate_up" else 1
    x, pk = xs[(bits, T)][i], packs[bits][i]
    assert bool(K2.active_row_groups(x).any())
    y, _ = _launch(x, pk, bits)
    _check(y, x, pk, bits)
    _check(_direct(x, pk, bits, _mode2(pk, x.shape[-1])), x, pk, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_every_plan(cuda, shape):
    """Ragged c (% 64 ≠ 0), C ∈ {3, 17} and b against the stages, idle and
    active groups mixed (at C = 17 the middle group of live experts idle):
    every cluster size and depth, and the mode-2 kernel, two launches
    bitwise equal."""
    E, C, c, b = shape
    G = -(-C // 8)
    for bits in _bits(b):
        g, pk = _pack(cuda, E, c, b, bits, E * c + b + bits)
        active = [(e, grp) for e in range(E) for grp in range(G)
                  if e % 2 == 1 and not (G > 2 and grp == 1)]
        x = _x(g, cuda, E, C, b, active)
        x[0, 0, 0] = -0.0                      # −0 counts as zero
        for plan in _plans(E, C, c, b, bits) + [_mode2(pk, b)]:
            _check(_direct(x, pk, bits, plan), x, pk, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_all_zero_x_gives_positive_zero(cuda, bits):
    """An all-zero x (−0 entries included) gives every y bitwise +0 under
    every cluster size, and the wrapper's plan."""
    E, C, c, b = 16, 8, 300, 1088
    _, pk = _pack(cuda, E, c, b, bits, 9)
    x = torch.zeros((E, C, b), device=cuda, dtype=torch.bfloat16)
    x[3, 2, 100] = -0.0
    x[7] = -0.0
    plans = [_plan(x, pk, bits)] + [(4, cs, 2) for cs in (1, 2, 4)]
    for plan in plans:
        y = _direct(x, pk, bits, plan)
        assert bool((y.view(torch.int16) == 0).all()), plan


@pytest.mark.cuda
def test_negative_zero_rows_are_idle(cuda):
    """Row groups whose only entries are −0 are idle (+0 out, bitwise);
    the kernel's vote agrees with ``active_row_groups`` on a mix."""
    E, C, c, b = 8, 17, 128, 256
    g, pk = _pack(cuda, E, c, b, 4, 21)
    x = _x(g, cuda, E, C, b, [(1, 0), (2, 2), (5, 1)])
    x[0] = -0.0
    x[3, 9, 7] = -0.0
    x[4, 16, 255] = 1.0                        # the one row of a last group
    assert K2.active_row_groups(x).nonzero().tolist() == [
        [1, 0], [2, 2], [4, 2], [5, 1]]
    for CS in (1, 2):                          # 2 stages: a split of 2
        _check(_direct(x, pk, 4, (4, CS, 2)), x, pk, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_nan_weights(cuda, bits):
    """A NaN kept weight in an idle expert gives +0 (the CAVEAT: the plain
    version gives NaN there); in an active expert it gives NaN in its
    output column for every capacity row of the active group, the rest
    finite and as the plain version."""
    E, C, c, b = 6, 8, 200, 512
    g, pk = _pack(cuda, E, c, b, bits, 31, nan=(2, 37))
    _, pk2 = _pack(cuda, E, c, b, bits, 31, nan=(3, 150))
    pk.values[3] = pk2.values[3]
    pk.indices[3] = pk2.indices[3]
    x = _x(g, cuda, E, C, b, [(0, 0), (3, 0), (5, 0)])   # expert 2 idle
    for plan in [_plan(x, pk, bits), (4, 4, 2), (4, 1, 3)]:
        y = _direct(x, pk, bits, plan)
        assert bool((y[2].view(torch.int16) == 0).all()), plan
        assert bool(torch.isnan(y[3, :, 150]).all()), plan
        rest = torch.cat([y[3, :, :150], y[3, :, 151:]], 1)
        assert bool(torch.isfinite(rest).all()) and bool(
            torch.isfinite(y[[0, 1, 4, 5]]).all()), plan
        y_p = K2.nm_matmul_stacked_plain(x, pk.values, pk.indices, 2, 4, b,
                                         bits)
        keep = torch.tensor([0, 1, 3, 4, 5], device=cuda)
        torch.testing.assert_close(y[keep].float(), y_p[keep].float(),
                                   equal_nan=True, **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("CS", [1, 2, 4])
def test_graph_replayed_on_another_routing(cuda, CS):
    """A CUDA graph captured on one routing and replayed after x is
    overwritten with another routing's (other experts active, one group
    more) gives bitwise the direct call on the second routing; the direct
    calls agree with the plain version.  At 6 stages one CTA fits an SM,
    so the 8-9 active groups' 48-54 items × CS fit the grid of 132 CTAs
    for CS ≤ 2 (the cluster splits each item), not at CS = 4 (one CTA an
    item)."""
    E, C, c, b = 128, 8, 768, 2048
    g, pk = _pack(cuda, E, c, b, 4, 41)
    x1 = _x(g, cuda, E, C, b, [(e, 0) for e in range(0, 128, 16)])
    x2 = _x(g, cuda, E, C, b, [(e, 0) for e in range(3, 128, 14)])
    plan = (4, CS, 6)
    y2 = _direct(x2, pk, 4, plan)
    _check(y2, x2, pk, 4)
    static = x1.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K2._launch_k3(static, pk.values, pk.indices, 2, 4, b, 4, plan)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = K2._launch_k3(static, pk.values, pk.indices, 2, 4, b, 4, plan)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg, _direct(x1, pk, 4, plan))
    static.copy_(x2)
    yg.fill_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg.view(torch.int16), y2.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_split_and_one_cta_an_item(cuda, bits):
    """One launch shape, both of the kernel's choices: clusters of 4 CTAs
    (at most 264 co-resident at 4 stages) split K where the active items
    × 4 fit (2 active groups × 3 tiles), and give each CTA its own items
    where they do not (every group active: 120 items); y agrees with the
    plain version and the fp32 product either way."""
    E, C, c, b = 40, 8, 300, 1088
    g, pk = _pack(cuda, E, c, b, bits, 51)
    few = _x(g, cuda, E, C, b, [(3, 0), (30, 0)])
    many = _x(g, cuda, E, C, b, [(e, 0) for e in range(E)])
    for x in (few, many):
        for plan in ((4, 4, 4), (4, 1, 4)):
            _check(_direct(x, pk, bits, plan), x, pk, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_every_position_pair_in_every_slot(cuda, bits):
    """Row r's group j keeps the pair PAIRS[(r // 16 + j // 8) % 6] in every
    expert: every pair sits in every row of an m16 tile and every group
    slot of a 32-column step; kept values ±[0.5, 1.5], so one wrong
    position moves the output well past the tolerance."""
    E, C, c, b = 3, 8, 96, 192
    g = torch.Generator(device=cuda).manual_seed(bits)
    mask = torch.ones((c, b))
    for r in range(c):
        for j in range(b // 4):
            for p in PAIRS[(r // 16 + j // 8) % 6]:
                mask[r, 4 * j + p] = 0.0
    mask = mask.to(cuda).expand(E, c, b).contiguous()
    mag = torch.rand((E, c, b), generator=g, device=cuda) + 0.5
    sign = torch.randint(0, 2, (E, c, b), generator=g, device=cuda) * 2 - 1
    w = (mag * sign * (mask < 0.5)).to(torch.bfloat16)
    pk = pack_nm_stacked(w, mask, 2, 4, idx_bits=bits)
    x = _x(g, cuda, E, C, b, [(0, 0), (2, 0)])
    for plan in _plans(E, C, c, b, bits)[::3]:
        _check(_direct(x, pk, bits, plan), x, pk, bits)


@pytest.mark.cuda
def test_refuses_a_plan_it_cannot_launch(cuda):
    """A decode plan with a cluster of 8 or 3, a split that leaves a CTA no
    stage, or a ring of 1 or past K3D_MAXST stages raises; it does
    not run another mode.  So does an x off 16-byte alignment under a
    decode plan (the wrapper plans mode 2 for it)."""
    E, C, c, b = 4, 8, 128, 128                  # one stage a row
    g, pk = _pack(cuda, E, c, b, 4, 5)
    x = _x(g, cuda, E, C, b, [(1, 0)])
    _check(_direct(x, pk, 4, (4, 1, 2)), x, pk, 4)
    for bad in [(4, 8, 2), (4, 3, 2), (4, 2, 2), (4, 1, 1),
                (4, 1, K2._K3D_MAXST + 1)]:
        with pytest.raises(RuntimeError):
            K2._launch_k3(x, pk.values, pk.indices, 2, 4, b, 4, bad)
    off = torch.zeros((E * C * b + 1,), device=cuda,
                      dtype=torch.bfloat16)[1:].view(E, C, b)
    off.copy_(x)
    assert off.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError):
        K2._launch_k3(off, pk.values, pk.indices, 2, 4, b, 4, (4, 1, 2))
    y, plan = _launch(off, pk, 4, mode=2)
    _check(y, off, pk, 4)


@pytest.mark.cuda
def test_through_the_wrapper_at_c48(cuda):
    """A capacity of 48 rows (a prefill of ~600 tokens) through the
    wrapper: mode 4, counted, two launches bitwise equal."""
    E, C, c, b = 128, 48, 768, 2048
    g, pk = _pack(cuda, E, c, b, 4, 61)
    x = _x(g, cuda, E, C, b, [(e, e % 6) for e in range(0, E, 5)])
    y, _ = _launch(x, pk, 4)
    _check(y, x, pk, 4)

