"""K1's launch plan and plain version on the CPU: ``_k1_plan`` at every
shape the card paths launch K1 at (and at 2 048 and 16 384 tokens), its
fallbacks, its shared-memory sizes against the source's ring layouts, the
plain version against JAX's Pallas ``hessian_xtx`` in interpret mode, and
the build digest's headers.  The kernels themselves run only on a card
(``tests/test_torch_k1_cuda.py``)."""
from __future__ import annotations

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.hessian_accum import hessian_xtx as j_hessian_xtx  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import hessian_accum as K1  # noqa: E402

WG = {K1.K1_WG, K1.K1_WG_TIGHT, K1.K1_WG_DEEP}
# (tokens, b, masked) of every K1 launch on the card paths (chip_smoke's
# phase 5 rows) → the plan the sweep chose: (BM, CS, variant, pf)
PATH_PLANS = {
    (1024, 512, False): (64, 1, K1.K1_WG_DEEP, 0),
    (1024, 1024, False): (64, 1, K1.K1_WG_DEEP, 0),
    (1024, 1152, False): (64, 1, K1.K1_WG_DEEP, 0),
    (1024, 1536, False): (64, 1, K1.K1_WG, 0),
    (1024, 2048, False): (64, 1, K1.K1_WG_TIGHT, 0),
    (1024, 2560, False): (128, 1, K1.K1_WG, 0),
    (1024, 3584, False): (64, 1, K1.K1_WG_DEEP, 7),
    (1024, 4096, False): (64, 1, K1.K1_WG_DEEP, 7),
    (1024, 5632, False): (64, 1, K1.K1_WG, 7),
    (1024, 6912, False): (64, 1, K1.K1_WG, 7),
    (1024, 7168, False): (64, 1, K1.K1_WG, 7),
    (1024, 8192, False): (64, 1, K1.K1_WG, 7),
    (1024, 12288, False): (64, 1, K1.K1_WG, 7),
    (1024, 14336, False): (64, 1, K1.K1_WG, 7),
    (1024, 16384, False): (128, 1, K1.K1_WG, 7),
    (1024, 18432, False): (128, 1, K1.K1_WG, 7),
    (1024, 28672, False): (128, 1, K1.K1_WG, 7),
    (80, 2048, True): (64, 1, K1.K1_WG_TIGHT, 0),
    (80, 768, True): (64, 1, K1.K1_WG_TIGHT, 0),
}
LONG = [(t, b) for t in (2048, 16384) for b in (1024, 2048, 5632)]


@pytest.mark.parametrize("shape", sorted(PATH_PLANS))
def test_plan_at_every_path_shape(shape):
    """The sweep's table at each path shape, and what any plan must be:
    the wgmma kernel, its shared memory, a split each CTA can walk."""
    tokens, b, masked = shape
    plan = K1._k1_plan(tokens, b, masked)
    BM, CS, variant, smem, pf = plan
    assert (BM, CS, variant, pf) == PATH_PLANS[shape]
    assert smem == K1.k1_smem(variant, BM) <= 227 * 1024
    # the unmasked path rows plan no split: one CTA's walk of 1 024 tokens
    # beat every cluster split on the card
    assert -(-tokens // K1._BK[variant]) >= CS
    assert K1._k1_plan(tokens, b, not masked)[2] in WG


@pytest.mark.parametrize("tokens,b", LONG)
@pytest.mark.parametrize("masked", [False, True])
def test_plan_at_long_batches(tokens, b, masked):
    """2 048 and 16 384 tokens: tiles of 128 from b > 2 560 (2 048 tokens)
    and throughout (16 384), a split only over a short grid, each CTA
    keeping at least _WG_MIN_STAGES stages."""
    BM, CS, variant, smem, pf = K1._k1_plan(tokens, b, masked)
    assert variant in WG and smem == K1.k1_smem(variant, BM)
    stages = -(-tokens // K1._BK[variant])
    nt = -(-b // BM)
    tiles = nt * (nt + 1) // 2
    assert CS in K1.SPLITS and stages >= 2 * CS * K1._WG_MIN_STAGES or \
        CS == 1
    if CS > 1:
        assert tiles * CS // 2 < K1._SMS
    if not masked and (tokens >= K1._LONG or b > 2560):
        assert BM == 128
    if (tokens, b, masked) == (16384, 1024, False):
        assert (BM, CS) == (128, 4)      # the sweep's fastest there
    assert 0 <= pf < 8


@pytest.mark.parametrize("case,want", [
    (dict(tokens=1024, b=2048, masked=False, bf16=False), K1.K1_F32),
    (dict(tokens=1024, b=2044, masked=False), K1.K1_SCALAR),
    (dict(tokens=37, b=770, masked=True), K1.K1_SCALAR),
    (dict(tokens=1024, b=2048, masked=False, aligned=False), K1.K1_SCALAR),
    (dict(tokens=0, b=2048, masked=False), K1.K1_SCALAR),
])
def test_fallbacks(case, want):
    """fp32 x keeps the CUDA-core kernel; b % 8 ≠ 0, an unaligned x or xtx
    and an empty batch keep the mma.sync kernel's scalar loads."""
    BM, CS, variant, smem, pf = K1._k1_plan(**case)
    assert variant == want and CS == 1 and pf == 0
    assert smem == K1.k1_smem(variant, BM)
    if want == K1.K1_SCALAR:
        assert BM == (64 if case["b"] <= 2048 else 128)


def test_operands_plan_from_alignment():
    """k1_operands plans from the tensors: a contiguous bf16 x (16-byte
    aligned, b % 8 == 0) on the wgmma kernel, the same values 2 bytes off
    alignment on the scalar loads, fp32 on the CUDA cores."""
    flat = torch.zeros(64 * 256 + 8, dtype=torch.bfloat16)
    xtx = torch.zeros((256, 256))
    aligned = flat[:-8].view(64, 256)
    assert K1.k1_operands(aligned, None, xtx)[2][2] in WG
    off = flat[1:-7].view(64, 256)
    assert off.data_ptr() % 16 == 2
    assert K1.k1_operands(off, None, xtx)[2][2] == K1.K1_SCALAR
    assert K1.k1_operands(aligned.float(), None, xtx)[2][2] == K1.K1_F32
    with pytest.raises(ValueError, match="valid must be bool"):
        K1.k1_operands(aligned, torch.ones(63, dtype=torch.bool), xtx)


def test_smem_matches_the_source():
    """k1_smem against the ring layouts the source instantiates (WgBase64
    … WgDeep: tile, stage tokens, stages), and the scan scratch's size."""
    src = (_build.CSRC / "hessian_xtx.cu").read_text()
    rings = dict(re.findall(r"using (Wg\w+) = Wg<(\d+, \d+, \d+)>;", src))
    assert set(rings) == {"WgBase64", "WgBase128", "WgTight", "WgDeep"}
    want = {"WgBase64": (K1.K1_WG, 64), "WgBase128": (K1.K1_WG, 128),
            "WgTight": (K1.K1_WG_TIGHT, 64), "WgDeep": (K1.K1_WG_DEEP, 64)}
    for name, args in rings.items():
        BM, BK, NST = (int(v) for v in args.split(", "))
        variant, bm = want[name]
        assert bm == BM and K1._BK[variant] == BK
        assert K1.k1_smem(variant, BM) == NST * 2 * (BM // 64) * BK * 128 \
            + 1024
    checked = re.findall(r"if \(variant == (\d+)[^)]*\) want = "
                         r"(?:BM == 64 \? )?(Wg\w+)::SMEM", src)
    assert {int(v): want[name][0] for v, name in checked} == {
        K1.K1_WG: K1.K1_WG, K1.K1_WG_TIGHT: K1.K1_WG_TIGHT,
        K1.K1_WG_DEEP: K1.K1_WG_DEEP}
    blocks = int(re.search(r"constexpr int SCAN_BLOCKS = (\d+);", src)[1])
    parts = int(re.search(r"constexpr int SCAN_PARTS = (\d+);", src)[1])
    assert K1._STATS_INTS == parts + 2 * blocks


def test_splits_match_the_source():
    """The C entry takes exactly the token splits ``_k1_plan`` can return,
    and the plan reaches the largest of them on a short grid."""
    src = (_build.CSRC / "hessian_xtx.cu").read_text()
    cs_ok = re.search(r"const bool cs_ok = ([^;]+);", src)[1]
    assert tuple(int(v) for v in re.findall(r"CS == (\d+)", cs_ok)) == \
        K1.SPLITS
    assert K1._k1_plan(1 << 20, 256, False)[1] == K1.SPLITS[-1]


@pytest.mark.parametrize("tokens", [37, 80, 300, 1041])
@pytest.mark.parametrize("b", [100, 770, 1100])
def test_plain_vs_pallas_interpret(tokens, b):
    """The plain version on a zero accumulator is JAX's H = 2·XᵀX / 2, the
    Pallas kernel run in interpret mode over a grid of several blocks
    (token counts that straddle a 64-token stage, b ragged to the 64/128
    tiles); rtol 1e-3 / atol 2e-2 as every K1 check (fp32 sums in another
    order).  With a row mask, the masked rows count as zero rows."""
    rng = np.random.default_rng(tokens * 10_000 + b)
    x = rng.standard_normal((tokens, b)).astype(np.float32)
    bt = tokens if tokens % 2 else tokens // 2
    h_j = np.asarray(j_hessian_xtx(x, block_b=b // 2, block_t=bt,
                                   interpret=True))
    acc = [torch.zeros((b, b)), torch.zeros(()), torch.zeros(())]
    K1.hessian_update_plain(torch.from_numpy(x), None, *acc)
    np.testing.assert_allclose(2.0 * acc[0].numpy(), h_j, rtol=1e-3,
                               atol=2e-2)
    assert float(acc[1]) == tokens and float(acc[2]) == 0.0
    valid = rng.random(tokens) < 0.6
    xm = np.where(valid[:, None], x, np.nan).astype(np.float32)
    acc = [torch.zeros((b, b)), torch.zeros(()), torch.zeros(())]
    K1.hessian_update_plain(torch.from_numpy(xm), torch.from_numpy(valid),
                            *acc)
    h_m = np.asarray(j_hessian_xtx(np.where(valid[:, None], x, 0.0),
                                   block_b=b // 2, block_t=bt,
                                   interpret=True))
    np.testing.assert_allclose(2.0 * acc[0].numpy(), h_m, rtol=1e-3,
                               atol=2e-2)
    assert float(acc[1]) == valid.sum()


def test_digest_follows_included_headers(tmp_path, monkeypatch):
    """A library's path changes with its source, with a csrc header the
    source includes and with a header that header includes — and not with
    a header nobody includes."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "c.cuh").write_text("int c;\n")
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh",
                                                       "b.cuh"]
    paths = [_build._lib_path("k")]
    for name, text in (("c.cuh", "int c2;\n"), ("b.cuh", "int b2;\n"),
                       ("a.cuh", '#include "b.cuh"\nint a2;\n'),
                       ("k.cu", '#include "a.cuh"\n// edited\n')):
        (tmp_path / name).write_text(text)
        paths.append(_build._lib_path("k"))
    assert paths[1] == paths[0]                    # c.cuh: not included
    assert len(set(paths[1:])) == 4                # every other edit
