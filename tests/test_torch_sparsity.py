"""The port's n:m format (``repro_torch.core.sparsity``) against the JAX
package's: packs byte-identical, expansion bit-exact, the same ratios."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.core.masks import nm_mask as j_nm_mask  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_fixtures import n, t  # noqa: E402


def _both(c, b, nn, m, dtype, seed=0, idx_bits=4):
    """The same masked matrix packed by both packages (JAX mask)."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(c, b)), dtype)
    xn = jnp.asarray(rng.uniform(0.5, 2.0, size=(b,)), jnp.float32)
    mask = j_nm_mask(w.astype(jnp.float32), xn, nn, m)
    wm = jnp.where(mask > 0.5, 0, w)
    jp = jsp.pack_nm(wm, mask, nn, m, idx_bits=idx_bits)
    tp = tsp.pack_nm(t(wm), t(mask), nn, m, idx_bits=idx_bits)
    return wm, jp, tp


def _bytes(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


# the grid of tests/test_kernels.py::TestPackUnpack::test_roundtrip
@pytest.mark.parametrize("idx_bits", [4, 8])
@pytest.mark.parametrize("nn,m", [(2, 4), (4, 8), (1, 4), (3, 4), (5, 8)])
def test_pack_byte_identical_and_roundtrip(nn, m, idx_bits):
    """Values and index bytes identical to JAX's (tolerance: none)."""
    wm, jp, tp = _both(32, 64, nn, m, jnp.float32, idx_bits=idx_bits)
    np.testing.assert_array_equal(n(tp.values), np.asarray(jp.values))
    np.testing.assert_array_equal(n(tp.indices), _bytes(jp.indices))
    np.testing.assert_array_equal(n(tsp.unpack_nm(tp)), np.asarray(wm))


@pytest.mark.parametrize("c,L", [(3, 8), (5, 7), (1, 1), (4, 13)])
def test_indices4_byte_identical(c, L):
    """Low nibble first, odd length padded into the last high nibble —
    the same bytes as JAX's (tolerance: none)."""
    rng = np.random.default_rng(c * 31 + L)
    idx = rng.integers(0, 16, size=(c, L))
    jpk = jsp.pack_indices4(jnp.asarray(idx, jnp.int8))
    tpk = tsp.pack_indices4(torch.from_numpy(idx))
    assert tuple(tpk.shape) == (c, (L + 1) // 2)
    np.testing.assert_array_equal(n(tpk), _bytes(jpk))
    np.testing.assert_array_equal(n(tsp.unpack_indices4(tpk, L)), idx)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("idx_bits", [4, 8])
def test_expand_bit_exact(dtype, idx_bits):
    """nm_expand places values only: bit-exact vs JAX (tolerance: none)."""
    wm, jp, tp = _both(16, 32, 2, 4, dtype, idx_bits=idx_bits)
    d_t = tref.nm_expand(tp.values, tp.indices, 2, 4, 32, idx_bits)
    d_j = jref.nm_expand(jp.values, jp.indices, 2, 4, 32, idx_bits)
    assert d_t.dtype == t(np.asarray(jp.values)).dtype
    np.testing.assert_array_equal(n(d_t), np.asarray(d_j, np.float32))
    np.testing.assert_array_equal(n(d_t), np.asarray(wm, np.float32))


@pytest.mark.parametrize("dtype,idx_bits,ratio", [
    (jnp.bfloat16, 4, 0.625), (jnp.float32, 4, 0.5625),
    (jnp.bfloat16, 8, 0.75)])
def test_compression_ratio(dtype, idx_bits, ratio):
    """Bytes over dense bytes: 0.625 / 0.5625 / 0.75, as in JAX (1e-6)."""
    _, jp, tp = _both(32, 64, 2, 4, dtype, idx_bits=idx_bits)
    assert abs(tsp.compression_ratio(tp) - ratio) < 1e-6
    assert abs(tsp.compression_ratio(tp) - jsp.compression_ratio(jp)) < 1e-12


def test_pack_rejects_bad_idx_bits():
    w = torch.zeros((2, 32))
    with pytest.raises(ValueError, match="idx_bits"):
        tsp.pack_nm(w, w, 2, 4, idx_bits=2)
    with pytest.raises(ValueError, match="m ≤ 16"):
        tsp.pack_nm(w, w, 2, 32, idx_bits=4)
