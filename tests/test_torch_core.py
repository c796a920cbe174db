"""The port's prune core against the JAX package's: the Hessian accumulator,
the masks, the three Thanos variants, the magnitude baseline and the
numerical guards — the same numpy inputs through both."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import make_problem  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import hessian as jh  # noqa: E402
from repro.core import magnitude as jmag  # noqa: E402
from repro.core import masks as jm  # noqa: E402
from repro.core import reference as jref  # noqa: E402
from repro.core import thanos as jth  # noqa: E402
from repro.faults import InsufficientCalibration as JInsufficient  # noqa
from repro.faults import SingularHessian as JSingular  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import hessian as th  # noqa: E402
from repro_torch.core import magnitude as tmag  # noqa: E402
from repro_torch.core import masks as tm  # noqa: E402
from repro_torch.core import thanos as tth  # noqa: E402
from test_torch_fixtures import n, t  # noqa: E402

# Thanos weights: rtol 5e-3 / atol 5e-4, as tests/test_thanos_algorithms.py
# holds the JAX functions against the NumPy oracle; masks exactly.
W_TOL = {"rtol": 5e-3, "atol": 5e-4}


# ------------------------------------------------------------ accumulator
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_accumulator_matches_jax(dtype):
    """xtx (rtol 1e-5), count, skipped and finalize equal to JAX's, over a
    clean batch, a row-masked batch with garbage rows, and a NaN batch."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 12, 16)) for _ in range(3)]
    valid = rng.uniform(size=(2, 12)) < 0.6
    xs[1][~valid] = np.nan          # masked before the finiteness check
    xs[2][0, 3, 4] = np.inf         # a poisoned valid row: skipped whole
    ja, ta = jh.HessianAccumulator.init(16), th.HessianAccumulator.init(16)
    for x, v in zip(xs, (None, valid, None)):
        xj = jnp.asarray(x, dtype)
        ja = ja.update(xj, None if v is None else jnp.asarray(v))
        ta = ta.update(t(xj), None if v is None else torch.from_numpy(v))
    assert float(ta.count) == float(ja.count) == 24 + valid.sum()
    assert float(ta.skipped) == float(ja.skipped) == 1.0
    np.testing.assert_allclose(n(ta.xtx), np.asarray(ja.xtx), rtol=1e-5,
                               atol=1e-5)
    for mean in (True, False):
        np.testing.assert_allclose(n(ta.finalize(mean=mean)),
                                   np.asarray(ja.finalize(mean=mean)),
                                   rtol=1e-5, atol=1e-5)


def test_accumulator_min_count_guard():
    """All batches skipped → InsufficientCalibration in both packages."""
    x = np.full((4, 8), np.nan, np.float32)
    ja = jh.HessianAccumulator.init(8).update(jnp.asarray(x))
    ta = th.HessianAccumulator.init(8).update(torch.from_numpy(x))
    with pytest.raises(JInsufficient):
        ja.finalize(min_count=1)
    with pytest.raises(tfaults.InsufficientCalibration, match="1 non-finite"):
        ta.finalize(min_count=1)
    np.testing.assert_array_equal(n(ta.finalize()), np.asarray(ja.finalize()))


def test_inverse_factor_matches_jax():
    """dampen + U with H⁻¹ = UᵀU (rtol 1e-4 / atol 1e-5)."""
    _, h, _ = make_problem(c=8, b=24, a=64, seed=3)
    hd_j = jh.dampen(h)
    hd_t = th.dampen(t(h))
    np.testing.assert_allclose(n(hd_t), np.asarray(hd_j), rtol=1e-6)
    np.testing.assert_allclose(n(th.inv_cholesky_upper(hd_t)),
                               np.asarray(jh.inv_cholesky_upper(hd_j)),
                               rtol=1e-4, atol=1e-5)
    assert th.DAMP_FLOOR == jh.DAMP_FLOOR


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("r", [-3, 0, 1, 37, 95, 96, 500])
def test_rank_threshold_mask_bit_equal_with_ties(r):
    """Tie-heavy metric (integers): the same selection, stable ties."""
    rng = np.random.default_rng(r + 10)
    metric = rng.integers(0, 6, size=(8, 12)).astype(np.float32)
    metric[0, :3] = np.inf
    sel_j = np.asarray(jm.rank_threshold_mask(jnp.asarray(metric), r))
    sel_t = n(tm.rank_threshold_mask(torch.from_numpy(metric), r))
    np.testing.assert_array_equal(sel_t, sel_j)
    k = max(min(r, metric.size), 0)
    want = np.zeros(metric.size, bool)
    want[np.argsort(metric.ravel(), kind="stable")[:k]] = True
    np.testing.assert_array_equal(sel_t.ravel(), want)


@pytest.mark.parametrize("nn,m", [(2, 4), (1, 4), (3, 4), (5, 8)])
def test_nm_mask_and_phi_bit_equal_with_ties(nn, m):
    rng = np.random.default_rng(nn * 10 + m)
    w = rng.integers(-3, 4, size=(6, 4 * m)).astype(np.float32)
    xn = rng.integers(1, 3, size=(4 * m,)).astype(np.float32)
    mk_j = np.asarray(jm.nm_mask(jnp.asarray(w), jnp.asarray(xn), nn, m))
    mk_t = n(tm.nm_mask(torch.from_numpy(w), torch.from_numpy(xn), nn, m))
    np.testing.assert_array_equal(mk_t, mk_j)
    assert tm.check_nm(torch.from_numpy(mk_t), nn, m)
    for r_max in (nn * 4, 4 * m):
        q_j, v_j = jm.phi_padded(jnp.asarray(mk_j), r_max)
        q_t, v_t = tm.phi_padded(torch.from_numpy(mk_t), r_max)
        np.testing.assert_array_equal(n(q_t), np.asarray(q_j))
        np.testing.assert_array_equal(n(v_t), np.asarray(v_j))


# ------------------------------------------------------------------ Thanos
def _thanos_pair(w, h, fn_j, fn_t, **kw):
    rj = fn_j(w, h, **kw)
    rt = fn_t(t(w), t(h), **kw)
    np.testing.assert_array_equal(n(rt.mask), np.asarray(rj.mask))
    np.testing.assert_allclose(n(rt.weights), np.asarray(rj.weights),
                               **W_TOL)
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=1e-3)
    return rt


@pytest.mark.parametrize("p,B", [(0.5, 16), (0.25, 16), (0.7, 32), (0.5, 24)])
def test_unstructured_matches_jax_and_oracle(p, B):
    w, h, _ = make_problem(c=24, b=64, a=256, seed=0)
    rt = _thanos_pair(w, h, jth.prune_unstructured, tth.prune_unstructured,
                      p=p, block_size=B)
    w_ref, m_ref = jref.thanos_unstructured_ref(np.asarray(w), np.asarray(h),
                                                p, B)
    np.testing.assert_array_equal(n(rt.mask), m_ref)
    np.testing.assert_allclose(n(rt.weights), w_ref, **W_TOL)


@pytest.mark.parametrize("nn,m,B,alpha", [(2, 4, 16, 0.0), (4, 8, 32, 0.0),
                                          (1, 4, 64, 0.0), (2, 4, 32, 0.1)])
def test_nm_matches_jax_and_oracle(nn, m, B, alpha):
    w, h, _ = make_problem(c=20, b=64, a=256, seed=4)
    rt = _thanos_pair(w, h, jth.prune_nm, tth.prune_nm, n=nn, m=m,
                      block_size=B, alpha=alpha)
    if alpha == 0.0:
        w_ref, m_ref = jref.thanos_nm_ref(np.asarray(w), np.asarray(h), nn, m,
                                          B)
        np.testing.assert_array_equal(n(rt.mask), m_ref)
        np.testing.assert_allclose(n(rt.weights), w_ref, **W_TOL)


@pytest.mark.parametrize("p,alpha", [(0.3, 0.0), (0.3, 0.1), (0.5, 0.25)])
def test_structured_matches_jax_and_oracle(p, alpha):
    w, h, _ = make_problem(c=24, b=48, a=192, seed=6)
    rt = _thanos_pair(w, h, jth.prune_structured, tth.prune_structured, p=p,
                      alpha=alpha)
    w_ref, m_ref = jref.thanos_structured_ref(np.asarray(w), np.asarray(h),
                                              p, alpha)
    np.testing.assert_array_equal(n(rt.mask), m_ref)
    np.testing.assert_allclose(n(rt.weights), w_ref, **W_TOL)


@pytest.mark.parametrize("pattern", ["unstructured", "nm", "structured"])
def test_magnitude_and_registry_match_jax(pattern):
    """Magnitude masks and weights exactly; prune_layer dispatch and
    reconstruction_error (rtol 1e-4) as in JAX."""
    w, h, _ = make_problem(c=16, b=32, a=64, seed=2)
    for method in ("magnitude", "thanos"):
        cfg_j = japi.PruneConfig(method=method, pattern=pattern, p=0.4,
                                 block_size=16)
        cfg_t = tapi.PruneConfig(method=method, pattern=pattern, p=0.4,
                                 block_size=16)
        assert cfg_t.tag() == cfg_j.tag()
        rj = japi.prune_layer(w, h, cfg_j)
        rt = tapi.prune_layer(t(w), t(h), cfg_t)
        np.testing.assert_array_equal(n(rt.mask), np.asarray(rj.mask))
        tol = {"rtol": 0, "atol": 0} if method == "magnitude" else W_TOL
        np.testing.assert_allclose(n(rt.weights), np.asarray(rj.weights),
                                   **tol)
        np.testing.assert_allclose(
            float(tapi.reconstruction_error(t(w), rt.weights, t(h))),
            float(japi.reconstruction_error(w, rj.weights, h)), rtol=1e-3)
    ref = {"unstructured": jmag.prune_unstructured, "nm": jmag.prune_nm,
           "structured": jmag.prune_structured}[pattern]
    kw = {"n": 2, "m": 4} if pattern == "nm" else {"p": 0.4}
    mine = {"unstructured": tmag.prune_unstructured, "nm": tmag.prune_nm,
            "structured": tmag.prune_structured}[pattern]
    np.testing.assert_array_equal(n(mine(t(w), **kw).mask),
                                  np.asarray(ref(w, **kw).mask))


def test_prune_config_validation():
    for bad in ({"method": "obs"}, {"pattern": "blocky"}, {"p": 1.0},
                {"n": 4, "m": 4}, {"percdamp": 0.0}, {"alpha": 1.0}):
        with pytest.raises(ValueError):
            tapi.PruneConfig(**bad)
        with pytest.raises(ValueError):
            japi.PruneConfig(**bad)


# ---------------------------------------------------------- numerical guards
H_INDEFINITE = np.array([[1.0, 4.0], [4.0, 1.0]], np.float32)
H_HOPELESS = np.array([[1.0, 1e9], [1e9, 1.0]], np.float32)


def _guard(info) -> tuple:
    return (info.damp_attempts, pytest.approx(info.percdamp_used),
            info.fallback, info.h_finite)


@pytest.mark.parametrize("h,policy,escalations", [
    (H_INDEFINITE, "escalate", 4),
    (H_HOPELESS, "fallback:magnitude", 2),
    (H_INDEFINITE, "fallback:magnitude", 1),
])
def test_singular_hessian_guard_info_matches_jax(h, policy, escalations):
    """A non-PD H: cholesky_ex + NaN fill make the port escalate and fall
    back exactly as JAX does — the same GuardInfo and weights."""
    w = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32)
    kw = dict(on_singular=policy, max_escalations=escalations)
    rj, ij = japi.prune_layer_guarded(
        jnp.asarray(w), jnp.asarray(h),
        japi.PruneConfig(method="thanos", p=0.5, block_size=2), **kw)
    rt, it = tapi.prune_layer_guarded(
        torch.from_numpy(w), torch.from_numpy(h),
        tapi.PruneConfig(method="thanos", p=0.5, block_size=2), **kw)
    assert dataclasses.astuple(it) == _guard(ij)
    np.testing.assert_array_equal(n(rt.mask), np.asarray(rj.mask))
    np.testing.assert_allclose(n(rt.weights), np.asarray(rj.weights),
                               **W_TOL)


@pytest.mark.parametrize("h", [H_INDEFINITE, H_HOPELESS])
def test_singular_hessian_fail_policies_match_jax(h):
    w = np.ones((4, 2), np.float32)
    for policy, esc in (("fail", 4), ("escalate", 2)):
        with pytest.raises(JSingular) as ej:
            japi.prune_layer_guarded(
                jnp.asarray(w), jnp.asarray(h),
                japi.PruneConfig(method="thanos", p=0.5, block_size=2),
                on_singular=policy, max_escalations=esc, path="blocks/0/w")
        try:
            tapi.prune_layer_guarded(
                torch.from_numpy(w), torch.from_numpy(h),
                tapi.PruneConfig(method="thanos", p=0.5, block_size=2),
                on_singular=policy, max_escalations=esc, path="blocks/0/w")
        except tfaults.SingularHessian as et:
            assert et.attempts == ej.value.attempts
            assert "blocks/0/w" in str(et)
        else:
            pytest.fail(f"{policy}: the port completed where JAX raised")


def test_nonfinite_hessian_skips_escalation():
    w, h, _ = make_problem(c=8, b=16, a=64, seed=1)
    h = np.asarray(h).copy()
    h[0, 0] = np.nan
    cfg = tapi.PruneConfig(method="thanos", p=0.5, block_size=8)
    with pytest.raises(tfaults.SingularHessian) as e:
        tapi.prune_layer_guarded(t(w), torch.from_numpy(h), cfg)
    assert e.value.attempts == 0
    res, info = tapi.prune_layer_guarded(t(w), torch.from_numpy(h), cfg,
                                         on_singular="fallback:magnitude")
    assert info.fallback == "magnitude" and not info.h_finite
    assert bool(torch.isfinite(res.weights).all())
    with pytest.raises(ValueError, match="on_singular"):
        tapi.prune_layer_guarded(t(w), t(h), cfg, on_singular="retry")
