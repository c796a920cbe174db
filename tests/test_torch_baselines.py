"""The port's baselines and solver pieces against the JAX package: Wanda and
SparseGPT in all three patterns (random inputs and inputs with forced
metric ties), SparseGPT against the NumPy oracle, the solver's
``apply_update`` / ``prune_rows_block`` / ``obs_loss``, the trailing
inverses, the paper's method ordering, and the method registry.

Tolerances: masks exactly, ties included; weights rtol 5e-3 / atol 5e-4
(as tests/test_thanos_algorithms.py holds the JAX solvers against the
NumPy oracles; Wanda's weights are a copy with zeros, so exactly); OBS
losses rtol 1e-3; the solver pieces rtol 1e-4 / atol 1e-5."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import make_problem, recon_error  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import hessian as jh  # noqa: E402
from repro.core import masks as jm  # noqa: E402
from repro.core import reference as jref  # noqa: E402
from repro.core import solver as js  # noqa: E402
from repro.core import sparsegpt as jsg  # noqa: E402
from repro.core import wanda as jw  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import hessian as th  # noqa: E402
from repro_torch.core import masks as tm  # noqa: E402
from repro_torch.core import solver as ts  # noqa: E402
from repro_torch.core import sparsegpt as tsg  # noqa: E402
from repro_torch.core import wanda as tw  # noqa: E402
from test_torch_fixtures import n, t  # noqa: E402

W_TOL = {"rtol": 5e-3, "atol": 5e-4}
S_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _tied_problem(c: int = 16, b: int = 32, seed: int = 5):
    """Inputs whose metrics tie everywhere: small-integer weights with every
    row duplicated once (a duplicated row stays a duplicate through every
    OBS update), and H = 2I, so every column has ‖X_j‖ = 1 and — damped
    with ``TIED_DAMP`` to 4I — the same d_j = U_jj² = 1/4: every metric
    and every column sum is exact in fp32, so the ties are exact in both
    packages whatever their summation order."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-2, 3, size=(c // 2, b)).astype(np.float32)
    w = np.repeat(half, 2, axis=0)
    h = (2.0 * np.eye(b)).astype(np.float32)
    return jnp.asarray(w), jnp.asarray(h)


TIED_DAMP = {"percdamp": 1.0}


def _problem(kind: str):
    if kind == "ties":
        return _tied_problem()
    w, h, _ = make_problem(c=24, b=64, a=256, seed=0)
    return w, h


def _pair(fn_j, fn_t, w, h, wtol, **kw):
    rj, rt = fn_j(w, h, **kw), fn_t(t(w), t(h), **kw)
    np.testing.assert_array_equal(n(rt.mask), np.asarray(rj.mask))
    np.testing.assert_allclose(n(rt.weights), np.asarray(rj.weights), **wtol)
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=1e-3)
    assert rt.weights.dtype == torch.float32
    return rt


WANDA = {"unstructured": (jw.prune_unstructured, tw.prune_unstructured,
                          {"p": 0.5}),
         "nm": (jw.prune_nm, tw.prune_nm, {"n": 2, "m": 4}),
         "structured": (jw.prune_structured, tw.prune_structured,
                        {"p": 0.3})}
SPARSEGPT = {
    "unstructured": (jsg.prune_unstructured, tsg.prune_unstructured,
                     {"p": 0.5, "mask_blocksize": 16}),
    "nm": (jsg.prune_nm, tsg.prune_nm, {"n": 2, "m": 4, "blocksize": 16}),
    "structured": (jsg.prune_structured, tsg.prune_structured,
                   {"p": 0.3, "blocksize": 16})}


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("pattern", list(WANDA))
def test_wanda_matches_jax(pattern, kind):
    """Masks and weights exactly (no update, no arithmetic on kept
    weights)."""
    fn_j, fn_t, kw = WANDA[pattern]
    w, h = _problem(kind)
    rt = _pair(fn_j, fn_t, w, h, {"rtol": 0, "atol": 0}, **kw)
    if pattern == "nm":
        assert tm.check_nm(rt.mask, 2, 4)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("pattern", list(SPARSEGPT))
def test_sparsegpt_matches_jax(pattern, kind):
    fn_j, fn_t, kw = SPARSEGPT[pattern]
    w, h = _problem(kind)
    rt = _pair(fn_j, fn_t, w, h, W_TOL,
               **(dict(kw, **TIED_DAMP) if kind == "ties" else kw))
    if pattern == "nm":
        assert tm.check_nm(rt.mask, 2, 4)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("bs,nn,m", [(8, 2, 4), (24, 4, 8), (64, 2, 4)])
def test_sparsegpt_nm_block_sizes(bs, nn, m, kind):
    """Other (n, m) and block sizes, and a block size that falls back to one
    block (b % bs ≠ 0 → bs = b), as in JAX."""
    w, h = _problem(kind)
    _pair(jsg.prune_nm, tsg.prune_nm, w, h, W_TOL, n=nn, m=m, blocksize=bs,
          **(TIED_DAMP if kind == "ties" else {}))
    assert tsg._mask_block_size(64, 24, 8) == jsg._mask_block_size(64, 24,
                                                                   8) == 64


@pytest.mark.parametrize("p,bs", [(0.5, 16), (0.25, 32), (0.7, 64)])
def test_sparsegpt_unstructured_matches_numpy_oracle(p, bs):
    w, h, _ = make_problem(c=24, b=64, a=256, seed=1)
    rt = tsg.prune_unstructured(t(w), t(h), p=p, mask_blocksize=bs)
    w_ref, m_ref = jref.sparsegpt_ref(np.asarray(w), np.asarray(h), p, bs)
    np.testing.assert_array_equal(n(rt.mask), m_ref)
    np.testing.assert_allclose(n(rt.weights), w_ref, **W_TOL)


def test_sparsegpt_dead_features_and_bf16():
    """A dead input feature (zero Hessian diagonal) is zeroed before the
    sweep, and a bf16 weight comes back bf16 — both as in JAX."""
    w, h, _ = make_problem(c=16, b=32, a=64, seed=4)
    h = np.array(h)
    h[5, :] = 0.0
    h[:, 5] = 0.0
    wb = jnp.asarray(w, jnp.bfloat16)
    rj = jsg.prune_nm(wb, jnp.asarray(h), n=2, m=4, blocksize=8)
    rt = tsg.prune_nm(t(wb), t(h), n=2, m=4, blocksize=8)
    assert rt.weights.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(rt.mask), np.asarray(rj.mask))
    np.testing.assert_allclose(n(rt.weights),
                               np.asarray(rj.weights, np.float32),
                               rtol=2e-2, atol=2e-2)
    assert float(rt.weights[:, 5].abs().max()) == 0.0


# ----------------------------------------------------------- solver pieces
def _solver_inputs(seed: int = 3):
    w, h, _ = make_problem(c=12, b=32, a=128, seed=seed)
    u = jh.inv_cholesky_upper(jh.dampen(h))
    hinv = jh.inverse_from_upper(u)
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(12, 32)) < 0.3).astype(np.float32)
    q, valid = jm.phi_padded(jnp.asarray(mask), 16)
    return w, u, hinv, q, valid


@pytest.mark.parametrize("row_chunk", [0, 4])
def test_apply_update_and_prune_rows_block_match_jax(row_chunk):
    w, _, hinv, q, valid = _solver_inputs()
    args_t = (t(hinv), t(w), torch.from_numpy(np.array(q)).long(),
              torch.from_numpy(np.array(valid)))
    lam_j = js.batched_multipliers(hinv, w, q, valid)
    lam_t = ts.batched_multipliers(*args_t)
    np.testing.assert_allclose(n(lam_t), np.asarray(lam_j), **S_TOL)
    up_j = js.apply_update(hinv, w, q, valid, lam_j)
    up_t = ts.apply_update(*args_t, lam_t)
    np.testing.assert_allclose(n(up_t), np.asarray(up_j), **S_TOL)
    pruned = n(up_t)[np.asarray(jnp.zeros((12, 32), bool).at[
        jnp.arange(12)[:, None], q].max(valid))]
    assert (pruned == 0.0).all()                   # exact zeros
    np.testing.assert_allclose(
        n(ts.prune_rows_block(*args_t, row_chunk=row_chunk)),
        np.asarray(js.prune_rows_block(hinv, w, q, valid,
                                       row_chunk=row_chunk)), **S_TOL)


def test_obs_loss_matches_jax_and_prune_block():
    """Per-row S_k (Eq. 61) against JAX, and their sum against the loss
    ``prune_block`` gets from its single solve on a one-block problem."""
    w, _, hinv, q, valid = _solver_inputs(seed=6)
    args_t = (t(hinv), t(w), torch.from_numpy(np.array(q)).long(),
              torch.from_numpy(np.array(valid)))
    s_t = ts.obs_loss(*args_t)
    np.testing.assert_allclose(n(s_t), np.asarray(js.obs_loss(hinv, w, q,
                                                              valid)),
                               rtol=1e-4, atol=1e-4)
    assert s_t.shape == (12,)
    _, loss = ts.prune_block(*args_t, 0, 32)
    np.testing.assert_allclose(float(s_t.sum()), float(loss), rtol=1e-4)


@pytest.mark.parametrize("j", [0, 5, 31])
def test_trailing_inverses_match_jax(j):
    _, u, _, _, _ = _solver_inputs()
    rows = np.array([0, 1, 31 - j][: 3 if j < 31 else 1])
    np.testing.assert_allclose(n(th.trailing_inverse(t(u), j)),
                               np.asarray(jh.trailing_inverse(u, j)),
                               **S_TOL)
    got = th.trailing_inverse_rows(t(u), j, torch.from_numpy(rows))
    np.testing.assert_allclose(
        n(got), np.asarray(jh.trailing_inverse_rows(u, j, jnp.asarray(rows))),
        **S_TOL)
    np.testing.assert_allclose(n(got), n(th.trailing_inverse(t(u), j))[rows],
                               **S_TOL)


# ------------------------------------------------ method ordering, registry
def test_paper_method_ordering():
    """The port's copy of tests/test_thanos_algorithms.py's check (Fig. 1):
    at 50 % unstructured every data-aware method beats magnitude, Thanos
    beats Wanda and stays within 1.05× of SparseGPT; structured Thanos
    beats Wanda and stays within 1.001× of SparseGPT."""
    w, h, _ = make_problem(c=48, b=96, a=384, seed=9)
    errs = {}
    for method in ("thanos", "sparsegpt", "wanda", "magnitude"):
        res = tapi.prune_layer(t(w), t(h), tapi.PruneConfig(
            method=method, p=0.5, block_size=32))
        errs[method] = recon_error(w, n(res.weights), h)
    assert errs["thanos"] < errs["magnitude"]
    assert errs["sparsegpt"] < errs["magnitude"]
    assert errs["wanda"] < errs["magnitude"]
    assert errs["thanos"] < errs["wanda"]
    assert errs["thanos"] <= errs["sparsegpt"] * 1.05

    s_errs = {}
    for method in ("thanos", "sparsegpt", "wanda"):
        res = tapi.prune_layer(t(w), t(h), tapi.PruneConfig(
            method=method, pattern="structured", p=0.3, alpha=0.0))
        s_errs[method] = recon_error(w, n(res.weights), h)
    assert s_errs["thanos"] < s_errs["wanda"]
    assert s_errs["thanos"] <= s_errs["sparsegpt"] * 1.001


@pytest.mark.parametrize("method", ["sparsegpt", "wanda"])
@pytest.mark.parametrize("pattern", ["unstructured", "nm", "structured"])
def test_prune_layer_dispatch_matches_jax(method, pattern):
    """``prune_layer`` routes the registered baselines with the cell's
    hyperparameters as JAX does; reconstruction_error rtol 1e-3."""
    w, h, _ = make_problem(c=16, b=32, a=64, seed=2)
    kw = dict(method=method, pattern=pattern, p=0.4, block_size=16)
    rj = japi.prune_layer(w, h, japi.PruneConfig(**kw))
    rt = tapi.prune_layer(t(w), t(h), tapi.PruneConfig(**kw))
    np.testing.assert_array_equal(n(rt.mask), np.asarray(rj.mask))
    np.testing.assert_allclose(n(rt.weights), np.asarray(rj.weights),
                               **W_TOL)
    np.testing.assert_allclose(
        float(tapi.reconstruction_error(t(w), rt.weights, t(h))),
        float(japi.reconstruction_error(w, rj.weights, h)), rtol=1e-3)


def test_registry_views_and_order_match_jax():
    assert tuple(tapi.METHODS) == tuple(japi.METHODS) == (
        "thanos", "sparsegpt", "wanda", "magnitude")
    assert tuple(tapi.PATTERNS) == tuple(japi.PATTERNS)
    assert tapi.METHODS == tuple(japi.METHODS)
    assert tapi.METHODS == list(japi.METHODS)
    assert tapi.METHODS != "thanos" and tapi.METHODS != 3
    assert tapi.METHODS[1] == "sparsegpt" and len(tapi.METHODS) == 4
    assert "wanda" in tapi.METHODS and "obs" not in tapi.METHODS
    assert repr(tapi.PATTERNS) == repr(japi.PATTERNS)
    with pytest.raises(TypeError):
        hash(tapi.METHODS)


def test_register_method_overwrite_and_unregister():
    w, h, _ = make_problem(c=8, b=16, a=64, seed=1)

    def zero(w, h, cfg):
        return tw.prune_unstructured(w, h, p=cfg.p)

    try:
        with pytest.raises(ValueError, match="already registered"):
            tapi.register_method("wanda", {"unstructured": zero})
        tapi.register_method("toy", {"unstructured": zero, "blocky": zero},
                             data_aware=False)
        assert tapi.METHODS[-1] == "toy" and "blocky" in tapi.PATTERNS
        with pytest.raises(ValueError, match="already registered"):
            tapi.register_method("toy", {"unstructured": zero})
        spec = tapi.register_method("toy", {"nm": zero}, overwrite=True)
        assert tuple(spec.patterns) == ("nm",) and spec.data_aware
        cfg = tapi.PruneConfig(method="toy", pattern="nm", p=0.25)
        assert cfg.to_dict()["method"] == "toy"
        res = tapi.prune_layer(t(w), t(h), cfg)
        assert float(res.mask.mean()) == 0.25
        with pytest.raises(ValueError, match="does not support"):
            tapi.prune_layer(t(w), t(h), tapi.PruneConfig(method="toy"))
        with pytest.raises(ValueError, match="at least one pattern"):
            tapi.register_method("empty", {})
    finally:
        tapi.unregister_method("toy")
        tapi._PATTERN_ORDER.pop("blocky", None)
    tapi.unregister_method("toy")                  # absent: a no-op
    assert "toy" not in tapi.METHODS
    with pytest.raises(ValueError, match="unknown method"):
        tapi.PruneConfig(method="toy")
    assert tuple(tapi.METHODS) == tuple(japi.METHODS)


def test_prune_config_dict_round_trip_matches_jax():
    kw = dict(method="sparsegpt", pattern="nm", n=2, m=4, block_size=64)
    cj, ct = japi.PruneConfig(**kw), tapi.PruneConfig(**kw)
    assert ct.to_dict() == cj.to_dict()
    assert list(ct.to_dict()) == list(cj.to_dict())
    assert tapi.PruneConfig.from_dict(cj.to_dict()) == ct
    for bad in ({"method": "thanos", "sparsity": 0.5}, {"blocksize": 8}):
        with pytest.raises(ValueError, match="unknown PruneConfig fields"):
            tapi.PruneConfig.from_dict(bad)
        with pytest.raises(ValueError, match="unknown PruneConfig fields"):
            japi.PruneConfig.from_dict(bad)

