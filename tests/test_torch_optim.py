"""The port's optimizer substrate on the CPU against the JAX package's, from
the same numpy inputs: the three schedules at steps 0 … N+2 (float32,
rel 1e-6: ``cos`` is float32 in both, but two libraries' cos may differ in
the last bit); AdamW over one and three updates for fp32 and bf16 params,
both moment dtypes, clipping on and off, with the decay skip for 1-D
leaves and decay on 2-D and 3-D (stacked expert) leaves — params and
moments at 1e-6 (bf16 leaves: one bf16 ulp, 2⁻⁸·|p|); the step counter
exactly; ``clip_by_global_norm``'s norm and clipped grads; the
sparsity-preserving wrapper on whole-kernel and per-expert masks (pruned
coordinates exactly 0 in both packages, the rest as AdamW's); and
``masks_by_path`` refusing a stale path."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro.optim import sparsity_preserving as j_sparse  # noqa: E402
from repro.optim.masked import masks_by_path as j_masks_by_path  # noqa
from repro_torch.optim import (AdamW, clip_by_global_norm,  # noqa: E402
                               sparsity_preserving)
from repro_torch.optim import schedules as S  # noqa: E402
from repro_torch.optim.masked import masks_by_path  # noqa: E402
from repro_torch.util.tree import leaves  # noqa: E402
from test_torch_fixtures import flat_numpy, n, t  # noqa: E402

SCHEDULES = [("constant", (3e-4,)), ("linear_warmup", (1e-3, 3, 10)),
             ("linear_warmup", (1e-3, 0, 7, 1e-5)),
             ("cosine_warmup", (5e-4, 2, 16)),
             ("cosine_warmup", (2e-3, 0, 9, 1e-4)),
             ("cosine_warmup", (7e-4, 5, 5))]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{a}{b}" for a, b in SCHEDULES])
def test_schedules_match_jax(name, args):
    f, jf = getattr(S, name)(*args), getattr(JS, name)(*args)
    total = args[2] if len(args) > 2 else 4
    for step in range(total + 3):
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = f(s)
            assert got.dtype == torch.float32 and got.ndim == 0
            want = np.float32(jf(jnp.asarray(step, jnp.int32)))
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=0.0)


def _tree(rng):
    """2-D kernels, a 3-D expert stack, 1-D norm/bias leaves, int keys."""
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    return {"embed": {"table": a(11, 6)},
            "blocks": {0: {"w": a(6, 8), "bias": a(8)},
                       1: {"experts": {"w": a(3, 6, 4)}, "scale": a(6)}}}


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else (jnp.asarray(v, dtype), t(np.asarray(jnp.asarray(v, dtype))))
            for k, v in tree.items()}


def _split(pairs, i):
    return {k: _split(v, i) if isinstance(v, dict) else v[i]
            for k, v in pairs.items()}


def _close(jtree, tree, dtype):
    jf, tf = flat_numpy(jtree), flat_numpy(tree)
    assert jf.keys() == tf.keys()
    for k in jf:
        if dtype == "bfloat16":
            np.testing.assert_allclose(tf[k], jf[k], rtol=2 ** -8, atol=1e-7,
                                       err_msg=str(k))
        else:
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-6, atol=1e-7,
                                       err_msg=str(k))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_adamw_matches_jax(pdtype, mdtype, clip):
    rng = np.random.default_rng(0)
    pairs = _cast(_tree(rng), pdtype)
    jp, p = _split(pairs, 0), _split(pairs, 1)
    kw = dict(weight_decay=0.1, clip_norm=clip, moment_dtype=mdtype)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    js, s = jopt.init(jp), opt.init(p)
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    for i, lr in enumerate((1e-2, 3e-3, 5e-3)):
        g = _cast(_tree(rng), pdtype)
        jp, js = jopt.update(_split(g, 0), js, jp, jnp.float32(lr))
        p, s = opt.update(_split(g, 1), s, p, torch.tensor(lr))
        assert int(s.step) == int(js.step) == i + 1
        _close(jp, p, pdtype)
        _close(js.mu, s.mu, mdtype)
        _close(js.nu, s.nu, mdtype)
        assert all(v.dtype == getattr(torch, pdtype) for v in leaves(p))
        assert all(v.dtype == getattr(torch, mdtype) for v in leaves(s.mu))


def test_weight_decay_skips_1d_leaves_only():
    """Zero grads: a 1-D leaf stays, 2-D and 3-D leaves shrink by lr·wd·p."""
    rng = np.random.default_rng(1)
    p = {k: t(v) for k, v in {"w": rng.normal(size=(4, 5)),
                              "stack": rng.normal(size=(2, 4, 5)),
                              "scale": rng.normal(size=(5,))}.items()}
    p = {k: v.float() for k, v in p.items()}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    opt = AdamW(weight_decay=0.1, clip_norm=0.0)
    new, _ = opt.update(g, opt.init(p), p, 0.5)
    assert torch.equal(new["scale"], p["scale"])
    for k in ("w", "stack"):
        torch.testing.assert_close(new[k], p[k] - 0.5 * (0.1 * p[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(size=(7, 3)).astype(np.float32),
         "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jc, jn = j_clip(g, max_norm)
    c, nrm = clip_by_global_norm({"a": t(g["a"]), "b": {"c": t(g["b"]["c"])}},
                                 max_norm)
    np.testing.assert_allclose(float(nrm), float(jn), rtol=1e-6)
    _close(jc, c, "float32")
    if max_norm > float(jn):            # no clipping: bitwise the input
        assert np.array_equal(n(c["a"]), g["a"])


def _masked_setup(rng):
    params = {"blocks": {0: {"mlp": {"w": rng.normal(size=(8, 6))}},
                         1: {"moe": {"w": rng.normal(size=(3, 8, 6))}}},
              "norm": {"scale": rng.normal(size=(6,))}}
    params = {"blocks": {i: {k: {"w": v["w"].astype(np.float32)}
                             for k, v in b.items()}
                         for i, b in params["blocks"].items()},
              "norm": {"scale": params["norm"]["scale"].astype(np.float32)}}
    masks = {("blocks", 0, "mlp", "w"):
             (rng.uniform(size=(8, 6)) < 0.5).astype(np.float32)}
    for e in (0, 2):                      # expert 1 has no mask
        masks[("blocks", 1, "moe", "w", e)] = (
            rng.uniform(size=(8, 6)) < 0.5).astype(np.float32)
    return params, masks


def _to_port(tree):
    return {k: _to_port(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("inplace", [False, True])
def test_sparsity_preserving_matches_jax(inplace):
    rng = np.random.default_rng(3)
    params, masks = _masked_setup(rng)
    jopt = j_sparse(JAdamW(weight_decay=0.1, clip_norm=1.0),
                    {k: jnp.asarray(v) for k, v in masks.items()})
    opt = sparsity_preserving(AdamW(weight_decay=0.1, clip_norm=1.0),
                              {k: t(v) for k, v in masks.items()})
    jp = {k: v for k, v in params.items()}
    p = _to_port(params)
    js, s = jopt.init(jp), opt.init(p)
    for _ in range(3):
        g = {"blocks": {0: {"mlp": {"w": rng.normal(size=(8, 6))}},
                        1: {"moe": {"w": rng.normal(size=(3, 8, 6))}}},
             "norm": {"scale": rng.normal(size=(6,))}}
        g = {"blocks": {i: {k: {"w": v["w"].astype(np.float32)}
                            for k, v in b.items()}
                        for i, b in g["blocks"].items()},
             "norm": {"scale": g["norm"]["scale"].astype(np.float32)}}
        jp, js = jopt.update(g, js, jp, jnp.float32(1e-2))
        p, s = opt.update(_to_port(g), s, p, torch.tensor(1e-2),
                          inplace=inplace)
    _close(jp, p, "float32")
    w0 = n(p["blocks"][0]["mlp"]["w"])
    m0 = masks[("blocks", 0, "mlp", "w")] > 0.5
    assert (w0[m0] == 0).all() and (np.asarray(jp["blocks"][0]["mlp"]["w"])
                                    [m0] == 0).all()
    assert (w0[~m0] != 0).all()
    stack = n(p["blocks"][1]["moe"]["w"])
    for e in (0, 2):
        me = masks[("blocks", 1, "moe", "w", e)] > 0.5
        assert (stack[e][me] == 0).all()
        assert (np.asarray(jp["blocks"][1]["moe"]["w"])[e][me] == 0).all()
    assert (stack[1] != 0).all()           # the unmasked expert trains


def test_masks_by_path_refuses_a_stale_path():
    rng = np.random.default_rng(4)
    params, masks = _masked_setup(rng)
    p = _to_port(params)
    tm = {k: t(v) for k, v in masks.items()}
    assert masks_by_path(p, tm) is tm
    assert j_masks_by_path(params, masks) is masks
    stale = {("blocks", 7, "mlp", "w"): tm[("blocks", 0, "mlp", "w")]}
    with pytest.raises(KeyError):
        masks_by_path(p, stale)
    with pytest.raises(KeyError):
        j_masks_by_path(params, {("blocks", 7, "mlp", "w"): 0})
    with pytest.raises(KeyError):
        sparsity_preserving(AdamW(), stale).update(
            p, AdamW().init(p), p, 1e-3)
