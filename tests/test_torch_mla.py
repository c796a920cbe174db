"""The port's attention caches and MLA on the CPU against the JAX package:
the bf16 score scaling of ``_sdpa``, the int8 quantizers, ``gqa_decode``
with ``QuantGqaCache``, ``mla_forward``, ``mla_decode`` with ``MlaCache``
and ``QuantMlaCache`` over ragged per-slot depths, deepseek-v3 REDUCED's
``decode_step`` with both latent caches, the cache layouts, the engine's
slot write for all four cache kinds, and the prune / serve CLIs with
``--arch deepseek-v3-671b``.

Tolerances: the bf16 scale step, the int8 payloads and their scales
bit-equal; the whole bf16 ``_sdpa`` at bf16 tolerance (rtol 1.6e-2, two
bf16 steps, atol 1e-2); the ragged decodes rtol 2e-4 / atol 1e-5, as
tests/test_continuous_batching.py; ``mla_forward`` rtol/atol 1e-5 (fp32,
one layer); ``decode_step`` logits rtol/atol 1e-4 (as
tests/test_torch_model.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from repro_torch.serve.compressed import CompressionDowngrade  # noqa
from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

DS = "deepseek-v3-671b"
DEPTHS = [5, 2, 7]                  # ragged per-slot depths
RAGGED_TOL = {"rtol": 2e-4, "atol": 1e-5}
BF16_TOL = {"rtol": 1.6e-2, "atol": 1e-2}


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("D", [64, 128, 192])
def test_bf16_score_scale_bit_equal_to_jax(D):
    """The same bf16 scores divided by √D rounded to bf16, as JAX's
    ``scores / jnp.sqrt(D).astype(q.dtype)`` — not by the fp32 √D that a
    python float divisor applies (2 % of quotients differ at D = 128, 25 %
    at D = 192)."""
    s = np.random.default_rng(D).normal(size=4096).astype(np.float32) * 30
    want = jnp.asarray(s, jnp.bfloat16) / jnp.sqrt(D).astype(jnp.bfloat16)
    got = A._scale_scores(torch.from_numpy(s).to(torch.bfloat16), D)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), _bits(want))
    # fp32 scores: the same quotient as JAX's fp32 division
    want32 = jnp.asarray(s) / jnp.sqrt(D).astype(jnp.float32)
    np.testing.assert_array_equal(
        A._scale_scores(torch.from_numpy(s), D).numpy(), np.asarray(want32))


@pytest.mark.parametrize("D,Dv,H,Hkv", [(64, 64, 4, 2), (128, 128, 4, 2),
                                        (192, 128, 4, 4)])
def test_bf16_sdpa_matches_jax(D, Dv, H, Hkv):
    """The whole bf16 ``_sdpa`` (GQA groups; Dv ≠ Dqk as MLA's prefill)."""
    rng = np.random.default_rng(D)
    q = rng.normal(size=(2, 16, H, D)).astype(np.float32)
    k = rng.normal(size=(2, 16, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(2, 16, Hkv, Dv)).astype(np.float32)
    m = np.broadcast_to(np.tril(np.ones((16, 16), bool)), (2, 1, 16, 16))
    bf = jnp.bfloat16
    yj = JA._sdpa(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                  jnp.asarray(m), H, Hkv)
    tb = torch.bfloat16
    yt = A._sdpa(torch.from_numpy(q).to(tb), torch.from_numpy(k).to(tb),
                 torch.from_numpy(v).to(tb), torch.from_numpy(m.copy()), H,
                 Hkv)
    assert yt.dtype == tb and yt.shape == (2, 16, H, Dv)
    np.testing.assert_allclose(n(yt), np.asarray(yj, np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    """Per-(slot, kv-head) int8: payload and scales bit-equal, ties
    rounded half to even (a row whose scale is exactly 1 holds ±k.5)."""
    x = np.random.default_rng(1).normal(size=(3, 1, 2, 16)).astype(
        np.float32) * 4
    x[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    x[0, 0, 0, 6:] = 0.0
    x[1, 0, 1] = 0.0                            # all-zero head: 1e-8 floor
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = JA._quantize_kv(jx)
    qt, st = A._quantize_kv(tx)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert list(qt[0, 0, 0, :6]) == [127, 2, -4, 0, 0, 2]


@pytest.mark.parametrize("dkv", [512, 32, 36, 6, 7])
def test_mla_group_quantizer_bit_equal(dkv):
    """The latent's per-channel-group int8 (the expression inside JAX's
    ``mla_decode``): group size, payload and scales bit-equal."""
    assert A.MLA_INT8_GROUP == JA.MLA_INT8_GROUP
    g = A._mla_group(dkv)
    assert g == JA._mla_group(dkv)
    B, ng = 3, dkv // g
    c = np.random.default_rng(dkv).normal(size=(B, 1, dkv)).astype(
        np.float32) * np.linspace(0.01, 5, dkv, dtype=np.float32)
    grouped = jnp.asarray(c).reshape(B, 1, ng, g)
    sj = jnp.maximum(jnp.max(jnp.abs(grouped), axis=-1), 1e-8) / 127.0
    qj = jnp.clip(jnp.round(grouped / sj[..., None]), -127, 127).astype(
        jnp.int8).reshape(B, 1, dkv)
    qt, st = A._quantize_kv(torch.from_numpy(c).reshape(B, 1, ng, g))
    np.testing.assert_array_equal(qt.reshape(B, 1, dkv).numpy(),
                                  np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# --------------------------------------------------------------------------
# ragged per-slot decode over caches built by the JAX package
# --------------------------------------------------------------------------
def _port_cache(jcache, cls):
    """A JAX cache (numpy leaves) → the port's cache dataclass on the CPU;
    int32 positions and lengths become the port's int64."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcache, f.name)
        if f.name == "window":
            kw[f.name] = int(v)
            continue
        a = np.array(v)
        kw[f.name] = torch.from_numpy(a.astype(np.int64) if a.dtype ==
                                      np.int32 else a)
    return cls(**kw)


def _ragged(cfg, jparams, jdecode, tdecode, jinit, cls):
    """Rows decoded alone to DEPTHS by JAX, stacked, then one (B,) decode at
    pos = DEPTHS on both sides from that same cache, outputs held at the
    ragged tolerance → (JAX cache before, JAX cache after, port cache
    after)."""
    rng = np.random.default_rng(0)
    d = cfg.d_model
    rows = []
    for depth in DEPTHS:
        c = jinit(1)
        for t in range(depth):
            x = rng.normal(size=(1, 1, d)).astype(np.float32)
            _, c = jdecode(jparams, jnp.asarray(x), t, c)
        rows.append(c)
    jcache = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=0), *rows)
    tcache = _port_cache(jcache, cls)
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    x = rng.normal(size=(len(DEPTHS), 1, d)).astype(np.float32)
    pos = np.asarray(DEPTHS, np.int32)
    yj, jnew = jdecode(jparams, jnp.asarray(x), jnp.asarray(pos), jcache)
    yt, tnew = tdecode(tparams, torch.from_numpy(x),
                       torch.from_numpy(pos.astype(np.int64)), tcache)
    assert tnew is tcache                        # written in place
    np.testing.assert_allclose(n(yt), np.asarray(yj), **RAGGED_TOL)
    return jcache, jnew, tnew


def _check_written(jold, jnew, tnew, cls, slot_axis_fields):
    """Every slot but the one each row wrote is exactly JAX's; the written
    slot's payload within one int8 step (its scale and float values at the
    ragged tolerance); positions and lengths exact."""
    rows = np.arange(len(DEPTHS))
    for f in dataclasses.fields(cls):
        if f.name == "window":
            continue
        got = getattr(tnew, f.name).numpy()
        want = np.asarray(getattr(jnew, f.name))
        if f.name not in slot_axis_fields:
            np.testing.assert_array_equal(got, want)
            continue
        keep = np.ones(got.shape[:2], bool)
        keep[rows, DEPTHS] = False
        np.testing.assert_array_equal(got[keep], np.asarray(
            getattr(jold, f.name))[keep])
        new_g, new_w = got[rows, DEPTHS], want[rows, DEPTHS]
        if got.dtype == np.int8:
            assert np.abs(new_g.astype(int) - new_w).max() <= 1
        else:
            np.testing.assert_allclose(new_g, new_w, **RAGGED_TOL)


def test_gqa_decode_int8_ragged_matches_jax():
    cfg = j_get_config("tinyllama-1.1b", reduced=True).replace(
        kv_cache_dtype="int8")
    tcfg = get_config("tinyllama-1.1b", reduced=True).replace(
        kv_cache_dtype="int8")
    jp = JA.gqa_params(jax.random.PRNGKey(3), cfg)
    theta = cfg.rope_theta
    jold, jnew, tnew = _ragged(
        cfg, jp,
        lambda p, x, pos, c: JA.gqa_decode(p, cfg, x, pos, c, theta=theta),
        lambda p, x, pos, c: A.gqa_decode(p, tcfg, x, pos, c, theta=theta),
        lambda b: JA.gqa_cache_init(cfg, b, 12), A.QuantGqaCache)
    assert isinstance(jnew, JA.QuantGqaCache)
    _check_written(jold, jnew, tnew, A.QuantGqaCache,
                   ("k", "v", "k_scale", "v_scale"))


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_mla_decode_ragged_matches_jax(kv_dtype):
    """The absorbed decode: W_k folded into q, W_v after the attention,
    over MlaCache / QuantMlaCache; length = pos + 1 for every row."""
    cfg = j_get_config("deepseek-v3-671b", reduced=True).replace(
        kv_cache_dtype=kv_dtype)
    tcfg = get_config("deepseek-v3-671b", reduced=True).replace(
        kv_cache_dtype=kv_dtype)
    cls = A.QuantMlaCache if kv_dtype else A.MlaCache
    jp = JA.mla_params(jax.random.PRNGKey(4), cfg)
    jold, jnew, tnew = _ragged(
        cfg, jp, lambda p, x, pos, c: JA.mla_decode(p, cfg, x, pos, c),
        lambda p, x, pos, c: A.mla_decode(p, tcfg, x, pos, c),
        lambda b: JA.mla_cache_init(cfg, b, 12), cls)
    assert type(jnew).__name__ == cls.__name__
    _check_written(jold, jnew, tnew, cls, ("c_kv", "c_scale", "k_rope"))
    assert tnew.length.tolist() == [d + 1 for d in DEPTHS]


def test_mla_forward_matches_jax():
    """Prefill MLA: c_kv expanded through wkv_b to per-head k/v, causal
    ``_sdpa`` with Dqk = nope + rope ≠ Dv; and its tape."""
    cfg = j_get_config("deepseek-v3-671b", reduced=True)
    jp = JA.mla_params(jax.random.PRNGKey(5), cfg)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    x = np.random.default_rng(5).normal(size=(2, 9, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jtape, ttape = {}, {}
    yj = JA.mla_forward(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                        tape=jtape)
    yt = A.mla_forward(tp, get_config("deepseek-v3-671b", reduced=True),
                       torch.from_numpy(x),
                       torch.from_numpy(pos.astype(np.int64)), tape=ttape)
    np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=1e-5, atol=1e-5)
    assert list(ttape) == list(jtape) == [
        (nm, "w") for nm in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")]
    for k, v in jtape.items():
        np.testing.assert_allclose(n(ttape[k]), np.asarray(v), rtol=1e-5,
                                   atol=1e-5)


KINDS = [("tinyllama-1.1b", "", "GqaCache"),
         ("tinyllama-1.1b", "int8", "QuantGqaCache"),
         ("deepseek-v3-671b", "", "MlaCache"),
         ("deepseek-v3-671b", "int8", "QuantMlaCache")]


@pytest.mark.parametrize("arch,kv_dtype,kind", KINDS)
def test_init_cache_layout_matches_jax(arch, kv_dtype, kind):
    """Each layer's cache: the JAX kind, field names, shapes and dtypes
    (positions and lengths int64 in the port, int32 in JAX)."""
    jm = j_build(j_get_config(arch, reduced=True).replace(
        kv_cache_dtype=kv_dtype))
    tm = build_model(get_config(arch, reduced=True).replace(
        kv_cache_dtype=kv_dtype), device="cpu")
    jc, tc = jm.init_cache(2, 10), tm.init_cache(2, 10)
    assert list(tc) == list(jc)
    for i, c in tc.items():
        assert type(c).__name__ == type(jc[i]).__name__ == kind
        for f in dataclasses.fields(c):
            got, want = getattr(c, f.name), getattr(jc[i], f.name)
            if f.name == "window":
                assert got == want
                continue
            assert tuple(got.shape) == tuple(want.shape), f.name
            want_dt = "int64" if str(want.dtype) == "int32" else \
                str(want.dtype)
            assert str(got.dtype).removeprefix("torch.") == want_dt, f.name
            np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("arch,kv_dtype,kind", KINDS)
def test_engine_write_slot_copies_every_field(arch, kv_dtype, kind):
    """``_write_slot`` copies every tensor field of a B=1 row cache into
    row ``slot`` of the resident cache and leaves the other rows as they
    were."""
    cfg = get_config(arch, reduced=True).replace(kv_cache_dtype=kv_dtype)
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, None, ServeConfig(batch_slots=3, max_len=8))
    gen = torch.Generator().manual_seed(0)

    def fill(cache):
        for c in cache.values():
            for f in dataclasses.fields(c):
                t = getattr(c, f.name)
                if not isinstance(t, torch.Tensor):
                    continue
                if t.dtype.is_floating_point:
                    t.copy_(torch.randn(t.shape, generator=gen))
                else:
                    t.copy_(torch.randint(-100, 100, t.shape, generator=gen))
        return cache

    eng._cache = fill(model.init_cache(3, 8))
    before = {i: {f.name: getattr(c, f.name).clone()
                  for f in dataclasses.fields(c)
                  if isinstance(getattr(c, f.name), torch.Tensor)}
              for i, c in eng._cache.items()}
    row = fill(model.init_cache(1, 8))
    eng._write_slot(row, 1)
    fields = 0
    for i, c in eng._cache.items():
        assert type(c).__name__ == kind
        for name, old in before[i].items():
            now = getattr(c, name)
            assert torch.equal(now[1], getattr(row[i], name)[0]), name
            assert torch.equal(now[0], old[0]) and torch.equal(now[2],
                                                               old[2])
            fields += 1
    per_layer = {"GqaCache": 3, "QuantGqaCache": 5, "MlaCache": 3,
                 "QuantMlaCache": 4}[kind]
    assert fields == per_layer * cfg.num_layers


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_deepseek_decode_step_matches_jax(kv_dtype):
    """Token-by-token decode through the absorbed MLA with (B,) positions
    (row 1 three tokens behind row 0), both latent cache kinds."""
    jmodel = j_build(j_get_config(DS, reduced=True).replace(
        kv_cache_dtype=kv_dtype))
    tmodel = build_model(get_config(DS, reduced=True).replace(
        kv_cache_dtype=kv_dtype), device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 8))
    jc, tc = jmodel.init_cache(2, 12), tmodel.init_cache(2, 12)
    for step in range(4):
        pos = np.array([step + 3, step], np.int32)
        tok = tokens[np.arange(2), pos][:, None]
        lj, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos))
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    assert type(tc[0]).__name__ == type(jc[0]).__name__


def test_prune_and_serve_clis_on_cpu(monkeypatch, capsys):
    """``--arch deepseek-v3-671b`` through the registry: the prune CLI and
    the serve CLI (prune, compress with the wkv_b downgrades, serve) at
    REDUCED size on the CPU."""
    from repro_torch.launch import prune as lprune
    from repro_torch.launch import serve as lserve

    monkeypatch.setattr("sys.argv", [
        "prune", "--arch", DS, "--pattern", "nm", "--device", "cpu"])
    lprune.main()
    assert '"arch": "deepseek-v3-671b"' in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", DS, "--nm", "--device", "cpu", "--requests",
        "2", "--prompt-len", "4", "--max-new", "3", "--slots", "2"])
    with pytest.warns(CompressionDowngrade):
        lserve.main()
    out = capsys.readouterr().out
    assert "compressed weight bytes: 0.562 of dense" in out
    assert "2 requests, 6 tokens" in out
