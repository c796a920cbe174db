"""The port's deepseek-v3 slice on the CPU against the JAX package, on
deepseek-v3-671b REDUCED (fp32: MLA in every layer, 1 dense layer and 2 MoE
layers with a shared expert): forward logits and the tape, Thanos 2:4
``prune_model`` from the same params and the JAX calibration tokens, the
packs and the wkv_b downgrade of ``compress_params``, the engine against
the JAX engine and the decompressed-dense oracle with both latent cache
kinds (``MlaCache``, ``QuantMlaCache``), and the port's copy of
``test_int8_kv_cache_argmax_preserved``.  The model's decode_step and the
CLIs are in tests/test_torch_mla.py.

Tolerances: logits rtol/atol 1e-4 (as tests/test_torch_model.py); masks,
index bytes and greedy tokens exactly; weights rtol 5e-3 / atol 5e-4 (as
tests/test_torch_slice.py); int8 vs full-precision cache: argmax agreement
≥ 0.5 and max |Δlogit| < 1.0 (as tests/test_serving_optimizations.py).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro.serve.compressed import \
    CompressionDowngrade as JDowngrade  # noqa: E402
from repro.serve.compressed import compress_params as j_compress  # noqa
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.schedule import get_path, prune_model  # noqa: E402
from repro_torch.core.sparsity import (NmCompressed,  # noqa: E402
                                       NmStackedCompressed)
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from repro_torch.serve.compressed import (CompressionDowngrade,  # noqa: E402
                                          compress_params,
                                          compressed_bytes,
                                          decompress_params)
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = {"rtol": 1e-4, "atol": 1e-4}
W_TOL = {"rtol": 5e-3, "atol": 5e-4}
MLA_LINEARS = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")


def _carry(tree):
    return params_from_numpy(jax_tree_to_numpy(tree), device="cpu")


def test_config_registered_and_matches():
    assert ARCH in ARCHS
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced=reduced)) == \
            dataclasses.asdict(j_get_config(ARCH, reduced=reduced))
    cfg = get_config(ARCH, reduced=True)
    assert cfg.uses_mla and [cfg.layer_is_moe(i) for i in range(3)] == \
        [False, True, True] and cfg.num_shared_experts == 1


@pytest.fixture(scope="module")
def pair():
    jmodel = j_build(j_get_config(ARCH, reduced=True))
    tmodel = build_model(get_config(ARCH, reduced=True), device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, tmodel, _carry(jparams)


def test_mla_tree_carries_across(pair):
    """``params_from_numpy`` carries the MLA tree — its five linear dicts
    and the q_norm / kv_norm scales — with the JAX paths and values."""
    _, jparams, _, tparams = pair
    for i in range(3):
        ja, ta = jparams["blocks"][i]["attn"], tparams["blocks"][i]["attn"]
        assert set(ta) == set(ja) == set(MLA_LINEARS) | {"q_norm", "kv_norm"}
        for k in ja:
            leaf = "scale" if k.endswith("norm") else "w"
            np.testing.assert_array_equal(n(ta[k][leaf]),
                                          np.asarray(ja[k][leaf]))
    assert "shared" in tparams["blocks"][1]["moe"]


def test_forward_loss_and_tape_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(0).integers(0, 512, size=(2, 10))
    jt, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    np.testing.assert_allclose(n(tmodel.forward(tparams, {"tokens": tt})),
                               np.asarray(jmodel.forward(jparams,
                                                         {"tokens": jt})),
                               **TOL)
    np.testing.assert_allclose(float(tmodel.loss(tparams, {"tokens": tt})),
                               float(jmodel.loss(jparams, {"tokens": jt})),
                               rtol=1e-5)
    ja, ta = JAdapter(jmodel), ModelAdapter(tmodel)
    for i in (0, 1):                            # the dense and an MoE block
        _, capj = ja.block_apply(jparams, i, ja.prepare(
            jparams, {"tokens": jt}), capture=True)
        _, capt = ta.block_apply(tparams, i, ta.prepare(
            tparams, {"tokens": tt}), capture=True)
        paths = ta.block_linear_paths(tparams, i)
        assert list(capt) == list(capj) == paths
        assert paths[:5] == [("blocks", i, "attn", nm, "w")
                             for nm in MLA_LINEARS]
        for path, vj in capj.items():
            vt = capt[path]
            if isinstance(vj, tuple):
                np.testing.assert_array_equal(n(vt[1]), np.asarray(vj[1]))
                vt, vj = vt[0], vj[0]
            np.testing.assert_allclose(n(vt), np.asarray(vj), **TOL)


@pytest.fixture(scope="module")
def pruned_pair(pair):
    jmodel, jparams, tmodel, tparams = pair
    jbatches = calibration_batches(jmodel.cfg, num_samples=8, seq_len=32,
                                   batch=8)
    jpruned, jrep = j_prune_model(
        jparams, JAdapter(jmodel), jbatches,
        JPruneConfig(method="thanos", pattern="nm", n=2, m=4, block_size=16))
    tbatches = [{"tokens": torch.from_numpy(np.array(b["tokens"]))}
                for b in jbatches]
    tpruned, trep = prune_model(
        tparams, ModelAdapter(tmodel), tbatches,
        PruneConfig(method="thanos", pattern="nm", n=2, m=4, block_size=16))
    return (jmodel, jpruned, jrep), (tmodel, tpruned, trep)


def test_prune_model_matches_jax(pruned_pair):
    """Every MLA linear (wkv_b too), the dense MLP, every expert slice and
    the shared expert: masks equal, weights within 5e-3 / 5e-4."""
    (_, jpruned, jrep), (tmodel, tpruned, trep) = pruned_pair
    cfg = tmodel.cfg
    assert list(trep.masks) == list(jrep.masks)
    assert len(trep.layers) == 3 * 5 + 3 + 2 * (3 * cfg.num_experts + 3)
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        assert check_nm(trep.masks[path].T, 2, 4)
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
    for rt, rj in zip(trep.layers, jrep.layers):
        assert (rt.path, rt.params, rt.fallback) == \
            (rj.path, rj.params, rj.fallback)


def _masks(jrep):
    return {k: torch.from_numpy(np.array(v)) for k, v in jrep.masks.items()}


@pytest.fixture(scope="module")
def jcomp(pruned_pair):
    """The JAX package's compressed tree of the JAX-pruned params (packed
    once: it takes seconds on the CPU) and its downgrade messages."""
    (_, jpruned, jrep), _ = pruned_pair
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        tree = j_compress(jpruned, jrep.masks, 2, 4)
    return tree, [str(w.message) for w in jw
                  if issubclass(w.category, JDowngrade)]


def test_packs_and_wkv_b_downgrade_match_jax(pruned_pair, jcomp):
    """The port packs the JAX-pruned tree into the JAX package's bytes:
    every linear but wkv_b compressed, one CompressionDowngrade per layer
    for wkv_b (which serves dense, pruned), an error under strict=True."""
    (_, jpruned, jrep), _ = pruned_pair
    jd = jcomp[1]
    jcomp = _carry(jcomp[0])
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tcomp = compress_params(_carry(jpruned), _masks(jrep), 2, 4)
    td = [str(w.message) for w in tw
          if issubclass(w.category, CompressionDowngrade)]
    assert td == jd and len(td) == 3
    assert all(f"'blocks/{i}/attn/wkv_b/w'" in td[i] for i in range(3))
    leaves = 0
    for i in range(3):
        for nm in MLA_LINEARS:
            a = tcomp["blocks"][i]["attn"][nm]["w"]
            b = jcomp["blocks"][i]["attn"][nm]["w"]
            if nm == "wkv_b":
                assert isinstance(a, torch.Tensor) and torch.equal(a, b)
                assert float((a == 0).float().mean()) >= 0.5
                continue
            assert isinstance(a, NmCompressed)
            assert torch.equal(a.values, b.values) and \
                torch.equal(a.indices, b.indices)
            leaves += 1
        ffn = tcomp["blocks"][i]["mlp" if i == 0 else "moe"]
        jffn = jcomp["blocks"][i]["mlp" if i == 0 else "moe"]
        for nm in ("gate", "up", "down"):
            a, b = ffn[nm]["w"], jffn[nm]["w"]
            assert isinstance(a, NmStackedCompressed if i else NmCompressed)
            assert torch.equal(a.values, b.values) and \
                torch.equal(a.indices, b.indices)
            leaves += 1
    assert leaves == 3 * 4 + 3 * 3
    assert compressed_bytes(tcomp) == compressed_bytes(jcomp)
    with pytest.raises(ValueError, match="wkv_b"):
        compress_params(_carry(jpruned), _masks(jrep), 2, 4, strict=True)


def _serve(engine_cls, req_cls, cfg_cls, model, params):
    eng = engine_cls(model, params, cfg_cls(batch_slots=2, max_len=16))
    rng = np.random.default_rng(3)
    for uid, (plen, new) in enumerate([(5, 4), (3, 6), (7, 2)]):
        eng.submit(req_cls(uid, rng.integers(0, 512, size=plen).astype(
            np.int32), max_new=new))
    return [r.out for r in eng.run()]


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_engine_tokens_match_jax_and_dense_oracle(jcomp, kv_dtype):
    """Compressed-resident serving (wkv_b dense) with each latent cache:
    the port's tokens equal the JAX engine's on the same compressed tree
    and equal serving the decompressed tree."""
    jmodel = j_build(j_get_config(ARCH, reduced=True).replace(
        kv_cache_dtype=kv_dtype))
    tmodel = build_model(get_config(ARCH, reduced=True).replace(
        kv_cache_dtype=kv_dtype), device="cpu")
    jcomp = jcomp[0]
    tcomp = _carry(jcomp)
    out_j = _serve(JEngine, JRequest, JServeConfig, jmodel, jcomp)
    out_c = _serve(ServingEngine, Request, ServeConfig, tmodel, tcomp)
    out_d = _serve(ServingEngine, Request, ServeConfig, tmodel,
                   decompress_params(tcomp))
    assert out_c == out_d == out_j
    assert [len(o) for o in out_c] == [4, 6, 2]


def _greedy_chain(model, params, prompt, steps=6):
    """tests/test_serving_optimizations.py's chain: the prompt decoded
    token by token into a fresh cache → the last logits."""
    B = prompt.shape[0]
    cache = model.init_cache(B, prompt.shape[1] + steps + 2)
    logits = None
    for t in range(prompt.shape[1]):
        logits, cache = model.decode_step(params, cache, prompt[:, t:t + 1],
                                          t)
    return logits


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", ARCH])
def test_int8_kv_cache_argmax_preserved(arch):
    """The port's copy of the JAX test, on the JAX init carried across:
    QuantGqaCache (tinyllama) and QuantMlaCache (deepseek)."""
    jcfg = j_get_config(arch, reduced=True)
    params = _carry(j_build(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config(arch, reduced=True)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6)))
    model_q = build_model(cfg.replace(kv_cache_dtype="int8"), device="cpu")
    lg_f = _greedy_chain(build_model(cfg, device="cpu"), params, prompt)
    lg_q = _greedy_chain(model_q, params, prompt)
    assert type(model_q.init_cache(1, 4)[0]).__name__ == (
        "QuantMlaCache" if cfg.uses_mla else "QuantGqaCache")
    agree = float((lg_f.argmax(-1) == lg_q.argmax(-1)).float().mean())
    assert agree >= 0.5
    assert float((lg_f - lg_q).abs().max()) < 1.0
