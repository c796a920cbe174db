"""The port's gemma3-1b on the CPU against the JAX package, on its REDUCED
config (6 layers, window 8, layer 5 global, local θ 10 000, head_dim 16,
one kv head, qk-norm, tanh gelu, tied embeddings): the configuration,
forward logits and the calibration tape, decode_step over the sliding
window's ring past its wrap, the greedy tokens of the contiguous and the
paged engine (the mixed layout: five rings beside one paged layer), and
Thanos 2:4 ``prune_model`` from the same params and calibration tokens.

Tolerances: forward logits rtol/atol 1e-5 (fp32); the tape's inputs and
decode logits rtol/atol 1e-4 (as tests/test_torch_model.py: the tape holds
every layer's intermediates, the decode 20 sequential steps);
greedy tokens, masks and pager statistics exactly; weights rtol 5e-3 /
atol 5e-4 (as tests/test_torch_slice.py)."""
from __future__ import annotations

import dataclasses

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
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.schedule import get_path, prune_model  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

ARCH = "gemma3-1b"
W_TOL = {"rtol": 5e-3, "atol": 5e-4}


@pytest.fixture(scope="module")
def pair():
    jmodel = j_build(j_get_config(ARCH, reduced=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config(ARCH, reduced=True), device="cpu")
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams


def test_config_registered_and_matches():
    assert ARCH in ARCHS
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced=reduced)) == \
            dataclasses.asdict(j_get_config(ARCH, reduced=reduced))
    full = get_config(ARCH)
    glob = [i for i in range(full.num_layers) if full.layer_is_global(i)]
    assert glob == [5, 11, 17, 23]             # 4 global : 22 local layers
    cfg = get_config(ARCH, reduced=True)
    assert [cfg.layer_is_global(i) for i in range(6)] == [False] * 5 + [True]
    assert (cfg.sliding_window, cfg.rope_theta_local, cfg.tie_embeddings,
            cfg.qk_norm, cfg.act) == (8, 10_000.0, True, True, "gelu")


def test_forward_logits_and_tape_match_jax(pair):
    """12 tokens, past the window of 8: the local layers' banded mask and
    local θ, the global layer's full mask."""
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(0).integers(0, 512, size=(2, 12))
    jtape, ttape = {}, {}
    lj = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                        tape=jtape)
    lt = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)},
                        tape=ttape)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-5, atol=1e-5)
    assert list(ttape) == list(jtape)
    for k, v in jtape.items():
        np.testing.assert_allclose(n(ttape[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-4)


def test_decode_step_through_the_ring_matches_jax(pair):
    """20 positions of B = 2 rows (row 1 four behind) through the ring of
    8 slots, which wraps twice; per-slot (B,) positions."""
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 24))
    jc, tc = jmodel.init_cache(2, 32), tmodel.init_cache(2, 32)
    assert [c.window for c in tc.values()] == [8] * 5 + [0]
    for step in range(20):
        pos = np.array([step + 4, step], np.int32)
        tok = tokens[np.arange(2), pos][:, None]
        lj, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos))
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)


def _serve(engine_cls, req_cls, cfg_cls, model, params, **kw):
    """Prompts of 10–13 tokens (past the window) and 3–8 new tokens on 2
    slots → (tokens by uid, stats)."""
    eng = engine_cls(model, params, cfg_cls(batch_slots=2, max_len=32, **kw))
    rng = np.random.default_rng(3)
    for uid in range(4):
        eng.submit(req_cls(uid, rng.integers(0, 512, size=10 + uid).astype(
            np.int32), max_new=3 + int(rng.integers(0, 6))))
    return {r.uid: r.out for r in eng.run()}, eng


def test_engine_tokens_match_jax_contiguous_and_paged(pair):
    """Greedy tokens over > 8 positions, so every local ring wraps: the
    port's contiguous and paged engines against JAX's contiguous and paged
    engines; paged keeps the five rings beside one paged layer, and prefix
    reuse is off."""
    jmodel, jparams, tmodel, tparams = pair
    out_j, _ = _serve(JEngine, JRequest, JServeConfig, jmodel, jparams)
    out_t, _ = _serve(ServingEngine, Request, ServeConfig, tmodel, tparams)
    assert out_t == out_j
    paged = dict(paged=True, page_size=8, debug_checks=True)
    pout_j, jeng = _serve(JEngine, JRequest, JServeConfig, jmodel, jparams,
                          **paged)
    pout_t, teng = _serve(ServingEngine, Request, ServeConfig, tmodel,
                          tparams, **paged)
    assert pout_t == pout_j == out_t
    assert teng.stats == {k: jeng.stats[k] for k in teng.stats}
    assert teng.pager.prefix is None and jeng.pager.prefix is None
    assert [type(c).__name__ for c in teng._cache.values()] == \
        ["GqaCache"] * 5 + ["PagedGqaCache"]
    assert max(len(v) + 10 for v in out_t.values()) > 8


def test_thanos_masks_match_jax(pair):
    """Thanos 2:4 block by block from the same params and the JAX
    calibration tokens: every mask exactly, the weights within W_TOL."""
    jmodel, jparams, tmodel, tparams = pair
    jcfg = j_get_config(ARCH, reduced=True)
    jbatches = calibration_batches(jcfg, num_samples=8, seq_len=16, batch=4)
    cell = dict(method="thanos", pattern="nm", n=2, m=4, block_size=64)
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches,
                                  JPruneConfig(**cell))
    tbatches = [{"tokens": torch.from_numpy(np.array(b["tokens"]))}
                for b in jbatches]
    tpruned, trep = prune_model(tparams, ModelAdapter(tmodel), tbatches,
                                PruneConfig(**cell))
    assert list(trep.masks) == list(jrep.masks)
    assert len(trep.masks) == 7 * jcfg.num_layers
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        assert check_nm(trep.masks[path].T, 2, 4)
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
    assert trep.mean_sparsity() == jrep.mean_sparsity() == 0.5


@pytest.mark.slow
def test_full_config_paged_layout_and_one_step():
    """The published widths on the CPU (bf16, all 26 layers): the paged
    cache holds 4 page pools and 22 rings of 512, and one paged decode
    step gives finite logits of the vocabulary's width."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_paged_cache(2, num_pages=1 + 2 * 40, page_size=16,
                                   pages_per_slot=40)
    kinds = [type(c).__name__ for c in cache.values()]
    assert kinds.count("PagedGqaCache") == 4 and kinds.count("GqaCache") == 22
    assert all(c.k.shape[1] == 512 for c in cache.values()
               if type(c).__name__ == "GqaCache")
    for c in cache.values():
        if type(c).__name__ == "PagedGqaCache":
            c.table = torch.arange(1, 81).reshape(2, 40)
    with torch.no_grad():
        lg, _ = model.decode_step(params, cache, torch.tensor([[1], [2]]),
                                  torch.tensor([0, 0]))
    assert lg.shape == (2, 1, cfg.vocab_size) and bool(
        torch.isfinite(lg).all())
