"""The port's zamba2 (``HybridLM``: a Mamba2 backbone with two alternating
shared attention + MLP sets) on the CPU against the JAX package, on
zamba2-7b's REDUCED config with 8 layers and a shared block every 2nd
layer, so each shared set runs at two sites (1 and 5, 3 and 7): forward
logits and the tape, decode against JAX's decode and against the forward,
the int8 shared caches, Thanos 2:4 ``prune_model`` (each shared set
pruned once, at its last site, from the Hessian of both sites) and the
greedy tokens of the continuous-batching engine on 2 and 4 slots.

Tolerances: logits rtol/atol 1e-4 (the Mamba2 recurrence: an associative
scan in JAX, a sequential loop here); decode against decode 1e-4; decode
against forward 2e-2 (tests/test_archs_smoke.py's bound); the int8 caches
max |Δlogit| < 1.0 (tests/test_serving_optimizations.py's bound); masks
and greedy tokens exactly; weights rtol 5e-3 / atol 5e-4 (as
tests/test_torch_slice.py); bf16 rtol 2e-2, atol 1e-2 × max|y|."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.schedule import get_path, prune_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.hybrid import HybridLM  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from repro_torch.serve.compressed import compress_params  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

ARCH = "zamba2-7b"
W_TOL = {"rtol": 5e-3, "atol": 5e-4}
SHAPE = dict(num_layers=8, attn_every=2)


def _cfgs(**kw):
    return (j_registry.get_config(ARCH, reduced=True).replace(**SHAPE, **kw),
            registry.get_config(ARCH, reduced=True).replace(**SHAPE, **kw))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams


def test_registry_and_configs_match_jax():
    """The port's archs are the JAX registry's 10, in its order, and the
    three configs of this family field for field."""
    assert registry.ARCHS == tuple(a for a in j_registry.ARCHS
                                   if a in registry.ARCHS)
    assert len(registry.ARCHS) == 10
    for arch in ("zamba2-7b", "xlstm-1.3b", "whisper-medium"):
        for reduced in (False, True):
            assert dataclasses.asdict(
                registry.get_config(arch, reduced=reduced)) == \
                dataclasses.asdict(j_registry.get_config(arch,
                                                         reduced=reduced))
    kinds = {a: type(build_model(registry.get_config(a, reduced=True),
                                 device="cpu")).__name__
             for a in ("zamba2-7b", "xlstm-1.3b", "whisper-medium")}
    assert kinds == {"zamba2-7b": "HybridLM", "xlstm-1.3b": "XlstmLM",
                     "whisper-medium": "EncDecLM"}
    assert type(build_model(registry.get_config("tinyllama-1.1b").replace(
        family="vlm"), device="cpu")).__name__ == "TransformerLM"
    with pytest.raises(ValueError, match="unknown family"):
        build_model(registry.get_config("tinyllama-1.1b").replace(
            family="rnn"), device="cpu")


def test_shared_sites_and_paths(pair):
    jmodel, jparams, tmodel, tparams = pair
    assert tmodel._shared_points() == jmodel._shared_points() == [1, 3, 5, 7]
    assert [tmodel._which(i) for i in (1, 3, 5, 7)] == [0, 1, 0, 1]
    for i in range(8):
        assert tmodel.block_linear_paths(tparams, i) == \
            jmodel.block_linear_paths(jparams, i)
    shared = [p for i in range(8) for p in tmodel.block_linear_paths(
        tparams, i) if p[0] == "shared"]
    assert len(shared) == len(set(shared)) == 14


def test_forward_logits_and_tape_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(0).integers(0, 512, size=(2, 12))
    jtape, ttape = {}, {}
    lj = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                        tape=jtape)
    lt = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)},
                        tape=ttape)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4, atol=1e-4)
    assert list(ttape) == list(jtape)
    for k, v in jtape.items():
        np.testing.assert_allclose(n(ttape[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-4)
    # JAX's loss_from_carry on the logits above: its CE on shifted tokens
    labels = jnp.pad(jnp.asarray(tokens)[:, 1:], ((0, 0), (0, 1)),
                     constant_values=-1)
    lossj = float(JL.cross_entropy(lj, labels))
    losst = float(tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)}))
    assert abs(lossj - losst) < 1e-4


def test_decode_matches_jax_and_forward(pair):
    """12 positions of B = 2 rows (row 1 three behind) through the window-8
    shared caches, which wrap; per-slot (B,) positions."""
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 16))
    jc, tc = jmodel.init_cache(2, 16), tmodel.init_cache(2, 16)
    assert list(tc) == ["mamba", "shared"] and len(tc["shared"]) == 4
    assert [c.window for c in tc["shared"].values()] == [8] * 4
    for step in range(12):
        pos = np.array([step + 3, step], np.int32)
        tok = tokens[np.arange(2), pos][:, None]
        lj, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos))
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    # one row decoded from position 0 against the teacher-forced forward
    cache = tmodel.init_cache(1, 16)
    outs = []
    for s in range(6):
        lg, cache = tmodel.decode_step(tparams, cache,
                                       torch.from_numpy(tokens[:1, s:s + 1]),
                                       s)
        outs.append(lg[:, 0])
    full = tmodel.forward(tparams, {"tokens": torch.from_numpy(
        tokens[:1, :6])})
    np.testing.assert_allclose(n(torch.stack(outs, 1)), n(full), rtol=2e-2,
                               atol=2e-2)


def test_int8_shared_caches(pair):
    """kv_cache_dtype int8 quantizes the shared blocks' caches only; after
    10 teacher-forced positions the logits stay within 1.0 of the fp32
    caches' and of JAX's int8 model."""
    jmodel, jparams, tmodel, tparams = pair
    jcfg8, tcfg8 = _cfgs(kv_cache_dtype="int8")
    jm8, tm8 = j_build(jcfg8), HybridLM(tcfg8, device="cpu")
    prompt = np.random.default_rng(2).integers(0, 512, size=(2, 10))

    def chain(model, params, to):
        cache = model.init_cache(2, 16)
        for s in range(10):
            lg, cache = model.decode_step(params, cache,
                                          to(prompt[:, s:s + 1]), s)
        return lg, cache

    lt, _ = chain(tmodel, tparams, torch.from_numpy)
    lt8, c8 = chain(tm8, tparams, torch.from_numpy)
    lj8, _ = chain(jm8, jparams, lambda a: jnp.asarray(a, jnp.int32))
    assert {type(c).__name__ for c in c8["shared"].values()} == \
        {"QuantGqaCache"}
    assert {type(c).__name__ for c in c8["mamba"].values()} == {"MambaCache"}
    assert float((lt8 - lt).abs().max()) < 1.0
    np.testing.assert_allclose(n(lt8), np.asarray(lj8), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pruned(pair):
    jmodel, jparams, tmodel, tparams = pair
    jcfg = _cfgs()[0]
    jbatches = calibration_batches(jcfg, num_samples=8, seq_len=16, batch=4)
    cell = dict(method="thanos", pattern="nm", n=2, m=4, block_size=64)
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches,
                                  JPruneConfig(**cell))
    tbatches = [{"tokens": torch.from_numpy(np.array(b["tokens"]))}
                for b in jbatches]
    tpruned, trep = prune_model(tparams, ModelAdapter(tmodel), tbatches,
                                PruneConfig(**cell))
    return jpruned, jrep, tpruned, trep


def test_thanos_masks_match_jax_and_shared_sets_pruned_once(pruned):
    """Every mask exactly, weights within W_TOL; each shared linear is
    pruned once, at the last site of its set (block 5 for set 0, block 7
    for set 1)."""
    jpruned, jrep, tpruned, trep = pruned
    assert list(trep.masks) == list(jrep.masks)
    assert len(trep.masks) == 2 * 8 + 2 * 7
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        assert check_nm(trep.masks[path].T, 2, 4)
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
    order = [r.path for r in trep.layers]
    shared = [p for p in order if p[0] == "shared"]
    assert len(shared) == len(set(shared)) == 14
    last_mamba = {s: order.index(("mamba", b, "mixer", "out_proj", "w"))
                  for s, b in ((0, 5), (1, 7))}
    for p in shared:
        assert order.index(p) == last_mamba[p[1]] + 1 + \
            [q for q in shared if q[1] == p[1]].index(p)
    assert trep.mean_sparsity() == jrep.mean_sparsity() == 0.5


def _serve(engine_cls, req_cls, cfg_cls, model, params, slots):
    """6 prompts of 5–10 tokens, 3–8 new tokens each → tokens by uid."""
    eng = engine_cls(model, params, cfg_cls(batch_slots=slots, max_len=24))
    rng = np.random.default_rng(3)
    for uid in range(6):
        eng.submit(req_cls(uid, rng.integers(0, 512, size=5 + uid).astype(
            np.int32), max_new=3 + int(rng.integers(0, 6))))
    return {r.uid: r.out for r in eng.run()}


@pytest.mark.parametrize("slots", [2, 4])
def test_engine_tokens_match_jax(pair, slots):
    """The dense tree on the contiguous engine: admission writes the
    nested {"mamba", "shared"} row into its slot."""
    jmodel, jparams, tmodel, tparams = pair
    out_j = _serve(JEngine, JRequest, JServeConfig, jmodel, jparams, slots)
    out_t = _serve(ServingEngine, Request, ServeConfig, tmodel, tparams,
                   slots)
    assert out_t == out_j


def test_compressed_engine_tokens_match_b1_loop(pair, pruned):
    """The pruned tree served compressed (NmCompressed leaves, K2's plain
    version here) on 4 slots: each request's tokens equal a B = 1 greedy
    decode_step loop over the same tree."""
    _, _, tmodel, _ = pair
    _, _, tpruned, trep = pruned
    comp = compress_params(tpruned, trep.masks, 2, 4)
    out = _serve(ServingEngine, Request, ServeConfig, tmodel, comp, 4)
    rng = np.random.default_rng(3)
    for uid in range(6):
        prompt = rng.integers(0, 512, size=5 + uid)
        new = 3 + int(rng.integers(0, 6))
        cache = tmodel.init_cache(1, 24)
        with torch.no_grad():
            for s, tok in enumerate(prompt):
                lg, cache = tmodel.decode_step(comp, cache,
                                               torch.tensor([[int(tok)]]), s)
            got = []
            for s in range(len(prompt), len(prompt) + new):
                got.append(int(lg[0, -1].argmax()))
                lg, cache = tmodel.decode_step(comp, cache,
                                               torch.tensor([[got[-1]]]), s)
        assert out[uid] == got


def test_paged_mode_raises(pair):
    _, _, tmodel, tparams = pair
    with pytest.raises(ValueError, match="no init_paged_cache"):
        ServingEngine(tmodel, tparams, ServeConfig(batch_slots=2, max_len=16,
                                                   paged=True, page_size=8))


def test_bf16_blocks_match_jax():
    """bf16, module by module (the bound of tests/test_torch_paged.py is a
    one-module bound: through 8 random-init blocks bf16 rounding in another
    order compounds past it): at every depth, on JAX's bf16 carry there,
    the Mamba2 mixer's output and, at a shared site, the shared set's
    application."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jmodel, tmodel = j_build(jcfg), build_model(tcfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    tokens = np.random.default_rng(4).integers(0, 512, size=(2, 8))
    carry = jmodel.embed_batch(jparams, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    pos = torch.from_numpy(np.asarray(carry["positions"]).astype(np.int64))
    # JAX's side jitted: the same ops, compiled once for every block
    j_mixer = jax.jit(lambda p, h: JS.mamba2_forward(
        p["mixer"], jcfg, JL.norm(p["ln"], h)))
    j_shared = jax.jit(lambda p, which, h, jpos: jmodel._shared_apply(
        p, which, h, jpos, None, window=jcfg.sliding_window),
        static_argnums=(1,))

    def close(got, want):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(n(got), want, rtol=2e-2,
                                   atol=1e-2 * np.abs(want).max())

    def port(h):
        return torch.from_numpy(np.array(h.astype(jnp.float32))).to(
            torch.bfloat16)

    h = carry["h"]
    for i in range(8):
        tmb = tparams["mamba"][i]
        jout = j_mixer(jparams["mamba"][i], h)
        close(S.mamba2_forward(tmb["mixer"], tcfg,
                               L.norm(tmb["ln"], port(h))), jout)
        h = h + jout
        if i in tmodel._shared_points():
            which = tmodel._which(i)
            jsh = j_shared(jparams, which, h, carry["positions"])
            close(tmodel._shared_apply(tparams, which, port(h), pos, None),
                  jsh)
            h = jsh


@pytest.mark.slow
def test_full_config_one_step():
    """The published widths on the CPU (bf16, depth cut to 6 so one shared
    site runs): one decode step gives finite logits of the vocabulary's
    width."""
    cfg = registry.get_config(ARCH).replace(num_layers=6)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(1, 8)
    with torch.no_grad():
        lg, _ = model.decode_step(params, cache, torch.tensor([[1]]), 0)
    assert lg.shape == (1, 1, cfg.vocab_size) and bool(
        torch.isfinite(lg).all())
