"""The port's whisper (``EncDecLM``) on the CPU against the JAX package, on
whisper-medium's REDUCED config (2 + 2 layers, d_model 64, 4 heads,
LayerNorm, tanh gelu, biased linears but wk, dec_seq 16): LayerNorm and the
sinusoidal positions, the bidirectional encoder, forward logits and the
tape on JAX's calibration batch (frames stub + decoder tokens), ``encode``,
decode against JAX's decode, the cached cross-k/v decode against the
uncached one, and Thanos 2:4 ``prune_model``.  Also the port's own pipeline
pieces: the encdec calibration batch and the held-out slice sampled once.

Tolerances: LayerNorm and the positions rtol/atol 1e-6; logits, encoder
and decode rtol/atol 1e-5 (1e-4 for the tape: every layer's
intermediates); the cross-k/v decode bitwise against the uncached decode;
masks exactly; weights rtol 5e-3 / atol 5e-4 (as tests/test_torch_slice.py);
bf16 LayerNorm rtol 2e-2, atol 1e-2 × max|y| (tests/test_torch_paged.py's
bound)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.schedule import get_path, prune_model  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402

ARCH = "whisper-medium"
W_TOL = {"rtol": 5e-3, "atol": 5e-4}


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config(ARCH, reduced=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config(ARCH, reduced=True), device="cpu")
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    jbatches = calibration_batches(jcfg, num_samples=8, seq_len=12, batch=4)
    tbatches = [{k: t(v) for k, v in b.items()} for b in jbatches]
    return jmodel, jparams, tmodel, tparams, jbatches, tbatches


def test_layernorm_and_norm_dispatch_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    want = np.asarray(JL.layernorm(jp, jnp.asarray(x)))
    np.testing.assert_allclose(n(L.layernorm(tp, t(x))), want, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(n(L.norm(tp, t(x))),
                                  n(L.layernorm(tp, t(x))))
    np.testing.assert_array_equal(n(L.norm({"scale": tp["scale"]}, t(x))),
                                  n(L.rmsnorm({"scale": tp["scale"]}, t(x))))
    assert set(L.norm_params("layernorm", 8)) == {"scale", "bias"}
    assert set(L.norm_params("rmsnorm", 8)) == {"scale"}
    jb = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    wb = np.asarray(JL.layernorm(jb, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    got = L.layernorm({k: v.to(torch.bfloat16) for k, v in tp.items()},
                      t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), wb, rtol=2e-2,
                               atol=1e-2 * np.abs(wb).max())


def test_sinusoidal_positions_match_jax():
    for seq, d in ((16, 64), (1500, 1024)):
        np.testing.assert_allclose(
            n(L.sinusoidal_positions(seq, d)),
            np.asarray(JL.sinusoidal_positions(seq, d)), rtol=1e-6,
            atol=1e-6 if seq < 100 else 2e-4)


def test_bidirectional_attention_matches_jax():
    """gqa_forward(is_causal=False): every query sees every key; the
    causal default is unchanged."""
    jcfg = j_get_config(ARCH, reduced=True)
    tcfg = get_config(ARCH, reduced=True)
    jp = JA.gqa_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    x = np.random.default_rng(2).normal(size=(2, 7, 64)).astype(np.float32)
    pos = np.zeros((2, 7), np.int32)
    for causal in (False, True):
        want = JA.gqa_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              theta=0.0, is_causal=causal)
        got = A.gqa_forward(tp, tcfg, t(x), torch.zeros((2, 7),
                                                        dtype=torch.int64),
                            theta=0.0, is_causal=causal)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert "b" not in tp["wk"] and all("b" in tp[k] for k in
                                       ("wq", "wv", "wo"))


def test_forward_logits_tape_and_loss_match_jax(pair):
    jmodel, jparams, tmodel, tparams, jbatches, tbatches = pair
    jtape, ttape = {}, {}
    lj = jmodel.forward(jparams, jbatches[0], tape=jtape)
    lt = tmodel.forward(tparams, tbatches[0], tape=ttape)
    assert lt.shape == (4, 12, 512)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-5, atol=1e-5)
    assert list(ttape) == list(jtape)
    for k, v in jtape.items():
        np.testing.assert_allclose(n(ttape[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-4)
    assert abs(float(tmodel.loss(tparams, tbatches[1]))
               - float(jmodel.loss(jparams, jbatches[1]))) < 1e-5


def test_encode_and_decode_match_jax(pair):
    """encode 9 frames, then 8 steps of B = 2 rows (row 1 two behind) on
    the encoded source, uncached and cached cross-k/v: the uncached logits
    against JAX's (both forms), the cached ones bitwise the uncached."""
    jmodel, jparams, tmodel, tparams, _, _ = pair
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(2, 9, 64)).astype(np.float32)
    ej = jmodel.encode(jparams, jnp.asarray(frames))
    et = tmodel.encode(tparams, t(frames))
    np.testing.assert_allclose(n(et), np.asarray(ej), rtol=1e-5, atol=1e-5)
    kvj = jmodel.precompute_cross_kv(jparams, ej)
    kvt = tmodel.precompute_cross_kv(tparams, et)
    assert list(kvt) == list(kvj) == [0, 1]
    np.testing.assert_allclose(n(kvt[1]["v"]), np.asarray(kvj[1]["v"]),
                               rtol=1e-5, atol=1e-5)
    toks = rng.integers(0, 512, size=(2, 10))
    jc = jmodel.init_cache(2, 16)
    tc, tcx = tmodel.init_cache(2, 16), tmodel.init_cache(2, 16)
    for step in range(8):
        pos = np.array([step + 2, step], np.int32)
        tok = toks[np.arange(2), pos][:, None]
        lj, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(pos), kvj)
        tpos = torch.from_numpy(pos.astype(np.int64))
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), tpos,
                                    et)
        ltx, tcx = tmodel.decode_step(tparams, tcx, torch.from_numpy(tok),
                                      tpos, kvt)
        np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(ltx, lt)


def test_thanos_masks_match_jax(pair):
    """Encoder blocks then decoder blocks (self-, cross-attention, MLP):
    every mask exactly, weights within W_TOL, biases untouched."""
    jmodel, jparams, tmodel, tparams, jbatches, tbatches = pair
    cell = dict(method="thanos", pattern="nm", n=2, m=4, block_size=64)
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches,
                                  JPruneConfig(**cell))
    tpruned, trep = prune_model(tparams, ModelAdapter(tmodel), tbatches,
                                PruneConfig(**cell))
    assert list(trep.masks) == list(jrep.masks)
    assert len(trep.masks) == 2 * 6 + 2 * 10
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(trep.masks[path]), np.asarray(mk))
        assert check_nm(trep.masks[path].T, 2, 4)
        np.testing.assert_allclose(n(get_path(tpruned, path)),
                                   np.asarray(get_path(jpruned, path)),
                                   **W_TOL)
    assert torch.equal(tpruned["dec"][1]["mlp"]["fc1"]["b"],
                       tparams["dec"][1]["mlp"]["fc1"]["b"])


def test_calibration_batches_fill_the_encdec_stub():
    """{"frames": (batch, seq_len, d) in the model dtype from a generator
    seeded with seed + 1, "dec_tokens": the token stream cut to
    min(dec_seq, seq_len)}; deterministic."""
    cfg = get_config(ARCH, reduced=True)
    a = P.calibration_batches(cfg, num_samples=8, seq_len=24, batch=4,
                              device="cpu")
    b = P.calibration_batches(cfg, num_samples=8, seq_len=24, batch=4,
                              device="cpu")
    toks = P.calibration_batches(cfg.replace(family="dense"), num_samples=8,
                                 seq_len=24, batch=4, device="cpu")
    assert len(a) == 2 and set(a[0]) == {"frames", "dec_tokens"}
    assert a[0]["frames"].shape == (4, 24, 64)
    assert a[0]["frames"].dtype == torch.float32
    assert torch.equal(a[1]["dec_tokens"], toks[1]["tokens"][:, :16])
    gen = torch.Generator().manual_seed(1234 + 1)
    assert torch.equal(a[0]["frames"], torch.randn((4, 24, 64),
                                                   generator=gen))
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    bf = P.calibration_batches(cfg.replace(dtype="bfloat16"), num_samples=4,
                               seq_len=8, batch=4, device="cpu")
    assert bf[0]["frames"].dtype == torch.bfloat16


def test_heldout_slice_sampled_once_and_losses_unchanged():
    """heldout_loss samples its tokens once per (vocab, seeds, shape):
    a second call draws nothing and gives the bit-identical loss, equal
    to the loss over a fresh draw of the same stream."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    P._sample.cache_clear()
    first = P.heldout_loss(model, params, cfg, num_batches=2, seq_len=16,
                           batch=4)
    misses = P._sample.cache_info().misses
    second = P.heldout_loss(model, params, cfg, num_batches=2, seq_len=16,
                            batch=4)
    assert misses == 2 and P._sample.cache_info().misses == 2
    assert first == second
    corpus = P.SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0)
    with torch.no_grad():
        fresh = [float(model.loss(params, {"tokens": torch.from_numpy(
            corpus.sample(np.random.default_rng([9999, i]), 4, 16))}))
            for i in range(2)]
    assert first == float(np.mean(fresh))


def test_serve_cli_refuses_encdec(monkeypatch, capsys):
    import sys

    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device",
                                      "cpu"])
    with pytest.raises(SystemExit):
        serve.main()
    assert "enc_out" in capsys.readouterr().err


@pytest.mark.slow
def test_full_config_encode_and_one_step():
    """The published widths and depth on the CPU (bf16, 24 + 24 layers):
    encode 16 frames, one cached-cross decode step → finite logits."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        enc = model.encode(params, torch.randn((1, 16, cfg.d_model)))
        kv = model.precompute_cross_kv(params, enc)
        lg, _ = model.decode_step(params, model.init_cache(1, 8),
                                  torch.tensor([[1]]), 0, kv)
    assert lg.shape == (1, 1, cfg.vocab_size) and bool(
        torch.isfinite(lg).all())
