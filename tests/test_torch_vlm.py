"""The port's internvl2-76b (the VLM family: a Llama-style backbone behind
precomputed patch embeddings) on the CPU against the JAX package, on its
REDUCED config (2 layers, d_model 64, 8 image tokens): the configuration,
``embed_batch`` (the image prefix, cast to the model dtype, ahead of the
token embeddings; positions over the whole row), ``loss_from_carry`` and
``loss`` (the image positions' logits sliced off), ``decode_step`` fed
embeddings in place of tokens, the VLM calibration batch, and Thanos 2:4
``prune_model`` on the same batches.  Both sides get the same numpy
arrays: JAX draws its stub with threefry, the port with a torch.Generator.

Tolerances: carries, logits and loss rtol/atol 1e-5 (fp32); decode logits
1e-4 (sequential steps); masks exactly; weights rtol 5e-3 / atol 5e-4
(as tests/test_torch_slice.py).
"""
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
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.api import PruneConfig  # noqa: E402
from repro_torch.core.masks import check_nm  # noqa: E402
from repro_torch.core.schedule import get_path, prune_model  # noqa: E402
from repro_torch.data.pipeline import calibration_batches  # noqa: E402
from repro_torch.data.pipeline import heldout_loss  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter, build_model  # noqa
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

ARCH = "internvl2-76b"
TOL = {"rtol": 1e-5, "atol": 1e-5}
W_TOL = {"rtol": 5e-3, "atol": 5e-4}


@pytest.fixture(scope="module")
def pair():
    jmodel = j_build(j_get_config(ARCH, reduced=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config(ARCH, reduced=True), device="cpu")
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams


def _batch(seed=0, rows=2, n_img=8, n_tok=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, size=(rows, n_tok))
    pe = rng.normal(size=(rows, n_img, 64)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "patch_embeds": jnp.asarray(pe)}
    tb = {"tokens": torch.from_numpy(tokens),
          "patch_embeds": torch.from_numpy(pe)}
    return jb, tb


def test_config_registered_and_matches():
    assert ARCH in ARCHS
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(ARCH, reduced=reduced)) == \
            dataclasses.asdict(j_get_config(ARCH, reduced=reduced))
    full = get_config(ARCH)
    assert (full.family, full.d_model, full.num_heads, full.num_kv_heads,
            full.d_ff, full.vocab_size, full.vlm_image_tokens) == \
        ("vlm", 8192, 64, 8, 28672, 128_256, 256)
    assert type(build_model(get_config(ARCH, reduced=True),
                            device="cpu")).__name__ == "TransformerLM"


def test_embed_batch_prepends_the_image_prefix(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _batch()
    jc, tc = jmodel.embed_batch(jparams, jb), tmodel.embed_batch(tparams, tb)
    assert tuple(tc["h"].shape) == (2, 16, 64)
    np.testing.assert_allclose(n(tc["h"]), np.asarray(jc["h"]), **TOL)
    np.testing.assert_array_equal(n(tc["positions"]),
                                  np.asarray(jc["positions"]))
    np.testing.assert_array_equal(n(tc["h"][:, :8]), n(tb["patch_embeds"]))
    # a bf16 prefix is cast to the model dtype
    tb16 = dict(tb, patch_embeds=tb["patch_embeds"].to(torch.bfloat16))
    assert tmodel.embed_batch(tparams, tb16)["h"].dtype == torch.float32
    # a text-only batch embeds tokens alone
    assert tuple(tmodel.embed_batch(
        tparams, {"tokens": tb["tokens"]})["h"].shape) == (2, 8, 64)


def test_loss_from_carry_and_loss_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _batch(1)
    jc, tc = jmodel.embed_batch(jparams, jb), tmodel.embed_batch(tparams, tb)
    for i in range(2):
        jc, tc = jmodel.block(jparams, i, jc), tmodel.block(tparams, i, tc)
    np.testing.assert_allclose(n(tc["h"]), np.asarray(jc["h"]), **TOL)
    np.testing.assert_allclose(
        float(tmodel.loss_from_carry(tparams, tc, tb)),
        float(jmodel.loss_from_carry(jparams, jc, jb)), **TOL)
    np.testing.assert_allclose(float(tmodel.loss(tparams, tb)),
                               float(jmodel.loss(jparams, jb)), **TOL)
    np.testing.assert_allclose(n(tmodel.forward(tparams, tb)),
                               np.asarray(jmodel.forward(jparams, jb)), **TOL)
    # explicit labels over the text positions only
    labels = np.random.default_rng(2).integers(0, 512, size=(2, 8))
    np.testing.assert_allclose(
        float(tmodel.loss(tparams, dict(tb, labels=torch.from_numpy(
            labels)))),
        float(jmodel.loss(jparams, dict(jb, labels=jnp.asarray(
            labels, jnp.int32)))), **TOL)


def test_decode_step_with_embeds_matches_jax(pair):
    """An image prefix of 8 embeddings through decode_step(embeds=), then
    4 tokens, from an empty cache; the last logits also equal forward's
    on the whole row."""
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _batch(3, n_tok=4)
    jcache, tcache = jmodel.init_cache(2, 16), tmodel.init_cache(2, 16)
    for s in range(12):
        if s < 8:
            jin = dict(embeds=jb["patch_embeds"][:, s:s + 1])
            tin = dict(embeds=tb["patch_embeds"][:, s:s + 1])
            jt, tt = jnp.zeros((2, 1), jnp.int32), torch.zeros(
                (2, 1), dtype=torch.int64)
        else:
            jin, tin = {}, {}
            jt, tt = jb["tokens"][:, s - 8:s - 7], tb["tokens"][:, s - 8:s - 7]
        lj, jcache = jmodel.decode_step(jparams, jcache, jt, jnp.int32(s),
                                        **jin)
        lt, tcache = tmodel.decode_step(tparams, tcache, tt, s, **tin)
        np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    full = tmodel.forward(tparams, tb)
    np.testing.assert_allclose(n(lt[:, 0]), n(full[:, -1]), rtol=1e-4,
                               atol=1e-4)


def test_calibration_batch_keys_shapes_dtype_seed():
    """n_img = min(vlm_image_tokens, seq_len // 2); the tokens are cut to
    seq_len − n_img; the stub is standard normal in the model dtype from a
    generator seeded with seed + 2, as the JAX stub's key is seed + 2."""
    cfg = get_config(ARCH, reduced=True)
    for seq_len, n_img in ((32, 8), (12, 6)):
        bs = calibration_batches(cfg, num_samples=8, seq_len=seq_len,
                                 batch=4, device="cpu")
        jbs = jpipe.calibration_batches(j_get_config(ARCH, reduced=True),
                                        num_samples=8, seq_len=seq_len,
                                        batch=4)
        assert len(bs) == len(jbs) == 2
        for b, jb in zip(bs, jbs):
            assert sorted(b) == sorted(jb) == ["patch_embeds", "tokens"]
            assert tuple(b["tokens"].shape) == tuple(jb["tokens"].shape) == \
                (4, seq_len - n_img)
            assert tuple(b["patch_embeds"].shape) == \
                tuple(jb["patch_embeds"].shape) == (4, n_img, 64)
            assert b["patch_embeds"].dtype == torch.float32
    bs = calibration_batches(cfg, num_samples=8, seq_len=32, batch=4,
                             seed=5, device="cpu")
    gen = torch.Generator().manual_seed(7)
    want = [torch.randn((4, 8, 64), generator=gen) for _ in range(2)]
    for b, w in zip(bs, want):
        assert torch.equal(b["patch_embeds"], w)
    pe = torch.cat([b["patch_embeds"] for b in bs])
    assert abs(float(pe.mean())) < 0.1 and abs(float(pe.std()) - 1) < 0.1
    bf = calibration_batches(cfg.replace(dtype="bfloat16"), num_samples=4,
                             seq_len=32, batch=4, device="cpu")
    assert bf[0]["patch_embeds"].dtype == torch.bfloat16
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert np.isfinite(heldout_loss(model, params, cfg, num_batches=1,
                                    seq_len=16, batch=2))


def test_thanos_masks_match_jax(pair):
    """Thanos 2:4 block by block on the JAX VLM calibration batches (16
    image and 16 text positions a row) fed to both: every mask exactly."""
    jmodel, jparams, tmodel, tparams = pair
    jcfg = j_get_config(ARCH, reduced=True)
    jbatches = jpipe.calibration_batches(jcfg, num_samples=8, seq_len=32,
                                         batch=4)
    cell = dict(method="thanos", pattern="nm", n=2, m=4, block_size=64)
    jpruned, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches,
                                  JPruneConfig(**cell))
    tbatches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
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


def test_prune_cli_runs_internvl_reduced(monkeypatch, capsys):
    """``launch/prune.py --arch internvl2-76b``: the VLM calibration and
    held-out batches through prune_arch, Thanos 2:4 at B = 64."""
    import json
    import sys

    from repro_torch.launch import prune

    monkeypatch.setattr(sys, "argv", ["prune", "--arch", ARCH, "--device",
                                      "cpu", "--pattern", "nm"])
    prune.main()
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == ARCH and out["layers_pruned"] == 14
    assert out["mean_sparsity"] == 0.5
    assert np.isfinite(out["dense_loss"]) and np.isfinite(out["pruned_loss"])
