"""The port's tinyllama (REDUCED, fp32) against the JAX model with the same
parameters carried across by ``repro_torch.convert``: forward logits, loss,
the calibration tape, and decode_step with scalar and per-slot positions.

Tolerance: rtol/atol 1e-4 on fp32 logits (two frameworks' matmul and
softmax kernels, a few layers deep)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model_builder import ModelAdapter  # noqa: E402
from repro_torch.models.model_builder import build_model  # noqa: E402
from test_torch_fixtures import jax_tree_to_numpy, n  # noqa: E402

TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config("tinyllama-1.1b", reduced=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(get_config("tinyllama-1.1b", reduced=True),
                         device="cpu")
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               size=(2, 12))
    return jmodel, jparams, tmodel, tparams, tokens


def test_configs_match():
    for reduced in (False, True):
        j = dataclasses.asdict(j_get_config("tinyllama-1.1b",
                                            reduced=reduced))
        assert dataclasses.asdict(get_config("tinyllama-1.1b",
                                             reduced=reduced)) == j
    assert get_config("tinyllama-1.1b").torch_dtype == torch.bfloat16


def test_params_carry_across_with_the_same_paths(pair):
    jmodel, jparams, _, tparams, _ = pair
    jl = {jax.tree_util.keystr(k): v
          for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat["".join(f"[{k!r}]" for k in path)] = node

    walk(tparams, ())
    assert flat.keys() == jl.keys()
    for k, v in jl.items():
        np.testing.assert_array_equal(n(flat[k]), np.asarray(v))
    assert 0 in tparams["blocks"]        # integer block keys preserved


def test_bf16_weights_cross_bit_exact():
    w = jnp.asarray(np.random.default_rng(1).normal(size=(5, 7)),
                    jnp.bfloat16)
    tw = params_from_numpy({"w": np.asarray(w)}, device="cpu")["w"]
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))


def test_forward_loss_and_tape_match_jax(pair):
    jmodel, jparams, tmodel, tparams, tokens = pair
    lj = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt = tmodel.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(n(lt), np.asarray(lj), **TOL)
    np.testing.assert_allclose(
        float(tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens)})),
        float(jmodel.loss(jparams, {"tokens": jnp.asarray(tokens,
                                                          jnp.int32)})),
        rtol=1e-5)
    # the Alg.-3 adapter tapes the same linears with the same inputs
    ja, ta = JAdapter(jmodel), ModelAdapter(tmodel)
    cj = ja.prepare(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    ct = ta.prepare(tparams, {"tokens": torch.from_numpy(tokens)})
    _, capj = ja.block_apply(jparams, 0, cj, capture=True)
    _, capt = ta.block_apply(tparams, 0, ct, capture=True)
    assert list(capt) == list(capj) == ta.block_linear_paths(tparams, 0)
    for path in capj:
        np.testing.assert_allclose(n(capt[path]), np.asarray(capj[path]),
                                   **TOL)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_jax(pair, per_slot):
    """Token-by-token decode; per_slot feeds (B,) positions with the two
    rows at different depths (row 1 starts 3 tokens later)."""
    jmodel, jparams, tmodel, tparams, tokens = pair
    B, max_len = 2, 16
    jc = jmodel.init_cache(B, max_len)
    tc = tmodel.init_cache(B, max_len)
    for step in range(6):
        if per_slot:
            pos = np.array([step + 3, step], np.int32)
            tok = tokens[np.arange(B), pos][:, None]
            jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            tok = tokens[:, step:step + 1]
            jpos = tpos = step
        lj, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    jpos)
        lt, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), tpos)
        np.testing.assert_allclose(n(lt), np.asarray(lj), **TOL)
        np.testing.assert_array_equal(n(tc[0].pos_ids),
                                      np.asarray(jc[0].pos_ids))
    np.testing.assert_allclose(n(tc[1].k), np.asarray(jc[1].k), **TOL)


def test_decode_equals_forward_last_position(pair):
    """Decoding a sequence token by token ends on the forward logits."""
    _, _, tmodel, tparams, tokens = pair
    tc = tmodel.init_cache(2, 16)
    toks = torch.from_numpy(tokens)
    for i in range(toks.shape[1]):
        lt, tc = tmodel.decode_step(tparams, tc, toks[:, i:i + 1], i)
    full = tmodel.forward(tparams, {"tokens": toks})
    torch.testing.assert_close(lt[:, 0], full[:, -1], **TOL)
