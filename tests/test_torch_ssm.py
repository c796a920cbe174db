"""The port's Mamba2 block (``repro_torch.models.ssm``) on the CPU against
the JAX package's, on zamba2-7b's REDUCED widths (d_model 64, 8 heads of
16, state 16, 2 groups, conv 4) and a variant with 4 groups: the causal
conv, the full-sequence forward, the one-token decode and its state, and
decode against forward.

Tolerances: fp32 rtol/atol 1e-4 — the JAX forward runs the recurrence as
an associative scan, the port as a sequential loop, so the sums run in
another order; decode (a per-step recurrence on both sides) and the conv
rtol/atol 1e-5.  Softplus is ``logaddexp(x, 0)`` on both sides (torch's
own softplus switches to x above 20, a difference below fp32 rounding
there).  bf16: rtol 2e-2, atol 1e-2 × max|y| (tests/test_torch_paged.py's
bound)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402

ARCH = "zamba2-7b"


def _pair(groups: int = 2, dtype=jnp.float32):
    jcfg = j_get_config(ARCH, reduced=True).replace(ssm_groups=groups)
    tcfg = get_config(ARCH, reduced=True).replace(ssm_groups=groups)
    jp = JS.mamba2_params(jax.random.PRNGKey(3), jcfg, dtype)
    # random A_log / D / dt_bias so every term of the recurrence shows
    rng = np.random.default_rng(4)
    for k in ("A_log", "D", "dt_bias"):
        jp[k] = jnp.asarray(rng.normal(size=jp[k].shape) * 0.5, dtype)
    tp = params_from_numpy(jax_tree_to_numpy(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_dims_and_split_match_jax():
    jcfg, tcfg, jp, tp = _pair()
    assert S.mamba2_dims(tcfg) == JS.mamba2_dims(jcfg) == (128, 8)
    full = get_config(ARCH)
    assert S.mamba2_dims(full) == (7168, 112)
    x = np.random.default_rng(0).normal(size=(2, 3, 128 * 2 + 64 + 8))
    for a, b in zip(S._split_proj(tcfg, t(x.astype(np.float32))),
                    JS._split_proj(jcfg, jnp.asarray(x, jnp.float32))):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    seq = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    np.testing.assert_allclose(
        n(S._causal_conv(t(seq), t(w))),
        np.asarray(JS._causal_conv(jnp.asarray(seq), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [2, 4])
def test_forward_matches_jax(groups):
    """12 tokens; the tape's two inputs too."""
    jcfg, tcfg, jp, tp = _pair(groups)
    x = np.random.default_rng(2).normal(size=(2, 12, 64)).astype(np.float32)
    jtape, ttape = {}, {}
    yj = JS.mamba2_forward(jp, jcfg, jnp.asarray(x), tape=jtape,
                           path=("m",))
    yt = S.mamba2_forward(tp, tcfg, t(x), tape=ttape, path=("m",))
    np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=1e-4, atol=1e-4)
    assert list(ttape) == list(jtape) == [("m", "in_proj", "w"),
                                          ("m", "out_proj", "w")]
    for k, v in jtape.items():
        np.testing.assert_allclose(n(ttape[k]), np.asarray(v), rtol=1e-4,
                                   atol=1e-4)


def test_decode_and_state_match_jax_and_forward():
    """10 one-token steps from the zero cache: output and both state
    leaves against JAX's steps, and the outputs against the port's
    full-sequence forward."""
    jcfg, tcfg, jp, tp = _pair()
    x = np.random.default_rng(5).normal(size=(2, 10, 64)).astype(np.float32)
    jc = JS.mamba2_cache_init(jcfg, 2)
    tc = S.mamba2_cache_init(tcfg, 2)
    assert tc.ssm.shape == jc.ssm.shape and tc.conv.shape == jc.conv.shape
    outs = []
    for s in range(10):
        yj, jc = JS.mamba2_decode(jp, jcfg, jnp.asarray(x[:, s:s + 1]), jc)
        yt, tc = S.mamba2_decode(tp, tcfg, t(x[:, s:s + 1]), tc)
        np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(n(tc.ssm), np.asarray(jc.ssm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(n(tc.conv), np.asarray(jc.conv),
                                   rtol=1e-5, atol=1e-5)
        outs.append(yt)
    full = S.mamba2_forward(tp, tcfg, t(x))
    np.testing.assert_allclose(n(torch.cat(outs, dim=1)), n(full),
                               rtol=1e-4, atol=1e-4)


def test_bf16_forward_and_decode_match_jax():
    jcfg, tcfg, jp, tp = _pair(dtype=jnp.bfloat16)
    assert tp["in_proj"]["w"].dtype == torch.bfloat16
    x = np.random.default_rng(6).normal(size=(2, 8, 64)).astype(np.float32)
    yj = np.asarray(JS.mamba2_forward(jp, jcfg, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    yt = n(S.mamba2_forward(tp, tcfg, t(x, torch.bfloat16)))
    np.testing.assert_allclose(yt, yj, rtol=2e-2,
                               atol=1e-2 * np.abs(yj).max())
    jc = JS.mamba2_cache_init(jcfg, 2, jnp.bfloat16)
    tc = S.mamba2_cache_init(tcfg, 2, torch.bfloat16)
    for s in range(4):
        dj, jc = JS.mamba2_decode(jp, jcfg, jnp.asarray(
            x[:, s:s + 1], jnp.bfloat16), jc)
        dt, tc = S.mamba2_decode(tp, tcfg, t(x[:, s:s + 1], torch.bfloat16),
                                 tc)
        dj = np.asarray(dj.astype(jnp.float32))
        np.testing.assert_allclose(n(dt), dj, rtol=2e-2,
                                   atol=1e-2 * np.abs(dj).max())
