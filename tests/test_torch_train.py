"""The port's train step on the CPU against the JAX package's, on REDUCED
configs of the dense, VLM and MoE archs (the recurrent and encoder–decoder
families and deepseek are in test_torch_train_families.py).

From the same params and batch (``concrete_batch`` at seq 32, batch 2,
fp32): the loss at rel 1e-5; every leaf's gradient within 1e-4 of that
leaf's max |g| (JAX's ``jax.jit(jax.value_and_grad(model.loss))``); one
``make_train_step`` with AdamW(wd 0.1, clip 1.0) at lr 1e-3 against JAX's
jitted step — loss, lr and grad_norm at rel 1e-5, new params within
1e-6 + 1e-4·|p| except where JAX's |g| is below 1e-3 of the leaf's max
(there the first Adam step is lr·sign(g), so |Δ| ≤ 2·lr).  Also: remat
'block' equals 'none' bitwise; bf16 tinyllama against JAX at the bf16
tolerance below; ``donate`` in place or not.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.schedules import constant as j_constant  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.train.step import (_loss_with_remat,  # noqa: E402
                                    make_train_step, value_and_grad)
from repro_torch.util.tree import leaves  # noqa: E402
from test_torch_fixtures import (TRAIN_LR, assert_grads_close,  # noqa: E402
                                 assert_step_params_close, flat_numpy,
                                 jax_tree_to_numpy, train_pair)

ARCHS = ("tinyllama-1.1b", "gemma3-1b", "h2o-danube-1.8b",
         "mistral-large-123b", "internvl2-76b", "qwen3-moe-30b-a3b")
OPT = dict(weight_decay=0.1, clip_norm=1.0)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def step_parity(arch: str) -> None:
    """Loss, grads and one train step against JAX (the module docstring's
    tolerances)."""
    jmodel, jparams, jbatch, model, params, batch = train_pair(arch)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)
    loss, grads = value_and_grad(model.loss, params, batch)
    assert rel(loss, jloss) <= 1e-5
    assert_grads_close(jax_tree_to_numpy(jgrads), grads, 1e-4)

    jopt = JAdamW(**OPT)
    jstep = j_make_train_step(jmodel, jopt, j_constant(TRAIN_LR),
                              remat="none", donate=False)
    jnew, _, jm = jstep(jparams, jopt.init(jparams), jbatch)
    opt = AdamW(**OPT)
    step = make_train_step(model, opt, constant(TRAIN_LR), remat="none",
                           donate=False)
    new, state, m = step(params, opt.init(params), batch)
    for k in ("loss", "lr", "grad_norm"):
        assert rel(m[k], jm[k]) <= 1e-5, (k, float(m[k]), float(jm[k]))
    assert int(state.step) == 1
    assert_step_params_close(jax_tree_to_numpy(jnew), new,
                             jax_tree_to_numpy(jgrads), TRAIN_LR)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    step_parity(arch)


def remat_bitwise(arch: str) -> None:
    """remat='block' gives bitwise the loss and grads of 'none'."""
    *_, model, params, batch = train_pair(arch)
    la, ga = value_and_grad(_loss_with_remat(model, "none"), params, batch)
    lb, gb = value_and_grad(_loss_with_remat(model, "block"), params, batch)
    assert torch.equal(la, lb)
    fa, fb = flat_numpy(ga), flat_numpy(gb)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_remat_block_equals_none_bitwise():
    remat_bitwise("tinyllama-1.1b")


def test_bf16_train_step_matches_jax():
    """tinyllama REDUCED in bf16: loss rel 1e-2, grads within 5e-2 of each
    leaf's max |g| (bf16 rounds at 2⁻⁸ relative and the two frameworks
    round different intermediates), new params within 1e-5 + 1e-2·|p|
    (a bf16 ulp is 2⁻⁸·|p|) except where JAX's |g| is below 5e-2 of the
    leaf's max: there the two lr·sign(g) steps may differ (2·lr)."""
    jmodel, jparams, jbatch, model, params, batch = train_pair(
        "tinyllama-1.1b", dtype="bfloat16")
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)
    loss, grads = value_and_grad(model.loss, params, batch)
    assert rel(loss, jloss) <= 1e-2
    assert_grads_close(jax_tree_to_numpy(jgrads), grads, 5e-2)
    jopt, opt = JAdamW(**OPT), AdamW(**OPT)
    jnew, _, jm = j_make_train_step(jmodel, jopt, j_constant(TRAIN_LR),
                                    remat="none", donate=False)(
        jparams, jopt.init(jparams), jbatch)
    new, _, m = make_train_step(model, opt, constant(TRAIN_LR), remat="none",
                                donate=False)(params, opt.init(params), batch)
    assert rel(m["grad_norm"], jm["grad_norm"]) <= 2e-2
    assert all(v.dtype == torch.bfloat16 for v in leaves(new))
    assert_step_params_close(jax_tree_to_numpy(jnew), new,
                             jax_tree_to_numpy(jgrads), TRAIN_LR,
                             rtol=1e-2, atol=1e-5, small=5e-2)


def test_donate_in_place_or_untouched():
    *_, model, params, batch = train_pair("tinyllama-1.1b")
    opt = AdamW(**OPT)
    before = {k: v.copy() for k, v in flat_numpy(params).items()}
    state = opt.init(params)
    new, st, _ = make_train_step(model, opt, constant(TRAIN_LR),
                                 donate=False)(params, state, batch)
    after = flat_numpy(params)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert float(torch.stack([v.abs().max() for v in
                              leaves(state.mu)]
                             ).max()) == 0.0
    ptrs = {id(v): v.data_ptr() for v in
            leaves(params)}
    new2, st2, _ = make_train_step(model, opt, constant(TRAIN_LR),
                                   donate=True)(params, opt.init(params),
                                                batch)
    assert new2 is params                # the same tree, updated in place
    assert all(ptrs[id(v)] == v.data_ptr()
               for v in leaves(new2))
    fn, f2 = flat_numpy(new), flat_numpy(new2)
    assert all(np.array_equal(fn[k], f2[k]) for k in fn)   # same numbers
    assert any(not np.array_equal(before[k], f2[k]) for k in before)
    mu, mu2 = flat_numpy(st.mu), flat_numpy(st2.mu)
    assert all(np.array_equal(mu[k], mu2[k]) for k in mu)
