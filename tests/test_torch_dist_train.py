"""The port's sharded train step and re-shard (``train/step.py``
``make_sharded_train_step``, ``dist/sharding.shard_params``) on gloo
process groups on the CPU, against the port's ``make_train_step`` and the
JAX package, on tinyllama REDUCED (fp32, the batch of
tests/test_torch_fixtures.py: seq 32, batch 2, lr 1e-3).

One rank, in this process: two sharded steps are bitwise two
``make_train_step`` steps (loss, params, both moments); one step holds
against JAX's jitted ``make_sharded_train_step`` on a 1 × 1 mesh at
tests/test_torch_train.py's tolerances (loss rel 1e-5; params within
1e-6 + 1e-4·|p| except where JAX's |g| is below 1e-3 of the leaf's max,
there |Δ| ≤ 2·lr).  A tree restored by the port's checkpointer and placed
by ``shard_params`` gives leaves equal to the saved ones (the port of
tests/test_elastic_and_waves.py's re-shard test).

Two spawned ranks (``torch_dist_ranks.train_body``), params and moments
entering FSDP-sharded, clipping off so the moments show the gradient's
scale: the losses of both steps at rel 1e-5 of ``make_train_step`` on the
whole batch; step 1's params at the tolerance above (the reference's own
gradients for the |g| test) and its first moment within 1e-4 of each
leaf's max (the mean of the two half-batch gradients against the whole
batch's); step 2's params within 4·lr; the restored tree re-sharded over
both ranks equal to the saved one.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.schedules import constant as j_constant  # noqa: E402
from repro.train.step import make_sharded_train_step as j_sharded  # noqa
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa
from repro_torch.dist.sharding import P, fsdp_pspecs, shard_params  # noqa
from repro_torch.optim import AdamW, AdamWState, constant  # noqa: E402
from repro_torch.train.step import (make_sharded_train_step,  # noqa: E402
                                    make_train_step, value_and_grad)
from repro_torch.util.tree import leaves, map_tree  # noqa: E402
from test_torch_fixtures import (TRAIN_LR, assert_grads_close,  # noqa: E402
                                 assert_step_params_close, flat_numpy,
                                 jax_tree_to_numpy, train_pair)
from torch_dist_ranks import run_ranks, train_body, trees_equal  # noqa

OPT = dict(weight_decay=0.1, clip_norm=1.0)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def clone(tree):
    return map_tree(lambda x: x.clone(), tree)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group in this process and its 1 × 1 mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pair():
    return train_pair("tinyllama-1.1b")


def test_one_rank_sharded_step_bitwise_make_train_step(mesh1, pair):
    *_, model, params, batch = pair
    opt = AdamW(**OPT)
    ref = make_train_step(model, opt, constant(TRAIN_LR), remat="block")
    rp, rs = clone(params), opt.init(params)
    sp = shard_params(clone(params), mesh1, fsdp=False)
    s0 = opt.init(params)
    ss = AdamWState(s0.step, shard_params(s0.mu, mesh1, fsdp=False),
                    shard_params(s0.nu, mesh1, fsdp=False))
    step = make_sharded_train_step(model, opt, constant(TRAIN_LR), mesh1,
                                   batch, params)
    for _ in range(2):
        rp, rs, rm = ref(rp, rs, batch)
        sp, ss, sm = step(sp, ss, batch)
        assert set(sm) == {"loss", "lr"}
        assert torch.equal(sm["loss"], rm["loss"])
        assert float(sm["lr"]) == float(rm["lr"])
        full = map_tree(lambda d: d.full_tensor(), sp)
        assert trees_equal(full, rp)
        assert trees_equal(map_tree(lambda d: d.full_tensor(), ss.mu),
                           rs.mu)
        assert trees_equal(map_tree(lambda d: d.full_tensor(), ss.nu),
                           rs.nu)
    assert int(ss.step) == 2


def test_one_rank_sharded_step_matches_jax(mesh1, pair):
    jmodel, jparams, jbatch, model, params, batch = pair
    jm = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jopt = JAdamW(**OPT)
    jstep = j_sharded(jmodel, jopt, j_constant(TRAIN_LR), jm, jbatch,
                      jparams)
    jcopy = jax.tree.map(lambda x: x.copy(), jparams)
    jnew, _, jmet = jstep(jcopy, jopt.init(jcopy), jbatch)
    assert set(jmet) == {"loss", "lr"}
    _, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)

    opt = AdamW(**OPT)
    step = make_sharded_train_step(model, opt, constant(TRAIN_LR), mesh1,
                                   batch, params)
    new, _, met = step(shard_params(clone(params), mesh1, fsdp=False),
                       opt.init(params), batch)
    for k in ("loss", "lr"):
        assert rel(met[k], jmet[k]) <= 1e-5, k
    assert_step_params_close(
        jax_tree_to_numpy(jnew), map_tree(lambda d: d.full_tensor(), new),
        jax_tree_to_numpy(jgrads), TRAIN_LR)


def test_shard_params_of_restored_checkpoint(mesh1, pair, tmp_path):
    """tests/test_elastic_and_waves.py::test_checkpoint_then_reshard_onto_
    mesh: the restored tree, placed on the mesh, equals the saved one."""
    from torch.distributed.tensor import DTensor

    *_, params, _ = pair
    save_checkpoint(str(tmp_path), 1, params)
    _, restored = load_checkpoint(str(tmp_path))
    for fsdp in (True, False):
        sharded = shard_params(restored, mesh1, fsdp=fsdp)
        assert all(isinstance(d, DTensor) for d in leaves(sharded))
        assert trees_equal(map_tree(lambda d: d.full_tensor(), sharded),
                           params)
    specs = fsdp_pspecs(params, mesh1)
    assert specs["blocks"][0]["attn"]["wq"]["w"] == P("data", "model")


def test_two_ranks_sharded_step_against_whole_batch(pair, tmp_path):
    *_, model, params, batch = pair
    save_checkpoint(str(tmp_path / "ckpt"), 1, params)
    opt_kw = dict(weight_decay=0.1, clip_norm=0.0)
    payload = {"params": flat_numpy_tree(params), "ckpt": str(tmp_path /
                                                               "ckpt"),
               "batch": {k: v.numpy() for k, v in batch.items()},
               "opt": opt_kw, "lr": TRAIN_LR}
    ranks = run_ranks(train_body, 2, tmp_path, payload)

    opt = AdamW(**opt_kw)
    _, grads = value_and_grad(model.loss, params, batch)
    ref = make_train_step(model, opt, constant(TRAIN_LR), remat="block",
                          donate=False)
    rp, rs = params, opt.init(params)
    want = []
    for _ in range(2):
        rp, rs, rm = ref(rp, rs, batch)
        want.append((float(rm["loss"]), rp, rs.mu))
    a, b = ranks
    for r in ranks:
        assert r["restore_equal"] and r["restore_sharded"] > 0
        assert r["all_dtensor"] and r["step"] == 2
        assert r["lr"] == float(np.float32(TRAIN_LR))
        for (loss, _, _), got in zip(want, r["losses"]):
            assert rel(got, loss) <= 1e-5
    assert a["losses"] == b["losses"]
    assert trees_equal(a["params"][1], b["params"][1])
    assert_step_params_close(want[0][1], a["params"][0], grads, TRAIN_LR)
    assert_grads_close(want[0][2], a["mu"][0], 1e-4)
    for k, v in flat_numpy(want[1][1]).items():
        got = flat_numpy(a["params"][1])[k]
        assert float(np.abs(got - v).max()) <= 4 * TRAIN_LR, k


def flat_numpy_tree(tree):
    """The tree with numpy leaves (for a spawned rank's payload)."""
    return map_tree(lambda x: x.detach().numpy(), tree)
