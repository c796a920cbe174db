"""The port's row-parallel prune (``repro_torch/dist/prune.py``) and its
hooks — ``prune_model(mesh=)``, ``PruneJob(mesh=)``, the Hessian
all-reduce — on gloo process groups on the CPU, against the JAX package.

One rank, in this process: ``prune_layer_sharded`` is bitwise the port's
``prune_layer`` for every method × pattern × even/odd row count of
tests/test_dist_layer.py, and its masks equal JAX's
``prune_layer_sharded`` on a 1 × 1 mesh exactly (weights rtol 5e-3 / atol
5e-4 and losses rtol 1e-2, the port-vs-JAX tolerances of
tests/test_torch_slice.py); a plan's skip rule, the allocation refusal,
magnitude without H and the "Hessian required" refusal act as JAX's.

Two spawned ranks (``torch_dist_ranks.prune_body``): JAX's dryrun parity
case (``src/repro/launch/dryrun.py``: c = 512, b = 64, 2:4 through a plan)
— masks exactly, weights rtol 1e-5 / atol 1e-6, loss rtol 1e-5 against the
local solve; tinyllama REDUCED pruned by ``prune_model(mesh=)`` with masks
equal to JAX's local ``prune_model``; each rank's accumulator all-reduced
equal to ``combine`` bitwise; a ``PruneJob(mesh=)`` killed at a journal
write and resumed, bitwise the uninterrupted run.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import PruneConfig as JPruneConfig  # noqa: E402
from repro.core import prune_layer as j_prune_layer  # noqa: E402
from repro.core import prune_model as j_prune_model  # noqa: E402
from repro.data.pipeline import calibration_batches  # noqa: E402
from repro.dist.prune import prune_layer_sharded as j_sharded  # noqa: E402
from repro.models.model_builder import ModelAdapter as JAdapter  # noqa
from repro.models.model_builder import build_model as j_build  # noqa: E402
from repro_torch.core import (AllocationSpec, HessianAccumulator,  # noqa
                              PruneConfig, PruneJob, PrunePlan, PruneRule,
                              prune_layer, prune_layer_guarded, prune_model)
from repro_torch.dist.prune import prune_layer_sharded  # noqa: E402
from repro_torch.faults import FaultPlan, JournalWriteError  # noqa: E402
from test_torch_fixtures import jax_tree_to_numpy, n, t  # noqa: E402
from torch_dist_ranks import prune_body, run_ranks  # noqa: E402

W_TOL = {"rtol": 5e-3, "atol": 5e-4}


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


def j_mesh_1x1() -> Mesh:
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _problem(c, b, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(c, b)).astype(np.float32)
    x = rng.normal(size=(4 * b, b)).astype(np.float32)
    h = 2 * x.T @ x
    return w, h


PATTERNS = [
    dict(pattern="unstructured", p=0.5),
    dict(pattern="unstructured", p=0.37),
    dict(pattern="nm", n=2, m=4),
    dict(pattern="nm", n=4, m=8),
]


def results_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------- one rank
@pytest.mark.parametrize("method", ["thanos", "sparsegpt", "wanda",
                                    "magnitude"])
@pytest.mark.parametrize("pat", PATTERNS,
                         ids=lambda d: d.get("p") and f"p{d['p']}"
                         or f"{d['n']}:{d['m']}")
@pytest.mark.parametrize("c", [16, 17])          # even and odd row counts
def test_one_rank_sharded_bitwise_local_and_jax(mesh1, method, pat, c):
    w, h = _problem(c, 32, seed=c)
    cfg = PruneConfig(method=method, block_size=16, **pat)
    local = prune_layer(t(w), t(h), cfg)
    sharded = prune_layer_sharded(t(w), t(h), cfg, mesh1)
    assert results_equal(sharded, local)
    jres = j_sharded(jnp.asarray(w), jnp.asarray(h),
                     JPruneConfig(method=method, block_size=16, **pat),
                     j_mesh_1x1())
    np.testing.assert_array_equal(n(sharded.mask), np.asarray(jres.mask))
    np.testing.assert_allclose(n(sharded.weights), np.asarray(jres.weights),
                               **W_TOL)
    np.testing.assert_allclose(float(sharded.loss), float(jres.loss),
                               rtol=1e-2)


def test_one_rank_plan_skip_allocation_and_hessian_rules(mesh1):
    w, h = _problem(16, 32)
    cfg = PruneConfig(method="thanos", pattern="nm", block_size=16)
    plan = PrunePlan(rules=(PruneRule(match="embed*", cfg=None, name="skip"),
                            PruneRule(match="blocks/*", cfg=cfg)))
    got = prune_layer_sharded(t(w), t(h), plan, mesh1,
                              path=("blocks", 0, "mlp", "up", "w"))
    assert results_equal(got, prune_layer(t(w), t(h), cfg))
    skip = prune_layer_sharded(t(w), t(h), plan, mesh1,
                               path=("embed", "table"))
    assert torch.equal(skip.weights, t(w)) and float(skip.mask.sum()) == 0.0
    assert float(skip.loss) == 0.0
    alloc = PrunePlan(rules=plan.rules, allocation=AllocationSpec())
    with pytest.raises(ValueError, match="unexpanded allocation"):
        prune_layer_sharded(t(w), t(h), alloc, mesh1, path=("blocks", 0))
    mag = PruneConfig(method="magnitude", p=0.5)
    got = prune_layer_sharded(t(w[:10]), None, mag, mesh1)
    jgot = j_sharded(jnp.asarray(w[:10]), None,
                     JPruneConfig(method="magnitude", p=0.5), j_mesh_1x1())
    np.testing.assert_array_equal(n(got.mask), np.asarray(jgot.mask))
    assert results_equal(got, prune_layer(t(w[:10]), None, mag))
    with pytest.raises(ValueError, match="Hessian required"):
        prune_layer_sharded(t(w[:8]), None,
                            PruneConfig(method="thanos", p=0.5), mesh1)


def test_guarded_solver_routes_escalation_and_fallback(mesh1):
    """``prune_layer_guarded(solver=)``: every attempt and the magnitude
    fallback go through the solver, as JAX's do."""
    w, h = _problem(16, 32)
    calls = []

    def solver(w_, h_, cfg_):
        calls.append(cfg_.method)
        return prune_layer_sharded(w_, h_, cfg_, mesh1)

    cfg = PruneConfig(method="thanos", p=0.5, block_size=16)
    res, info = prune_layer_guarded(
        t(w), t(h), cfg, on_singular="fallback:magnitude",
        max_escalations=1, solver=solver,
        faults=FaultPlan.parse("cholesky@0x2"))
    assert calls == ["magnitude"] and info.fallback == "magnitude"
    assert results_equal(res, prune_layer(
        t(w), t(h), PruneConfig(method="magnitude", p=0.5, block_size=16)))
    calls.clear()
    res, info = prune_layer_guarded(t(w), t(h), cfg, solver=solver,
                                    faults=FaultPlan.parse("cholesky@0"))
    assert calls == ["thanos"] and info.damp_attempts == 1
    assert info.percdamp_used == pytest.approx(0.1)


# ------------------------------------------------------------ two ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX's local prune of tinyllama REDUCED, the port's local prune, and
    the two ranks' results on the same inputs."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(512, 64)).astype(np.float32)
    x = rng.normal(size=(4 * 64, 64)).astype(np.float32)
    acc_x = [rng.normal(size=(40, 24)).astype(np.float32) for _ in range(2)]

    jcfg = j_get_config("tinyllama-1.1b", reduced=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatches = calibration_batches(jcfg, num_samples=16, seq_len=32, batch=8)
    params = jax_tree_to_numpy(jparams)
    tokens = [np.array(b["tokens"]) for b in jbatches]
    tmp = tmp_path_factory.mktemp("dist_prune")
    payload = {"w": w, "x": x, "acc_x": acc_x, "params": params,
               "batches": tokens, "job_dir": str(tmp / "job")}
    ranks = run_ranks(prune_body, 2, tmp, payload)

    jcell = JPruneConfig(method="thanos", pattern="nm", n=2, m=4,
                         block_size=64)
    _, jrep = j_prune_model(jparams, JAdapter(jmodel), jbatches, jcell)
    return {"ranks": ranks, "payload": payload, "jrep": jrep}


def test_two_ranks_dryrun_parity(two_ranks):
    """src/repro/launch/dryrun.py's >1-shard case on two real ranks."""
    for r in two_ranks["ranks"]:
        assert r["shards"] == 2
        local, sharded = r["local"], r["sharded"]
        np.testing.assert_array_equal(n(sharded.mask), n(local.mask))
        np.testing.assert_allclose(n(sharded.weights), n(local.weights),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(sharded.loss), float(local.loss),
                                   rtol=1e-5)
        assert float(r["skipped"].mask.sum()) == 0.0
    p = two_ranks["payload"]
    h = 2 * p["x"].T @ p["x"]
    jlocal = j_prune_layer(jnp.asarray(p["w"]), jnp.asarray(h), JPruneConfig(
        method="thanos", pattern="nm", n=2, m=4, block_size=32))
    np.testing.assert_array_equal(n(two_ranks["ranks"][0]["sharded"].mask),
                                  np.asarray(jlocal.mask))
    a, b = two_ranks["ranks"]
    assert results_equal(a["sharded"], b["sharded"])   # every rank: all rows


def test_two_ranks_prune_model_masks_equal_jax(two_ranks):
    jrep = two_ranks["jrep"]
    a, b = two_ranks["ranks"]
    assert list(a["masks"]) == list(jrep.masks)
    for path, mk in jrep.masks.items():
        np.testing.assert_array_equal(n(a["masks"][path]), np.asarray(mk))
        assert torch.equal(a["masks"][path], b["masks"][path])
        assert torch.equal(a["linears"][path], b["linears"][path])
    np.testing.assert_allclose(a["losses"], [r.obs_loss for r in jrep.layers],
                               rtol=1e-2)
    # against the port's local prune on the same inputs
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.schedule import get_path
    from repro_torch.models.model_builder import ModelAdapter, build_model

    p = two_ranks["payload"]
    model = build_model(get_config("tinyllama-1.1b", reduced=True),
                        device="cpu")
    pruned, rep = prune_model(
        params_from_numpy(p["params"], device="cpu"), ModelAdapter(model),
        [{"tokens": torch.from_numpy(x)} for x in p["batches"]],
        PruneConfig(method="thanos", pattern="nm", n=2, m=4, block_size=64))
    for path, mk in rep.masks.items():
        assert torch.equal(a["masks"][path], mk)
        np.testing.assert_allclose(n(a["linears"][path]),
                                   n(get_path(pruned, path)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a["losses"], [r.obs_loss for r in rep.layers],
                               rtol=1e-5)


def test_two_ranks_hessian_all_reduce(two_ranks):
    """Each rank's unstacked partial is summed over the group: bitwise the
    host-side ``combine`` of both partials, at rtol 1e-6 of one
    accumulator over both batches."""
    xs = two_ranks["payload"]["acc_x"]
    parts = [HessianAccumulator.init(24).update(t(x)) for x in xs]
    want = HessianAccumulator.combine(*parts)
    mono = HessianAccumulator.init(24)
    for x in xs:
        mono.update(t(x))
    for r in two_ranks["ranks"]:
        xtx, count, skipped = r["reduced"]
        assert torch.equal(xtx, want.xtx)
        assert float(count) == 80.0 and float(skipped) == 0.0
        np.testing.assert_allclose(n(xtx), n(mono.xtx), rtol=1e-6)


def test_two_ranks_prune_job_killed_and_resumed(two_ranks):
    for r in two_ranks["ranks"]:
        assert r["killed"] and r["resume_equal"]
        assert r["resume_reports"] and all(r["resume_reports"])
    layers = os.path.join(two_ranks["payload"]["job_dir"], "layers")
    assert len([f for f in os.listdir(layers) if f.endswith(".json")]) == 14
    assert os.path.exists(os.path.join(two_ranks["payload"]["job_dir"],
                                       "report.json"))


def test_one_rank_prune_job_killed_and_resumed(mesh1, tmp_path):
    """tests/test_prune_jobs.py's "sharded" case: a job on a 1 × 1 mesh
    killed at a journal write resumes bitwise to the uninterrupted run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model_builder import ModelAdapter, build_model

    cfg = get_config("tinyllama-1.1b", reduced=True).replace(num_layers=1)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                        generator=torch.Generator()
                                        .manual_seed(i))} for i in range(2)]
    cell = PruneConfig(method="thanos", pattern="unstructured", p=0.5,
                       block_size=32)
    adapter = ModelAdapter(model)
    oracle, orep = prune_model(params, adapter, batches, cell, mesh=mesh1)
    job = str(tmp_path / "job")
    with pytest.raises(JournalWriteError):
        PruneJob(job, faults=FaultPlan.parse("journal_write@2"),
                 mesh=mesh1).run(params, adapter, batches, cell)
    lines: list = []
    pruned, rep = PruneJob(job, mesh=mesh1).run(
        params, adapter, batches, cell, resume=True, progress=lines.append)
    from torch_dist_ranks import trees_equal

    assert trees_equal(pruned, oracle)
    assert [r.obs_loss for r in rep.layers] == \
        [r.obs_loss for r in orep.layers]
    assert sum("journaled" in s for s in lines) == 2 and len(lines) == 7
