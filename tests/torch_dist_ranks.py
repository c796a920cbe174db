"""Rank bodies for the port's distribution tests (``test_torch_dist_*.py``)
and the launcher that runs them in spawned gloo processes on the CPU.

A body is a top-level function of this module — a spawned child imports it
by name, with the parent's ``sys.path`` — and imports torch and the port,
never JAX, so a child starts in a few seconds.  Each rank joins a gloo
group over a ``FileStore`` under the test's ``tmp_path`` (no TCP port to
collide across pytest-xdist workers), builds a ``(world, 1)`` ("data",
"model") CPU mesh, runs the body and saves what it returns; the launcher
joins every rank with a timeout, so a hung rank fails its test instead of
the suite.
"""
from __future__ import annotations

import os
import time

import torch

SPAWN_TIMEOUT = 150.0          # seconds for a whole spawned group


def run_ranks(body, world: int, tmp_path, payload) -> list:
    """Run ``body(mesh, rank, payload)`` on ``world`` spawned gloo ranks;
    → each rank's return value, in rank order.  Fails if a rank exits
    non-zero, leaves no result or outlives ``SPAWN_TIMEOUT``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = tmp_path / f"{body.__name__}-out"
    out.mkdir()
    store = str(tmp_path / f"{body.__name__}-store")
    procs = [ctx.Process(target=_entry, args=(body.__name__, rank, world,
                                              store, str(out), payload))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _entry(name: str, rank: int, world: int, store: str, out: str,
           payload) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world, 1),
                                mesh_dim_names=("data", "model"))
        result = globals()[name](mesh, rank, payload)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tree_from_numpy(tree):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(tree, device="cpu")


def linears(params, paths) -> dict:
    from repro_torch.core.schedule import get_path

    return {p: get_path(params, p).clone() for p in paths}


def trees_equal(a, b) -> bool:
    """Same leaves bitwise, walked in sorted key order (a restored tree's
    dicts come back in another order)."""
    from repro_torch.util.tree import sorted_leaves

    la, lb = sorted_leaves(a), sorted_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------------------------------ prune
def prune_body(mesh, rank: int, payload: dict) -> dict:
    """(a) JAX's dryrun parity case (c = 512, b = 64, Thanos 2:4 B = 32
    through a plan, and its skip rule); (b) ``prune_model(mesh=)`` on
    tinyllama REDUCED; (c) each rank's calibration batch accumulated and
    all-reduced; (d) a ``PruneJob(mesh=)`` killed at its fourth journal
    write and resumed, against (b)'s uninterrupted run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (HessianAccumulator, PruneConfig, PruneJob,
                                  PrunePlan, PruneRule, prune_layer,
                                  prune_model)
    from repro_torch.dist.prune import prune_layer_sharded, row_partition
    from repro_torch.dist.sharding import _size
    from repro_torch.faults import FaultPlan, JournalWriteError
    from repro_torch.models.model_builder import ModelAdapter, build_model

    out: dict = {}
    w = torch.from_numpy(payload["w"])
    x = torch.from_numpy(payload["x"])
    h = 2 * x.T @ x
    cfg = PruneConfig(method="thanos", pattern="nm", n=2, m=4, block_size=32)
    plan = PrunePlan(rules=(PruneRule(match="embed*", cfg=None, name="skip"),
                            PruneRule(match="blocks/*", cfg=cfg)))
    out["shards"] = _size(mesh, row_partition(w.shape[0], mesh))
    out["local"] = prune_layer(w, h, cfg)
    out["sharded"] = prune_layer_sharded(w, h, plan, mesh,
                                         path=("blocks", 0, "mlp", "up", "w"))
    out["skipped"] = prune_layer_sharded(w, h, plan, mesh,
                                         path=("embed", "table"))

    model = build_model(get_config("tinyllama-1.1b", reduced=True),
                        device="cpu")
    adapter = ModelAdapter(model)
    params = tree_from_numpy(payload["params"])
    batches = [{"tokens": torch.from_numpy(t)} for t in payload["batches"]]
    cell = PruneConfig(method="thanos", pattern="nm", n=2, m=4,
                       block_size=64)
    pruned, report = prune_model(params, adapter, batches, cell, mesh=mesh)
    out["masks"] = report.masks
    out["linears"] = linears(pruned, report.masks)
    out["losses"] = [r.obs_loss for r in report.layers]

    acc = HessianAccumulator.init(payload["acc_x"][rank].shape[-1])
    acc.update(torch.from_numpy(payload["acc_x"][rank]))
    red = acc.all_reduce(mesh, ("data",))
    out["reduced"] = (red.xtx, red.count, red.skipped)

    job_dir = payload["job_dir"]
    try:
        PruneJob(job_dir, faults=FaultPlan.parse("journal_write@3"),
                 mesh=mesh).run(params, adapter, batches, cell)
        out["killed"] = False
    except JournalWriteError:
        out["killed"] = True
    resumed, rep2 = PruneJob(job_dir, mesh=mesh).run(
        params, adapter, batches, cell, resume=True)
    out["resume_equal"] = trees_equal(resumed, pruned) and all(
        torch.equal(rep2.masks[p], m) for p, m in report.masks.items())
    out["resume_reports"] = [(a.to_dict() | {"seconds": 0}) ==
                             (b.to_dict() | {"seconds": 0})
                             for a, b in zip(rep2.layers, report.layers)]
    return out


# ------------------------------------------------------------------ train
def train_body(mesh, rank: int, payload: dict) -> dict:
    """(a) ``shard_params`` (FSDP over the two ranks) of the tree the
    port's checkpointer restores: every leaf's whole value equal to the
    saved one; (b) two steps of ``make_sharded_train_step`` on tinyllama
    REDUCED, params and moments entering FSDP-sharded, each rank taking
    its half of the batch."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import shard_params
    from repro_torch.models.model_builder import build_model
    from repro_torch.optim import AdamW, AdamWState, constant
    from repro_torch.train.step import make_sharded_train_step
    from repro_torch.util.tree import leaves, map_tree

    out: dict = {}
    params = tree_from_numpy(payload["params"])
    _, restored = load_checkpoint(payload["ckpt"])
    sharded = shard_params(restored, mesh)
    full = map_tree(lambda d: d.full_tensor(), sharded)
    out["restore_equal"] = trees_equal(full, params)
    out["restore_sharded"] = sum(
        d.to_local().numel() < d.numel() for d in leaves(sharded))

    model = build_model(get_config("tinyllama-1.1b", reduced=True),
                        device="cpu")
    opt = AdamW(**payload["opt"])
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    st = opt.init(params)
    p = shard_params(params, mesh)
    st = AdamWState(step=st.step, mu=shard_params(st.mu, mesh),
                    nu=shard_params(st.nu, mesh))
    step = make_sharded_train_step(model, opt, constant(payload["lr"]), mesh,
                                   batch, params, remat="block")
    out["losses"], out["params"], out["mu"] = [], [], []
    for _ in range(2):
        p, st, m = step(p, st, batch)
        out["losses"].append(float(m["loss"]))
        out["params"].append(map_tree(lambda d: d.full_tensor().clone(), p))
        out["mu"].append(map_tree(lambda d: d.full_tensor().clone(), st.mu))
    out["all_dtensor"] = all(isinstance(d, DTensor)
                             for d in leaves(p) + leaves(st.mu)
                             + leaves(st.nu))
    out["lr"] = float(m["lr"])
    out["step"] = int(st.step)
    return out

