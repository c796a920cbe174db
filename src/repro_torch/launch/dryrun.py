"""Dry run of every (arch × shape × mesh) cell (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --measure     # + card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --prune-parity

**Abstract sweep** (no device): each cell's step is built by
``launch/steps.py`` on the ``meta`` device; its record holds the analytic
cost (``costmodel.step_cost``), the MODEL_FLOPS yardstick, the roofline
terms against one NVIDIA H100's peaks, the per-device argument bytes under
the mesh's PartitionSpecs (params, cache, batch; for train also the fp32
gradients and the bf16 AdamW moments) and whether they fit one card's
80 GB.  The JAX records' compiler-derived keys (``lower_s``,
``compile_s``, ``hlo_*_raw``, ``collectives``, ``memory``) are left out,
not zeroed: the port has no HLO to read, so the roofline has no collective
term here.  A record also carries the whole unsharded argument bytes and
whether those fit one card.

**--measure** (``--device cuda`` by default): every decode cell whose
unsharded arguments fit one card at full depth is built by
``steps.make_step``, run on random-init weights from a seeded generator,
and timed — the median of ``MEASURE_RUNS`` steps after a warm-up, the
peak allocation above the argument bytes (the analogue of XLA's
``temp_size_in_bytes``) and the measured time over the one-card
``memory_s``.

**--prune-parity**: JAX's row-parallel prune parity check
(``dist.prune.prune_layer_sharded`` against ``prune_layer``, c 512, b 64,
Thanos 2:4 through a PrunePlan with a skip rule) over 4 spawned gloo ranks
on the CPU, a (4, 1) mesh — JAX runs it over 256 placeholder devices.

Records go to ``experiments/torch_dryrun/<arch>_<cell>_<mesh>.json``.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.dist import sharding as D
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_builder import build_model
from repro_torch.util.io import atomic_write_json

# --- NVIDIA H100 SXM (per card): dense bf16 peak and HBM3 rate -------------
CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # bf16, dense
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # one card's memory
MEASURE_RUNS = 5
LEFT_OUT = ("lower_s", "compile_s", "hlo_flops_per_device_raw",
            "hlo_bytes_per_device_raw", "collectives", "memory")


def model_flops(cfg, params_abstract, cell) -> dict:
    """MODEL_FLOPS yardstick: 6·N_active·D train / 2·N_active·D forward."""
    n_total = n_active = 0

    def count(path, leaf):
        nonlocal n_total, n_active
        name = D._path_names(path)[-1]
        size = leaf.numel()
        if name == "table":       # embedding: count once (tied head matmul)
            n_total += size
            n_active += size
            return
        if name != "w" or leaf.ndim < 2:
            return
        n_total += size
        if leaf.ndim == 3 and cfg.num_experts:          # stacked experts
            n_active += size * cfg.num_experts_per_tok / cfg.num_experts
        else:
            n_active += size

    D.map_with_path(count, params_abstract)
    if cell.kind == "train":
        flops = 6.0 * n_active * cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        flops = 2.0 * n_active * cell.global_batch * cell.seq_len
    else:  # decode: one token per sequence
        flops = 2.0 * n_active * cell.global_batch
    return {"n_total": float(n_total), "n_active": float(n_active),
            "model_flops": float(flops)}


def device_bytes(tree, specs, mesh, itemsize: int | None = None) -> float:
    """Bytes one device holds of ``tree`` laid out by ``specs`` (a tree of
    PartitionSpecs mirroring it); ``itemsize`` overrides the leaves' own
    (the fp32 gradients of a bf16 param tree)."""
    sizes = D.axis_sizes(mesh)
    total = 0.0

    def add(path, leaf, spec):
        nonlocal total
        shards = 1
        for e in spec:
            for a in (() if e is None else (e if isinstance(e, tuple)
                                            else (e,))):
                shards *= sizes[a]
        total += leaf.numel() * (itemsize or leaf.element_size()) / shards

    D.map_with_path(add, tree, specs)
    return total


def _whole_bytes(tree, itemsize: int | None = None) -> float:
    from repro_torch.launch.costmodel import tree_tensors

    return float(sum(x.numel() * (itemsize or x.element_size())
                     for x in tree_tensors(tree)))


def argument_bytes(step, args, mesh) -> dict:
    """Per-device and whole argument bytes of a built step, by the JAX
    dry run's convention: train counts params, fp32 gradients, both bf16
    moments and the batch; prefill params and the batch; decode params,
    cache, tokens, positions (and the encoder source)."""
    specs = step.in_specs
    per, whole = {}, {}
    if step.kind == "train":
        params, opt, batch = args
        per["params"] = device_bytes(params, specs[0], mesh)
        per["grads"] = device_bytes(params, specs[0], mesh, itemsize=4)
        per["moments"] = (device_bytes(opt.mu, specs[1].mu, mesh)
                          + device_bytes(opt.nu, specs[1].nu, mesh))
        per["batch"] = device_bytes(batch, specs[2], mesh)
        whole = {"params": _whole_bytes(params),
                 "grads": _whole_bytes(params, itemsize=4),
                 "moments": _whole_bytes(opt.mu) + _whole_bytes(opt.nu),
                 "batch": _whole_bytes(batch)}
    elif step.kind == "prefill":
        params, batch = args
        per = {"params": device_bytes(params, specs[0], mesh),
               "batch": device_bytes(batch, specs[1], mesh)}
        whole = {"params": _whole_bytes(params),
                 "batch": _whole_bytes(batch)}
    else:
        params, cache = args[:2]
        per = {"params": device_bytes(params, specs[0], mesh),
               "cache": device_bytes(cache, specs[1], mesh),
               "inputs": sum(device_bytes(a, s, mesh)
                             for a, s in zip(args[2:], specs[2:]))}
        whole = {"params": _whole_bytes(params),
                 "cache": _whole_bytes(cache),
                 "inputs": sum(_whole_bytes(a) for a in args[2:])}
    per["total"] = sum(per.values())
    whole["total"] = sum(whole.values())
    return {"per_device": per, "whole": whole}


def roofline(flops: float, hbm_bytes: float, mf: float, chips: int) -> dict:
    terms = {"compute_s": flops / (chips * PEAK_FLOPS),
             "memory_s": hbm_bytes / (chips * HBM_BW)}
    step_s = max(terms.values())
    return {"roofline": terms, "bottleneck": max(terms, key=terms.get),
            "roofline_step_s": step_s,
            "roofline_mfu": (mf / (chips * PEAK_FLOPS)) / step_s
            if step_s else 0.0}


def run_cell(arch: str, cell, mesh, mesh_name: str, chips: int) -> dict:
    from repro_torch.launch import costmodel as CM

    cfg = registry.get_config(arch)
    model = build_model(cfg, device="cpu")
    t0 = time.perf_counter()
    step, args = S.make_step(model, mesh, cell)
    t_build = time.perf_counter() - t0

    a_params = args[0]
    a_cache = args[1] if cell.kind == "decode" else None
    n_micro = (max(1, cell.global_batch // S._dp_size(mesh))
               if cell.kind == "train" else 1)
    ac = CM.step_cost(cfg, cell, a_params, n_micro=n_micro, a_cache=a_cache)
    mf = model_flops(cfg, a_params, cell)
    arg = argument_bytes(step, args, mesh)
    return {
        "arch": arch, "cell": cell.name, "mesh": mesh_name, "chips": chips,
        "device": CARD,
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                  "hbm_bytes": HBM_BYTES},
        "build_s": t_build,
        "analytic": {"flops": ac.flops, "hbm_bytes": ac.hbm_bytes,
                     "weight_bytes": ac.weight_bytes, **ac.detail},
        "model_flops": mf,
        **roofline(ac.flops, ac.hbm_bytes, mf["model_flops"], chips),
        "useful_fraction": (mf["model_flops"] / ac.flops
                            if ac.flops else 0.0),
        "argument_bytes": arg,
        "fits": arg["per_device"]["total"] <= HBM_BYTES,
        "fits_one_card": arg["whole"]["total"] <= HBM_BYTES,
        "left_out": list(LEFT_OUT),
        "note": "no collective term: the port has no compiled HLO to read",
    }


def timed_runs(step, seed: int, runs: int) -> dict:
    """Draw ``step``'s concrete arguments from ``seed`` and run it: a
    warm-up, then ``runs`` timed steps (CUDA events on the card, the host
    clock on the CPU).  → {"args", "first" (the warm-up's logits), "last",
    "times" (ms), "peak" (bytes allocated above what was allocated before
    the arguments; None on the CPU)}."""
    dev = step.model.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()     # a step of tens of GB: no stale blocks
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    args = step.concrete_args(torch.Generator(device=dev).manual_seed(seed))
    first, _ = step(*args)
    logits, times = first, []
    for _ in range(runs):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, _ = step(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            logits, _ = step(*args)
            times.append(1e3 * (time.perf_counter() - t0))
    peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
    return {"args": args, "first": first, "last": logits, "times": times,
            "peak": peak}


def measure_cell(arch: str, cell, *, device: str = "cuda",
                 reduced: bool = False, seed: int = 0,
                 runs: int = MEASURE_RUNS) -> dict:
    """Run a decode cell's step (default options) on ``device`` on
    random-init weights from ``seed``: median step ms over ``runs`` after a
    warm-up, peak bytes above the arguments, measured over the one-card
    roofline."""
    from repro_torch.launch import costmodel as CM

    cfg = registry.get_config(arch, reduced=reduced)
    model = build_model(cfg, device=device)
    step, a_args = S.make_step(model, D.MeshShape(("data", "model"), (1, 1)),
                               cell)
    run = timed_runs(step, seed, runs)
    arg_bytes = _whole_bytes(run["args"])
    ac = CM.step_cost(cfg, cell, a_args[0], a_cache=a_args[1])
    mf = model_flops(cfg, a_args[0], cell)
    line = roofline(ac.flops, ac.hbm_bytes, mf["model_flops"], 1)
    ms = statistics.median(run["times"])
    peak = run["peak"]
    return {"arch": arch, "cell": cell.name, "device": str(model.device),
            "card": (torch.cuda.get_device_name(0)
                     if model.device.type == "cuda" else "cpu"),
            "step_ms": ms, "step_ms_all": run["times"],
            "argument_bytes": arg_bytes,
            "temp_bytes": None if peak is None else peak - arg_bytes,
            "peak_bytes": peak,
            "logits_shape": list(run["last"].shape),
            "finite": bool(torch.isfinite(run["last"].float()).all()),
            **line,
            "measured_over_memory_s": ms / 1e3 / line["roofline"]["memory_s"],
            "measured_over_bound": ms / 1e3 / line["roofline_step_s"]}


# ------------------------------------------------------------- prune parity
def _parity_rank(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.api import PruneConfig, prune_layer
    from repro_torch.core.plan import PrunePlan, PruneRule
    from repro_torch.dist.prune import prune_layer_sharded, row_partition

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world, 1),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(0)
        c, b = 512, 64
        w = torch.randn((c, b), generator=gen)
        x = torch.randn((4 * b, b), generator=gen)
        h = 2 * x.T @ x
        shards = D._size(mesh, row_partition(c, mesh))
        assert shards > 1, f"parity run must be >1-shard, got {shards}"
        cfg = PruneConfig(method="thanos", pattern="nm", n=2, m=4,
                          block_size=32)
        plan = PrunePlan(rules=(
            PruneRule(match="embed*", cfg=None, name="skip"),
            PruneRule(match="blocks/*", cfg=cfg)))
        local = prune_layer(w, h, cfg)
        sharded = prune_layer_sharded(w, h, plan, mesh,
                                      path=("blocks", 0, "mlp", "up", "w"))
        skipped = prune_layer_sharded(w, h, plan, mesh,
                                      path=("embed", "table"))
        assert float(skipped.mask.sum()) == 0.0, "skip rule must stay dense"
        assert torch.equal(local.mask, sharded.mask), "masks differ"
        torch.testing.assert_close(sharded.weights, local.weights,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(sharded.loss, local.loss, rtol=1e-5,
                                   atol=0.0)
        if rank == 0:
            print(f"PRUNE-PARITY OK shards={shards} c={c} b={b} "
                  "pattern=2:4 (via plan) mask=bit-exact", flush=True)
    finally:
        dist.destroy_process_group()


def run_prune_parity(world: int = 4, timeout: float = 300.0) -> None:
    """>1-shard row-parallel prune parity over ``world`` spawned gloo ranks
    on the CPU: masks bit-exact, weights and the summed loss within rtol
    1e-5.  Raises if a rank fails or outlives ``timeout`` seconds."""
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_parity_rank, args=(r, world, store))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"prune parity ranks exited {codes}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--include-skipped", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--prune-parity", action="store_true",
                    help="run the >1-shard dist.prune parity check and exit")
    ap.add_argument("--measure", action="store_true",
                    help="also run the decode cells that fit one card")
    ap.add_argument("--device", default="cuda",
                    help="device of --measure (cuda, or cpu)")
    args = ap.parse_args(argv)

    if args.prune_parity:
        run_prune_parity()
        return 0
    os.makedirs(args.out, exist_ok=True)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod16x16", make_production_mesh(multi_pod=False),
                       256))
    if args.mesh in ("multi", "both"):
        meshes.append(("pods2x16x16", make_production_mesh(multi_pod=True),
                       512))

    archs = registry.ARCHS if args.arch == "all" else args.arch.split(",")
    cells = (list(SHAPES.values()) if args.cell == "all"
             else [SHAPES[c] for c in args.cell.split(",")])

    failures = []
    for arch in archs:
        cfg = registry.get_config(arch)
        for cell in cells:
            if not registry.cell_supported(cfg, cell) and \
                    not args.include_skipped:
                print(f"SKIP {arch} {cell.name} (no sub-quadratic state)")
                continue
            fits_card = False
            for mesh_name, mesh, chips in meshes:
                tag = f"{arch}_{cell.name}_{mesh_name}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"HAVE {tag} (cached; --force to redo)")
                    continue
                try:
                    rec = run_cell(arch, cell, mesh, mesh_name, chips)
                    fits_card = rec["fits_one_card"]
                    atomic_write_json(path, rec)
                    print(f"OK   {tag}: fits={rec['fits']} "
                          f"bottleneck={rec['bottleneck']} "
                          f"step={rec['roofline_step_s'] * 1e3:.4f}ms "
                          f"mfu={rec['roofline_mfu']:.4f} "
                          f"one-card={rec['fits_one_card']}")
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e!r}")
            if args.measure and cell.kind == "decode" and fits_card:
                tag = f"{arch}_{cell.name}_measured"
                try:
                    rec = measure_cell(arch, cell, device=args.device)
                    atomic_write_json(os.path.join(args.out, tag + ".json"),
                                      rec)
                    print(f"RUN  {tag}: {rec['step_ms']:.3f} ms "
                          f"(bound {rec['roofline_step_s'] * 1e3:.3f} ms, "
                          f"×{rec['measured_over_bound']:.2f}) "
                          f"on {rec['card']}")
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e!r}")
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        return 1
    print("\nall requested cells built")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
