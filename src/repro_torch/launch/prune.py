"""Pruning driver — the paper's Alg. 3 end to end (port of
``repro/launch/prune.py``).

    PYTHONPATH=src python -m repro_torch.launch.prune \
        --arch tinyllama-1.1b --method thanos --pattern nm --n 2 --m 4 --full

Runs: synthetic calibration → block-wise Hessian capture (K1 on the card)
→ per-layer pruning → held-out loss before and after.  ``--full`` runs the
published widths and depth (the default is the reduced config, as in the
JAX CLI); ``--device`` defaults to ``cuda``.

Recipes: ``--plan recipe.json`` drives the run from a ``PrunePlan``
(per-layer rules, skip rules, an optional sparsity allocation).  Without a
file, ``--skip GLOB`` / ``--mlp-pattern`` / ``--attn-pattern`` build a
mixed plan from the base cell; with none of them the run uses the bare
``PruneConfig`` (≡ ``PrunePlan.uniform``).  ``--method``/``--pattern``
choices come from the live registry (``core.api.METHODS``/``PATTERNS``).

Resilience: ``--job-dir DIR`` journals every completed layer
(``core/jobs.py``) so a killed run restarts with ``--resume`` and produces
bitwise the same output; ``--on-singular`` picks the numerical-failure
policy and ``--fault-plan`` arms deterministic fault injection (prune
sites: calib_batch, hessian_accum, cholesky, journal_write), e.g.

    python -m repro_torch.launch.prune --job-dir /tmp/j \
        --fault-plan 'journal_write@3' --device cpu      # dies at layer 3
    python -m repro_torch.launch.prune --job-dir /tmp/j --resume --device cpu
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import registry
from repro_torch.core.api import METHODS, ON_SINGULAR, PATTERNS, PruneConfig
from repro_torch.core.jobs import PruneJob
from repro_torch.core.plan import PrunePlan, PruneRule, as_plan
from repro_torch.core.schedule import prune_model
from repro_torch.data.pipeline import calibration_batches, heldout_loss
from repro_torch.device import resolve_device
from repro_torch.faults import FaultPlan
from repro_torch.models.model_builder import ModelAdapter, build_model

# transformer-family shorthand globs ('*' crosses '/'); moe covers both the
# stacked expert slices and the shared FFN
MLP_GLOBS = ("*/mlp/*", "*/moe/*")
ATTN_GLOBS = ("*/attn/*",)


def prune_arch(arch: str, plan: "PrunePlan | PruneConfig", *,
               reduced: bool = True, num_samples: int = 16,
               seq_len: int = 128, batch: int = 8, report_path: str = "",
               log=print, on_singular: str = "escalate", device="cuda",
               job_dir: str = "", resume: bool = False, faults=None):
    """Init ``arch`` from seed 0, prune it with ``plan`` (a ``PrunePlan`` or
    a bare ``PruneConfig``) on ``device`` and compare held-out loss →
    (pruned params, report, summary dict).  ``job_dir`` runs it as a
    journaled ``PruneJob`` (``resume`` continues one); ``faults`` is an
    armed ``FaultPlan``."""
    dev = resolve_device(device)
    mcfg = registry.get_config(arch, reduced=reduced)
    model = build_model(mcfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dense_loss = heldout_loss(model, params, mcfg)
    batches = calibration_batches(mcfg, num_samples=num_samples,
                                  seq_len=seq_len, batch=batch, device=dev)
    adapter = ModelAdapter(model)
    if job_dir:
        job = PruneJob(job_dir, on_singular=on_singular, faults=faults)
        pruned, report = job.run(params, adapter, batches, plan,
                                 resume=resume)
    else:
        # a recipe with an allocation block expands inside prune_model (one
        # extra dense capture pass); report.plan is the expanded plan
        pruned, report = prune_model(params, adapter, batches, plan,
                                     on_singular=on_singular, faults=faults)
    pruned_loss = heldout_loss(model, pruned, mcfg)
    out = {
        "arch": arch,
        "config": (plan.tag() if isinstance(plan, PruneConfig)
                   else f"plan[{len(as_plan(plan).rules)} rules]"),
        "device": str(dev),
        "dense_loss": dense_loss,
        "pruned_loss": pruned_loss,
        "delta": pruned_loss - dense_loss,
        "mean_sparsity": report.mean_sparsity(),
        "prune_seconds": report.seconds,
        "layers_pruned": sum(1 for r in report.layers if not r.skipped),
        "layers_skipped": sum(1 for r in report.layers if r.skipped),
        "rules": report.rule_rollup(),
    }
    if job_dir:
        out["job_dir"] = job_dir
    if report_path:
        report.save(report_path)        # atomic: never a torn artifact
        out["report"] = report_path
    if log:
        log(json.dumps(out, indent=1))
    return pruned, report, out


def build_plan(args) -> "PrunePlan | PruneConfig":
    """CLI flags → plan (or the bare ``PruneConfig``).

    ``--plan recipe.json`` wins outright.  Otherwise the base cell flags
    define a catch-all rule; ``--skip`` globs prepend skip rules and
    ``--mlp-pattern``/``--attn-pattern`` prepend transformer-family rules
    that reuse the base cell with another sparsity pattern.  First match
    wins, so skips outrank the shorthands, which outrank the catch-all.
    """
    if args.plan:
        return PrunePlan.load(args.plan)

    def cell(pattern: str) -> PruneConfig:
        return PruneConfig(
            method=args.method, pattern=pattern, p=args.p,
            n=args.n, m=args.m, alpha=args.alpha, block_size=args.block_size,
        )

    base = cell(args.pattern)
    rules = [PruneRule(match=g, cfg=None, name="skip") for g in args.skip]
    if args.mlp_pattern:
        rules += [PruneRule(match=g, cfg=cell(args.mlp_pattern), name="mlp")
                  for g in MLP_GLOBS]
    if args.attn_pattern:
        rules += [PruneRule(match=g, cfg=cell(args.attn_pattern),
                            name="attn") for g in ATTN_GLOBS]
    if not rules:
        return base                     # bare PruneConfig
    return PrunePlan(rules=(*rules, PruneRule(match="*", cfg=base)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    # choices come from the live registry: register_method() extensions
    # appear here with no CLI edits
    ap.add_argument("--method", default="thanos", choices=list(METHODS))
    ap.add_argument("--pattern", default="unstructured",
                    choices=list(PATTERNS))
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--plan", default="",
                    help="PrunePlan recipe JSON (overrides the cell flags)")
    ap.add_argument("--skip", action="append", default=[], metavar="GLOB",
                    help="leave matching layers dense (repeatable; "
                         "prepended as skip rules)")
    ap.add_argument("--mlp-pattern", default="", choices=["", *PATTERNS],
                    help="sparsity pattern for MLP/MoE linears "
                         "(base cell hyperparameters)")
    ap.add_argument("--attn-pattern", default="", choices=["", *PATTERNS],
                    help="sparsity pattern for attention linears")
    ap.add_argument("--report", default="",
                    help="write the PruneReport JSON (embeds the plan) here")
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: reduced)")
    ap.add_argument("--job-dir", default="",
                    help="journal completed layers here; a killed run "
                         "restarts with --resume, bitwise identical")
    ap.add_argument("--resume", action="store_true",
                    help="continue the journaled job in --job-dir")
    ap.add_argument("--on-singular", default="escalate",
                    choices=list(ON_SINGULAR),
                    help="numerical-failure policy when a layer's Hessian "
                         "resists factorization")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault injection: JSON file or "
                         "compact specs like 'journal_write@2;cholesky@0'")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.resume and not args.job_dir:
        ap.error("--resume requires --job-dir")
    faults = FaultPlan.load(args.fault_plan) if args.fault_plan else None
    prune_arch(args.arch, build_plan(args), reduced=not args.full,
               report_path=args.report, on_singular=args.on_singular,
               device=args.device, job_dir=args.job_dir, resume=args.resume,
               faults=faults)


if __name__ == "__main__":
    main()
