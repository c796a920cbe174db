"""Pruning driver — the paper's Alg. 3 end to end (port of
``repro/launch/prune.py`` for a single prune cell).

    PYTHONPATH=src python -m repro_torch.launch.prune \
        --arch tinyllama-1.1b --method thanos --pattern nm --n 2 --m 4 --full

Runs: synthetic calibration → block-wise Hessian capture (K1 on the card)
→ per-layer pruning → held-out loss before and after.  ``--full`` runs the
published widths and depth (the default is the reduced config, as in the
JAX CLI); ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import registry
from repro_torch.core.api import METHODS, ON_SINGULAR, PATTERNS, PruneConfig
from repro_torch.core.schedule import prune_model
from repro_torch.data.pipeline import calibration_batches, heldout_loss
from repro_torch.device import resolve_device
from repro_torch.models.model_builder import ModelAdapter, build_model


def prune_arch(arch: str, cfg: PruneConfig, *, reduced: bool = True,
               num_samples: int = 16, seq_len: int = 128, batch: int = 8,
               log=print, on_singular: str = "escalate", device="cuda"):
    """Init ``arch`` from seed 0, prune it with ``cfg`` on ``device`` and
    compare held-out loss → (pruned params, report, summary dict)."""
    dev = resolve_device(device)
    mcfg = registry.get_config(arch, reduced=reduced)
    model = build_model(mcfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dense_loss = heldout_loss(model, params, mcfg)
    batches = calibration_batches(mcfg, num_samples=num_samples,
                                  seq_len=seq_len, batch=batch, device=dev)
    pruned, report = prune_model(params, ModelAdapter(model), batches, cfg,
                                 on_singular=on_singular)
    pruned_loss = heldout_loss(model, pruned, mcfg)
    out = {
        "arch": arch,
        "config": cfg.tag(),
        "device": str(dev),
        "dense_loss": dense_loss,
        "pruned_loss": pruned_loss,
        "delta": pruned_loss - dense_loss,
        "mean_sparsity": report.mean_sparsity(),
        "prune_seconds": report.seconds,
        "layers_pruned": len(report.layers),
    }
    if log:
        log(json.dumps(out, indent=1))
    return pruned, report, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--method", default="thanos", choices=list(METHODS))
    ap.add_argument("--pattern", default="unstructured",
                    choices=list(PATTERNS))
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--on-singular", default="escalate",
                    choices=list(ON_SINGULAR))
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = PruneConfig(method=args.method, pattern=args.pattern, p=args.p,
                      n=args.n, m=args.m, alpha=args.alpha,
                      block_size=args.block_size)
    prune_arch(args.arch, cfg, reduced=not args.full,
               on_singular=args.on_singular, device=args.device)


if __name__ == "__main__":
    main()
