"""Serving driver — batched greedy generation, optionally from a Thanos 2:4
pruned and compressed model (port of ``repro/launch/serve.py``, offline
continuous batching).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 8 --prompt-len 16 --max-new 12 --nm --full

``--nm`` prunes 2:4 with Thanos first and serves from the NmCompressed
representation, every pruned linear through K2 on the card.  ``--plan
recipe.json`` prunes with a ``PrunePlan`` instead and serves with per-layer
residency: paths whose cell is n:m stay NmCompressed (K2), every other
path (unstructured cells, skip rules) serves dense through ``x @ W`` (try
examples/recipes/mixed_2to4_serve.json).  ``--paged`` serves from the
paged KV cache with prefix reuse (``--page-size`` tokens a page, max_len
rounded up to a multiple of it; ``--num-pages`` 0 sizes the pool for every
slot at max_len) and prints its page statistics.  ``--full`` runs the
published widths and depth (default: reduced); ``--device`` defaults to
``cuda``.  The dense, MoE, hybrid (zamba2) and xLSTM families serve; the
encoder–decoder (whisper) does not, as in the JAX CLI: the engine's
decode_step takes no encoded source.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.api import PruneConfig
from repro_torch.core.plan import PrunePlan
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import IMPLS
from repro_torch.models.model_builder import build_model
from repro_torch.serve.compressed import compress_params, compressed_bytes
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--nm", action="store_true",
                    help="Thanos-prune 2:4 and serve compressed-resident")
    ap.add_argument("--plan", default="",
                    help="PrunePlan recipe: prune per layer and serve with "
                         "mixed dense/NmCompressed residency")
    ap.add_argument("--nm-impl", default="auto", choices=IMPLS,
                    help="compressed matmul impl (default: auto)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache with prefix reuse (serve/pager.py)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per cache page (must divide max_len)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page pool size (0 = auto: full capacity)")
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=not args.full)
    if cfg.family == "encdec":
        ap.error(f"{args.arch}: the engine's decode_step takes no encoded "
                 "source (enc_out); serve it with EncDecLM.encode and "
                 "decode_step directly")
    model = build_model(cfg, device=dev)
    if args.plan:
        from repro_torch.launch.prune import prune_arch

        plan = PrunePlan.load(args.plan)
        print(f"pruning with recipe {args.plan} ({len(plan.rules)} rules)…")
        pruned, report, _ = prune_arch(args.arch, plan,
                                       reduced=not args.full, log=None,
                                       device=dev)
        params = compress_params(pruned, report.masks, plan=report.plan)
        comp, dense = compressed_bytes(params)
        if dense:
            print(f"compressed weight bytes: {comp / dense:.3f} of their "
                  f"dense bytes (non-n:m cells stay dense)")
        for row in report.rule_rollup():
            print(f"  rule {row['rule']:3d} {str(row['match']):20s} "
                  f"{row['tag']:18s} layers={row['layers']:3d} "
                  f"sparsity={row['mean_sparsity']:.3f}")
    elif args.nm:
        from repro_torch.launch.prune import prune_arch

        print("pruning 2:4 with Thanos first…")
        pruned, report, _ = prune_arch(
            args.arch, PruneConfig(method="thanos", pattern="nm", n=2, m=4,
                                   block_size=64),
            reduced=not args.full, log=None, device=dev)
        params = compress_params(pruned, report.masks, 2, 4)
        comp, dense = compressed_bytes(params)
        print(f"compressed weight bytes: {comp / dense:.3f} of dense")
    else:
        params = model.init(torch.Generator(device=dev).manual_seed(0))

    max_len = args.prompt_len + args.max_new + 8
    if args.paged and max_len % args.page_size:
        max_len += args.page_size - max_len % args.page_size   # round up
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=args.slots, max_len=max_len, nm_impl=args.nm_impl,
        paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages))
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        engine.submit(Request(uid, rng.integers(0, cfg.vocab_size,
                                                size=args.prompt_len),
                              max_new=args.max_new))
    t0 = time.perf_counter()
    done = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    st = engine.stats
    occ = (st["busy_slot_steps"] / (st["decode_steps"] * args.slots)
           if st["decode_steps"] else 0.0)
    print(f"{len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s on {dev}; {st['decode_steps']} decode "
          f"steps, slot occupancy {occ:.2f})")
    if args.paged:
        print(f"  paged: hwm {st['pages_hwm']} pages of "
              f"{engine.pager.pool.num_pages - 1}, "
              f"{st['page_faults']} faults, {st['cow_copies']} COW, "
              f"{st['prefix_hit_tokens']} prefix-hit tokens, "
              f"{st['preemptions']} preemptions")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out}")


if __name__ == "__main__":
    main()
