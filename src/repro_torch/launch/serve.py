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

``--scheduler wave`` serves lock-step waves instead of continuous slots.
``--supervise`` (implied by any of ``--fault-plan``, ``--snapshot-every``,
``--retry-budget``) wraps the engine in the fault supervisor
(``serve/supervisor.py``): periodic snapshots, rollback and bit-identical
replay on decode/prefill/pager faults, retry budgets with poison-request
quarantine.  ``--fault-plan`` arms a deterministic fault schedule — a JSON
file or the compact ``site@start[xburst][~uid][+payload]`` syntax, e.g.
``--fault-plan 'decode_logits@5;pager_fault_in@9x8'``.  ``--deadline``
attaches per-request budgets, ``--max-queued`` bounds admission (HTTP 503
+ Retry-After past it); ``--http`` serves the SSE front end on
127.0.0.1 and replays the request mix over HTTP with Poisson arrivals,
finishing in-flight requests for up to ``--drain-timeout`` seconds at
shutdown.
"""
from __future__ import annotations

import argparse
import asyncio
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
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "wave"],
                    help="slot-level continuous batching (default) or the "
                         "wave scheduler")
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
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP/SSE and drive the request mix as "
                         "a Poisson arrival trace against the live server")
    ap.add_argument("--http-port", type=int, default=0,
                    help="listen port (0 = ephemeral)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none)")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the engine in the fault supervisor "
                         "(serve/supervisor.py)")
    ap.add_argument("--fault-plan", default="",
                    help="arm a fault plan: JSON file path or compact "
                         "'site@start[xburst][~uid][+payload];…' spec "
                         "(implies --supervise)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="pumps between supervisor snapshots (0 = default; "
                         "> 0 implies --supervise)")
    ap.add_argument("--retry-budget", type=int, default=0,
                    help="faults a request survives before quarantine "
                         "(0 = default; > 0 implies --supervise)")
    ap.add_argument("--max-queued", type=int, default=0,
                    help="bound the request queue; past it submissions are "
                         "rejected (HTTP: 503 + Retry-After)")
    ap.add_argument("--drain-timeout", type=float, default=5.0,
                    help="seconds to finish in-flight requests at HTTP "
                         "shutdown (drain mode)")
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    args.supervise = (args.supervise or bool(args.fault_plan)
                      or args.snapshot_every > 0 or args.retry_budget > 0)

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
        batch_slots=args.slots, max_len=max_len,
        scheduler=("continuous" if args.http or args.supervise
                   else args.scheduler),
        nm_impl=args.nm_impl, paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, max_queued=args.max_queued))
    supervisor = _make_supervisor(engine, args) if args.supervise else None
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    if args.http:
        _serve_http(engine, args, prompts, supervisor)
        return

    runner = supervisor if supervisor is not None else engine
    for uid, prompt in enumerate(prompts):
        runner.submit(Request(uid, prompt, max_new=args.max_new,
                              deadline_s=args.deadline))
    t0 = time.perf_counter()
    done = runner.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if supervisor is not None:
        st = supervisor.stats
        print(f"supervisor: state={supervisor.state} "
              f"recoveries={st['recoveries']} faults={st['faults']} "
              f"snapshots={st['snapshots']} "
              f"quarantined={supervisor.quarantined}")
    tokens = sum(len(r.out) for r in done)
    st = engine.stats
    occ = (st["busy_slot_steps"] / (st["decode_steps"] * args.slots)
           if st["decode_steps"] else 0.0)
    print(f"{len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s on {dev}; {engine.cfg.scheduler}: "
          f"{st['decode_steps']} decode steps, slot occupancy {occ:.2f})")
    if args.paged:
        print(f"  paged: hwm {st['pages_hwm']} pages of "
              f"{engine.pager.pool.num_pages - 1}, "
              f"{st['page_faults']} faults, {st['cow_copies']} COW, "
              f"{st['prefix_hit_tokens']} prefix-hit tokens, "
              f"{st['preemptions']} preemptions")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out}")


def _make_supervisor(engine, args):
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.supervisor import Supervisor, SupervisorConfig

    plan = FaultPlan.load(args.fault_plan) if args.fault_plan else None
    kw = {}
    if args.snapshot_every > 0:
        kw["snapshot_every"] = args.snapshot_every
    if args.retry_budget > 0:
        kw["retry_budget"] = args.retry_budget
    if plan is not None:
        print(f"fault plan armed: {len(plan.specs)} spec(s), "
              f"seed {plan.seed}")
    return Supervisor(engine, SupervisorConfig(**kw), faults=plan)


def _serve_http(engine, args, prompts, supervisor=None):
    """Start the SSE front end and replay the mix with Poisson arrivals."""
    from repro_torch.serve.frontend import HttpFrontend, drive_http_trace

    rng = np.random.default_rng(1)
    gaps = rng.exponential(scale=0.05, size=len(prompts))
    trace = [{"uid": i, "t": float(gaps[:i + 1].sum()), "prompt": p,
              "max_new": args.max_new, "deadline_s": args.deadline}
             for i, p in enumerate(prompts)]

    async def main():
        fe = HttpFrontend(engine, supervisor=supervisor, port=args.http_port)
        await fe.start()
        print(f"SSE front end on http://127.0.0.1:{fe.port} — replaying "
              f"{len(trace)} Poisson arrivals…")
        t0 = time.perf_counter()
        results = await drive_http_trace("127.0.0.1", fe.port, trace)
        dt = time.perf_counter() - t0
        drained = await fe.stop(drain_timeout_s=args.drain_timeout)
        tokens = sum(len(r["tokens"]) for r in results)
        errors = [r["final"].get("error") for r in results
                  if r["final"].get("error")]
        print(f"{len(results)} streams, {tokens} tokens in {dt:.2f}s "
              f"({tokens / dt:.1f} tok/s over HTTP; "
              f"{len(errors)} errored: {errors[:4]}; "
              f"drained={'yes' if drained else 'timeout'})")
        if supervisor is not None:
            st = supervisor.stats
            print(f"supervisor: state={supervisor.state} "
                  f"recoveries={st['recoveries']} faults={st['faults']} "
                  f"quarantined={supervisor.quarantined}")
        for r in results[:4]:
            print(f"  req {r['uid']}: {r['tokens']}")

    asyncio.run(main())


if __name__ == "__main__":
    main()
