#!/usr/bin/env python3
"""Where a K3 launch at decode occupancy spends its time, on one NVIDIA GPU.

    python3 tools/k3_trace.py          # from the root of a checkout, on a card

qwen3-moe-30b-a3b's two full-width expert leaves (bf16 2:4, 4-bit indices)
under the wrapper's plan, x from the port's own ``moe_ffn`` dispatch of
T = 1 and 4 tokens and an all-zero x (no active group: the vote, the
zero fill and the product's fixed cost alone).  For each: the device time
of one call from CUDA-graph replays (CUDA events), then a torch.profiler
trace of 20 back-to-back calls — the medians of the vote kernel's and the
product kernel's durations, of the product's start after the vote's start
(it is the vote's programmatic dependent, so it starts early and waits)
and of the span from the vote's start to the product's end.
"""
from __future__ import annotations

import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

CALLS = 20


def kernel_spans(trace: dict) -> list:
    """[(vote start, vote dur, product start, product dur)] in µs, one a
    call, from a chrome trace's kernel events."""
    ev = sorted((e for e in trace["traceEvents"]
                 if e.get("cat") == "kernel"
                 and "nm_stacked" in e.get("name", "")),
                key=lambda e: e["ts"])
    votes = [e for e in ev if "vote" in e["name"]]
    prods = [e for e in ev if "sp_dec" in e["name"]]
    return [(v["ts"], v["dur"], p["ts"], p["dur"])
            for v, p in zip(votes, prods)]


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms, gpu_line
    from k3_plan_sweep import Leaf, dispatch_inputs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import nm_spmm as K

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config("qwen3-moe-30b-a3b")
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    print(f"gpu: {gpu_line()}", flush=True)
    leaves = (Leaf(gen, dev, E, f, d, 4), Leaf(gen, dev, E, d, f, 4))
    xs = dispatch_inputs(gen, dev, (leaves[0].pk, leaves[1].pk))
    for li, leaf in enumerate(leaves):
        cases = [(f"T={T}", xs[T][li]) for T in (1, 4)]
        cases.append(("all-zero x", torch.zeros_like(xs[1][li])))
        for what, x in cases:
            groups = int(K.active_row_groups(x).sum())
            leaf.rotate(max(groups, 1))
            plan = K._k3_operands(x, leaf.pk.values, leaf.pk.indices, 2, 4,
                                  leaf.b, 4)[3]
            ring = iter(range(10**9))

            def call():
                v, i = leaf.copies[next(ring) % len(leaf.copies)]
                K._launch_k3(x, v, i, 2, 4, leaf.b, 4, plan)

            ms = device_ms(call, 4 * len(leaf.copies))
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    call()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "trace.json"
                prof.export_chrome_trace(str(path))
                spans = kernel_spans(json.loads(path.read_text()))
            if not spans:
                print(f"{what} ({E}, {leaf.c}, {leaf.b}): no device "
                      f"kernels in the trace; graph replay {ms:.4f} ms")
                continue
            med = statistics.median
            print(f"{what} ({E}, {leaf.c}, {leaf.b}) {groups} active groups,"
                  f" plan {plan}: graph replay {1e3 * ms:.1f} µs a call; "
                  f"traced ({len(spans)} calls, medians) vote "
                  f"{med(s[1] for s in spans):.1f} µs, product "
                  f"{med(s[3] for s in spans):.1f} µs, its start "
                  f"{med(s[2] - s[0] for s in spans):+.1f} µs after the "
                  f"vote's, vote start → product end "
                  f"{med(s[2] + s[3] - s[0] for s in spans):.1f} µs; weight "
                  f"bytes {groups * leaf.per}, their time at 3.35 TB/s "
                  f"{groups * leaf.per / 3.35e6:.1f} µs", flush=True)
            del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
