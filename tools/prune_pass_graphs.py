#!/usr/bin/env python3
"""The prune job's block passes eager and from CUDA graphs, at several
calibration sizes, on one NVIDIA GPU.

    python3 tools/prune_pass_graphs.py      # from the root of a checkout

tinyllama-1.1b at full width, its first BLOCKS blocks, from a seeded
random init.  ``core.schedule.collect_hessian_stats`` is the prune's
block passes and nothing else: pass 1 of each block over every
calibration batch (the tape; K1 accumulates each linear's Hessian
outside the graphs), then pass 2.  It runs once with no graph scope
seen (every block pass inline, eager) and once in its scope (each pass
captured at its key's second use, replayed after), in the order eager,
graphs, graphs, eager, for each calibration set of CALIB: the prune
CLI's default (2 batches a block), 16 batches of 128-token rows, and the
paper's 128 sequences of 2 048 tokens as 16 batches of 8 and as 128
batches of one (a forward a sequence, as SparseGPT's reference code
runs them).  Prints the seconds of each run, its graphs, replays and
capture seconds, and whether the traces equal the eager run's bitwise.
"""
from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

BLOCKS = 4
# (num_samples, seq_len, batch) of each calibration set
CALIB = [(16, 128, 8), (128, 128, 8), (128, 2048, 8), (128, 2048, 1)]


def run(params, adapter, batches, graphed: bool) -> tuple:
    """collect_hessian_stats → (seconds, its scope's stats, the stats)."""
    import torch

    from repro_torch.core.schedule import collect_hessian_stats
    from repro_torch.util import graphs

    @contextlib.contextmanager
    def eager():                    # a scope no call sees: all inline
        yield graphs.Scope()

    scope = graphs.scope
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if not graphed:
            graphs.scope = eager
        with graphs.scope() as sc:
            stats = collect_hessian_stats(params, adapter, batches)
        torch.cuda.synchronize()
    finally:
        graphs.scope = scope
    return time.perf_counter() - t0, sc.stats(), stats


def main() -> None:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import calibration_batches
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.models.model_builder import ModelAdapter, build_model

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    dev = resolve_device("cuda")
    print(f"gpu: {cs.gpu_line()}, torch {torch.__version__}", flush=True)
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    cfg = get_config("tinyllama-1.1b").replace(num_layers=BLOCKS)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    adapter = ModelAdapter(model)
    for n, seq, batch in CALIB:
        batches = calibration_batches(cfg, num_samples=n, seq_len=seq,
                                      batch=batch, device=dev)
        passes = 2 * BLOCKS * len(batches)
        runs = [run(params, adapter, batches, g)
                for g in (False, True, True, False)]
        want = runs[0][2]
        same = all(r[2] == want for r in runs)
        line = "; ".join(
            f"{'graphs' if g else 'eager'} {secs:.4f} s "
            f"({1e3 * secs / passes:.3f} ms a pass"
            + (f", {st['graphs']} graphs, {st['replays']} replays, capture "
               f"{st['capture_s']:.4f} s" if g else "") + ")"
            for (secs, st, _), g in zip(runs, (False, True, True, False)))
        print(f"{n} × {seq} tokens in {len(batches)} batches of {batch}, "
              f"{BLOCKS} blocks, {passes} block passes: {line}; traces "
              f"bitwise equal: {same}", flush=True)
        cs.check(same, "a graphed pass's Hessian traces differ from the "
                 "eager pass's")
        del batches, runs, want
        torch.cuda.empty_cache()
    print("OK")


if __name__ == "__main__":
    main()
