#!/usr/bin/env python3
"""Host seconds of one held-out slice draw, per vocabulary of the port's
archs — what ``heldout_loss`` no longer spends on a second call.

    python3 tools/heldout_sampling.py       # from the root of a checkout

``heldout_loss`` scores 4 batches × 8 × 256 tokens of the synthetic corpus
(seed 9999).  The draws are made on the host, one bigram step over the whole
vocabulary a position, and ``data/pipeline._sample`` keeps them, so every
later call on the same (vocabulary, seeds, shape) draws nothing.  For each
distinct vocabulary of ``registry.ARCHS`` this prints the seconds of a cold
draw and of the cached call; a phase that takes k held-out losses on one
vocabulary saves (k − 1) cold draws.  Needs no GPU.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402


def main() -> None:
    seen = {}
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        seen.setdefault(cfg.vocab_size, []).append(arch)
    for vocab, archs in sorted(seen.items()):
        cfg = registry.get_config(archs[0]).replace(family="dense")
        pipeline._sample.cache_clear()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            pipeline.calibration_batches(cfg, num_samples=32, seq_len=256,
                                         batch=8, seed=9999, device="cpu")
            times.append(time.perf_counter() - t0)
        print(f"vocab {vocab:7d} ({', '.join(archs)}): held-out draw "
              f"{times[0]:.2f} s cold, {times[1]:.4f} s cached")


if __name__ == "__main__":
    main()
