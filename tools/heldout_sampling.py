#!/usr/bin/env python3
"""Seconds of one held-out slice draw, per vocabulary of the port's archs,
against numpy's host draw of the same tokens.

    python3 tools/heldout_sampling.py        # from a checkout, on a card

``heldout_loss`` scores 4 batches × 8 × 256 tokens of the synthetic corpus
(seed 9999).  ``calibration_batches`` draws them on the card through
``data/pipeline.chain`` in float64 (one bigram step over the whole
vocabulary a position) from numpy's uniforms, so they are the tokens of
``SyntheticCorpus.sample`` on the host; ``data/pipeline._sample`` keeps
them, so every later call on the same (vocabulary, seeds, shape, device)
draws nothing.  For each distinct vocabulary of ``registry.ARCHS`` this
prints the seconds of a cold draw and of the cached call on the card,
and of numpy's host draw of the first batch with the tokens compared.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch

    dev = resolve_device("cuda")
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
            got = pipeline.calibration_batches(
                cfg, num_samples=32, seq_len=256, batch=8, seed=9999,
                device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = pipeline.SyntheticCorpus(vocab_size=vocab).sample(
            np.random.default_rng([9999, 0]), 8, 256)
        host = time.perf_counter() - t0
        same = np.array_equal(got[0]["tokens"].cpu().numpy(), want)
        print(f"vocab {vocab:7d} ({', '.join(archs)}): held-out draw on "
              f"{torch.cuda.get_device_name(dev)} {times[0]:.2f} s cold, "
              f"{times[1]:.4f} s cached; numpy's host draw of batch 0 "
              f"{host:.2f} s, tokens equal {same}")


if __name__ == "__main__":
    main()
