#!/usr/bin/env python3
"""Time K1's eager calls beside its replayed ones at every K1 row of
``chip_smoke``'s phase 5, for one checkout, so that two checkouts can be
compared on one card in one call.

    python3 tools/k1_eager_gap.py                      # this checkout
    python3 tools/k1_eager_gap.py --src OTHER --label parent

``--src`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one); the timing helpers are this checkout's
(``chip_smoke.device_ms`` and ``eager_runs``).  Rows: bf16 x (1 024, b) at
every b the card paths launch K1 at, and the MoE path's capacity buffers
(80, 2 048) and (80, 768) with a row mask.  At each: the device time of one
call replayed from a CUDA graph (``ms``), and the time of one eager call in
each of five runs of 10 back-to-back calls.  The gap is eager − ``ms``: as
the first run (what ``chip_smoke`` reports as ``eager_ms``) and as the
median of the five.  Run it on both checkouts in one call, in turns (A, B,
B, A), and compare the gaps row by row.  The results also go to
``chiprun_out/k1_eager_gap_<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rows() -> list:
    from k1_plan_sweep import MASKED, PATH_B

    return [(1024, b, False) for b in PATH_B] + [(t, b, True)
                                                  for t, b in MASKED]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="root of the checkout whose K1 is timed")
    ap.add_argument("--label", default="this",
                    help="name of the run in the output file")
    args = ap.parse_args()
    sys.path[:0] = [str(args.src.resolve() / "src"), str(ROOT),
                    str(ROOT / "tools")]

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import device_ms, eager_runs, gpu_line
    from repro_torch.device import resolve_device
    from repro_torch.kernels import hessian_accum as K1

    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gpu: {gpu_line()}; K1 from {Path(K1.__file__).resolve()}")
    out = []
    for tokens, b, masked in rows():
        x = torch.randn((tokens, b), generator=gen, device=dev).to(
            torch.bfloat16)
        valid = (torch.rand((tokens,), generator=gen, device=dev) < 0.6
                 if masked else None)
        acc = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
               torch.zeros((), device=dev)]

        def call():
            K1.hessian_update_cuda(x, valid, *acc)

        ms = device_ms(call, 10)
        runs = eager_runs(call, 10, 5)
        r = {"tokens": tokens, "b": b, "masked": masked, "ms": ms,
             "eager_runs_ms": runs,
             "gap_us": 1e3 * (runs[0] - ms),
             "gap_median_us": 1e3 * (statistics.median(runs) - ms)}
        out.append(r)
        tag = " + row mask" if masked else ""
        print(f"{args.label}: x ({tokens}, {b}){tag}: replay {ms:.4f} ms, "
              f"eager {runs[0]:.4f} ms (gap {r['gap_us']:+.1f} µs), median "
              f"of five {statistics.median(runs):.4f} ms (gap "
              f"{r['gap_median_us']:+.1f} µs)", flush=True)
        del x, valid, acc
        torch.cuda.empty_cache()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"k1_eager_gap_{args.label}.json").write_text(json.dumps(
        {"gpu": gpu_line(), "src": str(args.src), "rows": out}, indent=1))


if __name__ == "__main__":
    main()
