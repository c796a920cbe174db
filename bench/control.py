#!/usr/bin/env python3
"""Read a cell's numbers compared for ``correct`` and its control's, on the
card, seed by seed: each seed runs the cell as ``bench/run.py`` does (a
window of ``--seconds``), then the reference in float32 and, in the
program's place, the control — the reference computed one precision below
the configuration's (float8 for bfloat16, ``decoder_lm.fp8_cast``).

    python3 bench/control.py --workload <name> --seconds <s> --seeds <n> ...

One JSON line a seed: the cell's readings (``gap`` for a served cell, the
program's against the reference) and the control's, and each side's
numbers compared, judged by the cell's limits as ``bench/run.py`` judges
the program's: ``correct`` (the program's, true) and ``control_correct``
(the control's, false).  It exits with 1 where a seed reads otherwise.
The benchmark's own runs never run the control.  Limits in
``bench/cells/<workload>.json`` are set from these readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import run as B  # noqa: E402
from bench.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import os

    import torch

    bench = common.load_benchmark()
    wl = common.find(bench["workloads"], args.workload, "workload")
    mix = common.load_json("traffic", wl["traffic"])
    if "alloc_conf" in mix:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = mix["alloc_conf"]
    if not torch.cuda.is_available():
        common.log("no card")
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    device = resolve_device("cuda")
    _build.build_all()
    wrong = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        ctx = B.make_context(bench, args.workload, seed, args.seconds, False,
                             torch, device, control=True)
        res = B.execute(ctx, bench, t0)
        ctl = res["_control"]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": ctl["correct"],
                          "checks": res["checks"],
                          "control_checks": ctl["checks"],
                          "readings": res["_readings"],
                          "metrics": res["metrics"]}), flush=True)
        for name, c in ctl["checks"].items():
            common.log(f"seed {seed} control {name} = {c['value']!r} "
                       f"(limit {c['limit']!r})")
        wrong += (not res["correct"]) + ctl["correct"]
        torch.cuda.empty_cache()
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
