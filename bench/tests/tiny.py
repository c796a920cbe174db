"""Tiny stand-ins for the cells, to drive the harness's code paths on the
CPU: the configurations' widths cut to a few dozen and the mixes to a few
requests or sequences.  Runs go through ``bench/run.py``'s ``execute``
in a child process, so that its ``sys.modules`` can be read."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

MODEL = {"qwen3-moe-30b-a3b": dict(d_model=64, num_heads=4, num_kv_heads=2,
                                   head_dim=16, vocab_size=512, num_experts=8,
                                   num_experts_per_tok=2, moe_d_ff=32,
                                   capacity_factor=4.0, dtype="float32"),
         "mistral-large-123b": dict(d_model=64, num_heads=4, num_kv_heads=2,
                                    head_dim=16, d_ff=128, vocab_size=512,
                                    dtype="float32")}
MIX = {"serve_closed": dict(clients=4, slots=4, max_len=48, rounds=200,
                            prompt={"law": "uniform", "min": 4, "max": 8},
                            output={"law": "log_uniform", "min": 4, "max": 16},
                            trace={"start_s": 0.2, "seconds": 0.2}),
       "prune_job": dict(sequences=8, seq_len=32, batch=4,
                         trace={"block": 0})}
LAYERS = {"serve_closed": 2, "prune_job": 48}
SECONDS = {"serve_closed": 1.5, "prune_job": 0.3}

CHILD = r"""
import json, sys, time
sys.path[:0] = [ROOT, SRC]
import torch
from bench import run as B
from bench.lib import common
args = json.loads(sys.argv[1])
for target, name, value in args.get("patches", []):
    import importlib
    mod = importlib.import_module(target)
    exec(value, {"mod": mod, "torch": torch})
bench = common.load_benchmark(__import__("pathlib").Path(ROOT))
ctx = B.make_context(bench, args["workload"], args["seed"], args["seconds"],
                     args["trace"], torch, torch.device("cpu"),
                     control=args.get("control", False))
ctx.conf = dict(ctx.conf, model=dict(ctx.conf["model"], **args["model"]))
ctx.mix = dict(ctx.mix, **args["mix"])
res = B.execute(ctx, bench, time.perf_counter())
res["_forbidden"] = common.forbidden_modules()
print(json.dumps(res, default=str))
"""


def run_cell(workload: str, *, trace: bool = False, seconds: float = 0.0,
             seed: int = 2 ** 31 + 12345, root: Path = ROOT, control=False,
             patches=(), timeout: float = 600) -> dict:
    """Run a cell of ``root``'s benchmark at tiny size on the CPU → its
    result line (a dict), with ``_forbidden``: the JAX modules loaded."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = json.loads((root / "bench" / "configs" /
                       f"{wl['config']}.json").read_text())
    mix = json.loads((root / "bench" / "traffic" /
                      f"{wl['traffic']}.json").read_text())
    model = dict(MODEL[conf["arch"]], num_layers=LAYERS[mix["kind"]])
    args = {"workload": workload, "seed": seed,
            "seconds": seconds or SECONDS[mix["kind"]] * (4 if trace else 1),
            "trace": trace, "model": model, "mix": MIX[mix["kind"]],
            "control": control, "patches": list(patches)}
    code = CHILD.replace("ROOT", repr(str(root))).replace(
        "SRC", repr(str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code, json.dumps(args)],
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(root))
    if out.returncode != 0:
        raise RuntimeError(f"cell run failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])
