#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration (``bench/configs/<config>.json``) and
a traffic mix (``bench/traffic/<mix>.json``) whose ``kind`` names the
driver (``bench/drivers/<kind>.py``); its limits are
``bench/cells/<workload>.json``.  The driver sets up, measures for
``--seconds`` and checks what the timed path produced against the plain
reference.  The last line of standard output is one JSON object: the
end-to-end metrics (``--trace 0``) or the per-layer ones, each read by
``bench/metrics/<metric>.py`` (``--trace 1``).  The last lines of standard
error are the numbers compared, each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.lib import common  # noqa: E402
from bench.lib.trace import breakdown  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, the card
    and a list for its set-up lines."""

    torch: object
    device: object
    workload: dict
    conf: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    control: bool = False
    setup_lines: list = dataclasses.field(default_factory=list)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    path = common.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def make_context(bench: dict, workload: str, seed: int, seconds: float,
                 trace: bool, torch, device, control: bool = False
                 ) -> Context:
    wl = common.find(bench["workloads"], workload, "workload")
    conf = common.load_json("configs", wl["config"])
    mix = common.load_json("traffic", wl["traffic"])
    limits = common.load_json("cells", workload)
    return Context(torch=torch, device=device, workload=wl, conf=conf,
                   mix=mix, limits=limits, seed=seed, seconds=seconds,
                   trace=trace, control=control)


def execute(ctx: Context, bench: dict, t_start: float) -> dict:
    """Drive the cell and build its result line (a dict)."""
    torch = ctx.torch
    driver = importlib.import_module(f"bench.drivers.{ctx.mix['kind']}")
    out = driver.run(ctx)
    setup_s = out["t_open"] - t_start
    found = common.forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark and the port "
                         "may import neither JAX nor the JAX package")
    name = ctx.workload["name"]
    metrics = {}
    if not ctx.trace:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, name):
                v = load_reader(m["name"])(out["records"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": common.within(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    summary = out["records"].get("trace")
    if ctx.trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = out["records"]["slice_s"]
        result["breakdown"] = breakdown(summary)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out["checks"]}
    if out.get("control_checks") is not None:
        # the control's numbers, judged by the same limits: not correct
        ctl = out["control_checks"]
        result["_control"] = {"correct": common.within(ctl),
                              "checks": {n: {"value": v, "limit": lim}
                                         for n, v, lim in ctl}}
    result["_readings"] = out.get("readings", {})
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = common.load_benchmark()
    wl = common.find(bench["workloads"], args.workload, "workload")
    mix = common.load_json("traffic", wl["traffic"])
    if "alloc_conf" in mix:
        # the caching allocator's settings, read at its first allocation
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = mix["alloc_conf"]
    if not torch.cuda.is_available():
        common.log("torch.cuda.is_available() is False: no card, no result")
        return 2
    if torch.cuda.device_count() < int(wl["chips"]):
        common.log(f"the cell asks for {wl['chips']} cards, "
                   f"{torch.cuda.device_count()} found: no result")
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    device = resolve_device("cuda")
    cached = {n: _build._lib_path(n).exists() for n in _build.SOURCES}
    build_s = _build.build_all()
    ctx = make_context(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), torch, device)
    result = execute(ctx, bench, T_START)
    for line in common.gpu_lines():
        print(line)
    print(f"kernel build cache {cached}, build {build_s:.2f} s")
    for line in ctx.setup_lines:
        print(line)
    print(f"readings {json.dumps(result.pop('_readings'))}")
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        common.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
