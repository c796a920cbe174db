"""What every cell of the benchmark shares: the spec files, the card, the
result line, the import guard and the published peaks.

The harness lives in ``bench/``.  It measures the PyTorch port
(``src/repro_torch``) only.  Nothing here imports JAX or the JAX package
(``repro``): ``forbidden_modules`` compares whole top-level module names,
since the port's own name begins with the JAX package's.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    """``bench/<kind>/<name>.json`` — a configuration, a traffic mix or a
    cell's limits."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def judge(readings: dict, limits: dict, names, prefix: str = "") -> list:
    """The numbers compared for ``correct``: ``(name, value, limit)`` of
    each of ``names``, read from ``readings`` under ``prefix + name`` (the
    program's with no prefix, the control's under ``control_``)."""
    return [(name, readings[prefix + name], float(limits[name]))
            for name in names]


def within(checks: list) -> bool:
    """``correct``: every number compared at or under its limit."""
    return all(v <= lim for _, v, lim in checks)


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def gpu_lines() -> list:
    """nvidia-smi's name, clocks and power of each card, or why not."""
    query = ("name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi not read: {exc}"]
    lines = out.stdout.strip().splitlines()
    return [f"{query}: {ln}" for ln in lines] or ["nvidia-smi: no output"]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
