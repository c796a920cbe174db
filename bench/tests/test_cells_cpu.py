"""Each cell's code path, run at a tiny size on the CPU through
``bench/run.py``'s ``execute``: the result line is well formed, the
checks pass, and the run loaded neither JAX nor the JAX package."""
import json
from pathlib import Path

import pytest

from tiny import run_cell

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                  .read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _wanted(cell: str, kind: str) -> set:
    return {m["name"] for m in SPEC[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_line_is_well_formed(cell, trace):
    res = run_cell(cell, trace=bool(trace))
    assert res["_forbidden"] == []
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-2:] == ["_readings", "_forbidden"]   # checks before
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["device"]["count"] == 1
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
    got = set(res["metrics"])
    if not trace:
        assert got == _wanted(cell, "end_to_end")
    else:
        # the device readers find nothing on the CPU and leave their
        # metric out; the others are there
        assert got <= _wanted(cell, "per_layer") and got
        assert "busy_s" in res["device"] and "window_s" in res["device"]
    for m in res["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
