"""The control — the reference computed one precision below the
configuration's (float8 for bfloat16), in the program's place — comes out
not correct by the cell's own limits, judged as a run judges the
program, at a size a test run holds.  On the card it is read at the
cell's own size by ``bench/control.py`` (the readings in ``PERF.md``)."""
import pytest

from tiny import run_cell


@pytest.mark.parametrize("cell", ["qwen3moe-gen", "mistral-prune"])
def test_control_fails_a_limit(cell):
    res = run_cell(cell, control=True)
    readings = res["_readings"]
    assert res["correct"] is True
    ctl = res["_control"]
    assert ctl["correct"] is False, (ctl, readings)
    assert set(ctl["checks"]) == set(res["checks"])
    for name, c in ctl["checks"].items():
        assert c["value"] == readings["control_" + name]
        assert c["limit"] == res["checks"][name]["limit"]
