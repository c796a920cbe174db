"""``BENCHMARK.json`` and the files it names: every name, unit and key in
the allowed set, every file where the harness looks for it, each
configuration's widths those of the port's registry apart from what it
lists under ``reduced``, and no import of JAX or the JAX package."""
import ast
import json
import re
from pathlib import Path

import pytest

from bench.lib import common

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|moe_d_ff|head_dim|"
                   r"num_experts_per_tok|vocab_size|num_heads|num_kv_heads|"
                   r"num_experts)$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in
               ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert "roofline" not in m["name"] or m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = SPEC["end_to_end"]
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mine = [m for m in e2e if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
        for kind, key in (("configs", "config"), ("traffic", "traffic")):
            assert (BENCH / kind / f"{w[key]}.json").is_file()
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_widths_are_the_registry_s(entry):
    from repro_torch.configs.registry import get_config

    conf = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("bench/")
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])
    assert not any(WIDTH.search(k) for k in entry["reduced"])
    reg = get_config(conf["arch"])
    for key, value in conf["model"].items():
        if key in entry["reduced"] or key in conf["assumed"]:
            continue
        assert getattr(reg, key) == value, key
    for key in entry["reduced"]:
        assert getattr(reg, key) != conf["model"][key]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_reference_of_its_own(path):
    mods = _imports(path)
    assert not mods & set(common.FORBIDDEN), path
    if "reference" in path.parts:
        assert "repro_torch" not in mods and "bench" not in mods, path


def test_forbidden_names_are_whole_top_level_names():
    found = common.forbidden_modules({"repro_torch": 1, "repro_torch.core": 1,
                                      "jaxtyping": 1, "numpy": 1})
    assert found == []
    assert common.forbidden_modules({"repro.core": 1, "jax": 1}) == \
        ["jax", "repro.core"]
