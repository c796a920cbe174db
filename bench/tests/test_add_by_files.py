"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as new files and new entries only: no file the harness
already has is edited.  Here that is done in a copy of the benchmark,
and the new cell runs."""
import json
import shutil
from pathlib import Path

from tiny import run_cell

ROOT = Path(__file__).resolve().parents[2]


def test_a_new_cell_from_new_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    b = tmp_path / "bench"
    conf = json.loads((b / "configs" / "qwen3-moe-30b-a3b.json").read_text())
    conf["model"]["num_layers"] = 4
    conf["reduced"] = {"num_layers": "48 -> 4: a dummy for this test"}
    (b / "configs" / "dummy-moe.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "gen-closed-64.json").read_text())
    mix.update(clients=3, prompt={"law": "uniform", "min": 5, "max": 9})
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (b / "cells" / "dummy-gen.json").write_text(
        (b / "cells" / "qwen3moe-gen.json").read_text())
    (b / "metrics" / "dummy_pumps.py").write_text(
        '"""Pumps in the window (a dummy reader)."""\n\n\n'
        'def read(rec):\n    return float(len(rec["pumps"]))\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy-moe", "source": "x",
                            "file": "bench/configs/dummy-moe.json",
                            "reduced": ["num_layers"], "why": "test"})
    spec["workloads"].append({"name": "dummy-gen", "config": "dummy-moe",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if "qwen3moe-gen" in m.get("workloads", []):
            m["workloads"].append("dummy-gen")
    spec["per_layer"].append({"name": "dummy_pumps", "unit": "pumps",
                              "better": "higher", "source": "program_span",
                              "layer": "engine", "moves": "output_tok_s",
                              "workloads": ["dummy-gen"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run_cell("dummy-gen", root=tmp_path)
    assert res["correct"] and "output_tok_s" in res["metrics"]
    res = run_cell("dummy-gen", root=tmp_path, trace=True)
    assert res["metrics"]["dummy_pumps"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before               # nothing that was there changed
