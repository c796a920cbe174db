"""On a card: each cell's command as the benchmark runs it, with a short
window: exit 0, a well-formed last line naming the card, correct."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert res["correct"] is True


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
