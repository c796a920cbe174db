"""repro-lint for the port: static enforcement of its serve, fault and
dtype invariants (port of ``repro/analysis``).

Two layers:

* **AST rules** (`repro_torch.analysis.rules`) — a visitor-based rule
  engine over every module in ``src/repro_torch``: jit-purity,
  fault-hook-cost, serve-never-decompresses, atomic-writes,
  recompile-hazards, dtype-discipline, import-hygiene (JAX's seven;
  jit-purity and recompile-hazards read the code a CUDA graph captures).
  Findings support per-line ``# lint: disable=<rule>`` suppressions and a
  baseline (``analysis/baseline.json``, empty).

* **Abstract-eval contracts** (`repro_torch.analysis.contracts`) — builds
  the full model zoo × serve representations (dense, NmCompressed,
  NmStackedCompressed, paged/contiguous) on the ``meta`` device and checks
  the structural decode/cache/sharding contracts with zero FLOPs.

CLI: ``python -m repro_torch.analysis``; no device is needed.
"""
from __future__ import annotations

from repro_torch.analysis.engine import RepoIndex, run_rules
from repro_torch.analysis.findings import (Baseline, Finding,
                                           findings_from_json,
                                           findings_to_json)
from repro_torch.analysis.rules import RULES

__all__ = [
    "Baseline", "Finding", "RULES", "RepoIndex", "run_rules",
    "findings_from_json", "findings_to_json",
]
