"""repro-lint CLI for the port (the JAX package's flags).

    python -m repro_torch.analysis              # report all findings (text)
    python -m repro_torch.analysis --check      # CI gate: exit 1 on findings
                                                # above the committed baseline
    python -m repro_torch.analysis --json out.json
    python -m repro_torch.analysis --rules dtype-discipline,atomic-writes
    python -m repro_torch.analysis --no-contracts   # AST layer only
    python -m repro_torch.analysis --update-baseline
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch.analysis.engine import RepoIndex, run_rules
from repro_torch.analysis.findings import Baseline, findings_to_json
from repro_torch.analysis.rules import RULES


BASELINE = "src/repro_torch/analysis/baseline.json"


def _default_root() -> str:
    """Repo root: .../src/repro_torch/analysis/__main__.py -> three up."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint",
        description="AST rules + abstract-eval contracts for "
                    "src/repro_torch")
    ap.add_argument("--root", default=_default_root(),
                    help="repo root (contains src/repro_torch)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any finding is above the baseline")
    ap.add_argument("--json", metavar="PATH",
                    help="also write findings as JSON ('-' for stdout)")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the meta-device contract sweep")
    ap.add_argument("--contracts-only", action="store_true",
                    help="skip the AST rules")
    ap.add_argument("--reduced", action="store_true",
                    help="contract-sweep the REDUCED configs (fast smoke)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <root>/" + BASELINE + ")")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or os.path.join(root, BASELINE)
    t0 = time.monotonic()

    findings = []
    ran_rules: list[str] = []
    if not args.contracts_only:
        index = RepoIndex.build(os.path.join(root, "src"))
        if args.rules:
            names = [r.strip() for r in args.rules.split(",") if r.strip()]
            unknown = [n for n in names if n not in RULES]
            if unknown:
                ap.error(f"unknown rules: {', '.join(unknown)} "
                         f"(have: {', '.join(sorted(RULES))})")
            rules = [RULES[n] for n in names]
        else:
            rules = list(RULES.values())
        ran_rules = [r.name for r in rules]
        findings.extend(run_rules(index, rules))

    if not args.no_contracts and not args.rules:
        from repro_torch.analysis.contracts import run_contracts
        findings.extend(run_contracts(reduced=args.reduced, repo_root=root))

    findings = sorted(findings)
    baseline = Baseline.load(baseline_path)
    fresh = baseline.new_findings(findings)
    stale = baseline.stale_entries(findings)
    if args.rules:
        # partial run: a baseline entry for a rule that didn't run is not
        # evidence the violation was fixed
        stale = [e for e in stale if e.get("rule") in ran_rules]

    if args.update_baseline:
        from repro_torch.util.io import atomic_write_text
        atomic_write_text(baseline_path,
                          Baseline.from_findings(findings).dump())
        print(f"baseline: wrote {len(findings)} entries -> {baseline_path}")
        return 0

    if args.json:
        doc = findings_to_json(findings)
        if args.json == "-":
            sys.stdout.write(doc)
        else:
            from repro_torch.util.io import atomic_write_text
            atomic_write_text(args.json, doc)

    for f in fresh:
        print(f.render())
    dt = time.monotonic() - t0
    n_base = len(findings) - len(fresh)
    print(f"repro-lint: {len(fresh)} finding(s) "
          f"({n_base} baselined, {len(stale)} baseline entr(y/ies) stale) "
          f"in {dt:.1f}s", file=sys.stderr)
    for e in stale:
        print(f"  stale baseline entry (fixed — remove it): "
              f"{e.get('rule')} {e.get('path')}: {e.get('message')}",
              file=sys.stderr)

    if args.check and (fresh or stale):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
