"""Finding records, fingerprints, suppressions, and the baseline file.

A *finding* is one rule violation at one source location.  Its
**fingerprint** deliberately excludes the line number — it hashes
``rule | path | symbol | message`` — so unrelated edits above a
grandfathered finding do not churn the baseline; moving or renaming the
offending code *does* (the finding then counts as new, which is the point).

The **baseline** (``src/repro_torch/analysis/baseline.json``) is a
multiset of fingerprints: each entry absorbs exactly one matching finding
per run.  The port's baseline is empty and stays so: a finding is fixed in
the code, or carries an explicit ``# lint: disable=<rule>`` with a
justifying comment.

Port of ``repro/analysis/findings.py``: the same records, fingerprints and
JSON schema, byte for byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from collections import Counter
from typing import Iterable

SEVERITIES = ("error", "warning")

# `# lint: disable=rule-a,rule-b` — same line as the finding, or alone on
# the line directly above it.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w\-,\s]+)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str          # repo-relative, posix separators
    line: int
    rule: str
    severity: str      # "error" | "warning"
    message: str
    symbol: str = ""   # enclosing function/class qualname, if known

    def fingerprint(self) -> str:
        key = "|".join((self.rule, self.path, self.symbol, self.message))
        return hashlib.sha256(key.encode("utf-8")).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(path=d["path"], line=int(d["line"]), rule=d["rule"],
                   severity=d["severity"], message=d["message"],
                   symbol=d.get("symbol", ""))

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"{self.rule}: {self.message}{sym}")


def findings_to_json(findings: Iterable[Finding]) -> str:
    return json.dumps({"version": 1,
                       "findings": [f.to_dict() for f in findings]},
                      indent=1) + "\n"


def findings_from_json(text: str) -> list[Finding]:
    doc = json.loads(text)
    return [Finding.from_dict(d) for d in doc["findings"]]


# --------------------------------------------------------------- suppressions
def suppressed_lines(source: str) -> dict[int, set[str]]:
    """line number (1-based) -> rule names disabled on that line.

    A directive on its own line (only comment/whitespace) also covers the
    next line, so the common pattern reads::

        # lint: disable=atomic-writes  -- a debug dump, not an artifact
        with open(path, "w") as f:
    """
    out: dict[int, set[str]] = {}
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if text[:m.start()].strip() == "":      # directive-only line
            out.setdefault(i + 1, set()).update(rules)
    return out


def apply_suppressions(findings: list[Finding],
                       sources: dict[str, str]) -> list[Finding]:
    """Drop findings whose (path, line) carries a matching disable."""
    by_path: dict[str, dict[int, set[str]]] = {}
    kept = []
    for f in findings:
        if f.path not in by_path:
            src = sources.get(f.path, "")
            by_path[f.path] = suppressed_lines(src)
        rules = by_path[f.path].get(f.line, ())
        if f.rule in rules or "all" in rules:
            continue
        kept.append(f)
    return kept


# ------------------------------------------------------------------ baseline
class Baseline:
    """Multiset of grandfathered fingerprints (checked-in JSON)."""

    def __init__(self, entries: Iterable[dict] | None = None):
        self.entries = list(entries or [])
        self._counts = Counter(e["fingerprint"] for e in self.entries)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return cls()
        return cls(doc.get("findings", []))

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        return cls([{"fingerprint": f.fingerprint(), "rule": f.rule,
                     "path": f.path, "message": f.message}
                    for f in sorted(findings)])

    def dump(self) -> str:
        return json.dumps({"version": 1, "findings": self.entries},
                          indent=1) + "\n"

    def new_findings(self, findings: list[Finding]) -> list[Finding]:
        """Findings not absorbed by the baseline (multiset semantics)."""
        budget = Counter(self._counts)
        fresh = []
        for f in sorted(findings):
            fp = f.fingerprint()
            if budget[fp] > 0:
                budget[fp] -= 1
            else:
                fresh.append(f)
        return fresh

    def stale_entries(self, findings: list[Finding]) -> list[dict]:
        """Baseline entries no current finding matches (fixed → removable)."""
        present = Counter(f.fingerprint() for f in findings)
        stale = []
        for e in self.entries:
            if present[e["fingerprint"]] > 0:
                present[e["fingerprint"]] -= 1
            else:
                stale.append(e)
        return stale
