"""fault-hook-cost: the injection registry stays zero-cost unarmed.

Port of the JAX rule.  The contract: every site named in
``repro_torch/faults.py``'s ``SITES`` registry fires at **exactly one**
call site, and that call is
guarded so the unarmed cost is one ``is not None`` — either

    if self.faults is not None:
        f = self.faults.fire("site")          # guarded block form
or
    if faults is not None and faults.fire("site") is not None:   # BoolOp

A second call site doubles the armed-fire count (breaking deterministic
``after_n`` triggers); an unguarded call puts attribute lookup + method
dispatch on the no-fault hot path; a
registry entry with zero call sites is a dead knob that chaos tests
silently stop covering.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import RepoIndex, ancestors
from repro_torch.analysis.findings import Finding

_REGISTRY_NAMES = ("SERVE_SITES", "PRUNE_SITES")


def _is_none_guard(test: ast.AST) -> bool:
    """Does this expression contain a `<faults expr> is not None` compare?"""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and len(node.ops) == 1 and \
                isinstance(node.ops[0], ast.IsNot) and \
                isinstance(node.comparators[0], ast.Constant) and \
                node.comparators[0].value is None:
            mention = ast.dump(node.left)
            if "faults" in mention or "plan" in mention:
                return True
    return False


def _guarded(call: ast.Call) -> bool:
    for anc in ancestors(call):
        if isinstance(anc, ast.BoolOp) and isinstance(anc.op, ast.And):
            # guard must precede the value containing the fire() call
            for value in anc.values:
                if call in ast.walk(value):
                    break
                if _is_none_guard(value):
                    return True
        if isinstance(anc, ast.If) and _is_none_guard(anc.test):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
    return False


class FaultHookCostRule:
    name = "fault-hook-cost"
    severity = "error"
    description = ("every faults.py site fires at exactly one call site, "
                   "guarded by `is not None`")

    registry_module = "repro_torch.faults"

    def _sites(self, index: RepoIndex) -> dict[str, int]:
        mf = index.by_module(self.registry_module)
        if mf is None:
            return {}
        sites: dict[str, int] = {}
        for node in ast.walk(mf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id in _REGISTRY_NAMES:
                try:
                    for s in ast.literal_eval(node.value):
                        sites[str(s)] = 0
                except ValueError:
                    continue
        return sites

    def check(self, index: RepoIndex) -> list[Finding]:
        sites = self._sites(index)
        if not sites:
            return []
        findings: list[Finding] = []
        registry_mf = index.by_module(self.registry_module)
        for mf in index.modules():
            if registry_mf is not None and mf is registry_mf:
                continue          # the registry's own fire() implementation
            for node in ast.walk(mf.tree):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute) and
                        node.func.attr == "fire" and node.args and
                        isinstance(node.args[0], ast.Constant) and
                        isinstance(node.args[0].value, str)):
                    continue
                site = node.args[0].value
                if site not in sites:
                    findings.append(Finding(
                        path=mf.relpath, line=node.lineno, rule=self.name,
                        severity=self.severity,
                        symbol=index.symbol_at(mf.relpath, node.lineno),
                        message=f"fire({site!r}) names a site missing from "
                                f"the {self.registry_module} registry"))
                    continue
                sites[site] += 1
                if sites[site] > 1:
                    findings.append(Finding(
                        path=mf.relpath, line=node.lineno, rule=self.name,
                        severity=self.severity,
                        symbol=index.symbol_at(mf.relpath, node.lineno),
                        message=f"fault site {site!r} fired at more than "
                                "one call site (breaks deterministic "
                                "after_n triggers)"))
                if not _guarded(node):
                    findings.append(Finding(
                        path=mf.relpath, line=node.lineno, rule=self.name,
                        severity=self.severity,
                        symbol=index.symbol_at(mf.relpath, node.lineno),
                        message=f"fire({site!r}) is not guarded by an "
                                "`is not None` check — unarmed cost must "
                                "be one comparison"))
        for site, count in sorted(sites.items()):
            if count == 0 and registry_mf is not None:
                findings.append(Finding(
                    path=registry_mf.relpath, line=1, rule=self.name,
                    severity=self.severity, symbol="SITES",
                    message=f"registry site {site!r} has no call site — "
                            "dead chaos knob"))
        return findings
