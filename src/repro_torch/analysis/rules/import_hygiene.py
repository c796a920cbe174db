"""import-hygiene: re-export shims must be total.

A *shim* is a non-``__init__`` module whose body is only a docstring,
imports, and an ``__all__`` — e.g. ``serve/faults.py``, which re-exports
``repro_torch/faults.py``.  A shim that hand-lists a subset of the source
module's ``__all__`` silently drops every name added later (the JAX
package's serving shim once missed four prune-side exceptions this way;
this is a port of that rule).  The fix is ``from <src> import *`` so the
shim tracks the source, with its own ``__all__`` still curating the public
surface.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import RepoIndex
from repro_torch.analysis.findings import Finding


def _module_all(tree: ast.Module) -> list[str] | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "__all__":
            try:
                val = ast.literal_eval(node.value)
            except ValueError:
                return None
            return [str(v) for v in val]
    return None


def _is_shim(tree: ast.Module) -> bool:
    saw_import = False
    for i, node in enumerate(tree.body):
        if i == 0 and isinstance(node, ast.Expr) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            continue                                   # docstring
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            saw_import = True
            continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "__all__":
            continue
        return False
    return saw_import


class ImportHygieneRule:
    name = "import-hygiene"
    severity = "warning"
    description = ("pure re-export shims must use `import *` (or list the "
                   "full source __all__) so new names propagate")

    def check(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        for mf in index.modules():
            if mf.relpath.endswith("__init__.py"):
                continue                 # package facades curate by design
            if not _is_shim(mf.tree):
                continue
            for node in mf.tree.body:
                if not isinstance(node, ast.ImportFrom) or not node.module:
                    continue
                names = [a.name for a in node.names]
                if "*" in names:
                    continue
                src = index.by_module(node.module)
                if src is None:
                    continue
                src_all = _module_all(src.tree)
                if src_all is None:
                    continue
                missing = sorted(set(src_all) - set(names))
                if missing:
                    findings.append(Finding(
                        path=mf.relpath, line=node.lineno, rule=self.name,
                        severity=self.severity, symbol="",
                        message=f"partial re-export shim of {node.module}: "
                                f"missing {', '.join(missing)} — use "
                                f"`from {node.module} import *` so new "
                                "names propagate"))
        return findings
