"""Rule engine: repo index, rule protocol, and the run loop (port of
``repro/analysis/engine.py``).

``RepoIndex`` parses every module under the package once; rules are
objects with ``name`` / ``severity`` / ``check(index) -> [Finding]``.
The index owns the shared :class:`~repro_torch.analysis.callgraph.CallGraph`
so reachability rules (serve-never-decompresses, dtype-discipline)
amortize one graph build.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from pathlib import Path
from typing import Iterable, Protocol

from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.findings import Finding, apply_suppressions


@dataclasses.dataclass
class ModuleFile:
    module: str          # "repro_torch.serve.engine"
    relpath: str         # "src/repro_torch/serve/engine.py" (posix)
    source: str
    tree: ast.Module


def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with ``._parent`` (idempotent)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST):
    cur = getattr(node, "_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_parent", None)


class RepoIndex:
    def __init__(self) -> None:
        self.files: dict[str, ModuleFile] = {}    # relpath -> ModuleFile
        self.package = "repro_torch"
        self._graph: CallGraph | None = None

    @classmethod
    def build(cls, src_root: str | Path, package: str = "repro_torch",
              display_prefix: str | None = None) -> "RepoIndex":
        """Parse ``<src_root>/<package>/**/*.py``.

        ``display_prefix`` is prepended to package-relative paths in
        findings; it defaults to the name of ``src_root`` (so a standard
        checkout reports ``src/repro_torch/...``).
        """
        src_root = Path(src_root)
        if display_prefix is None:
            display_prefix = src_root.name
        idx = cls()
        idx.package = package
        pkg_dir = src_root / package
        for path in sorted(pkg_dir.rglob("*.py")):
            rel_mod = path.relative_to(src_root)
            module = ".".join(rel_mod.with_suffix("").parts)
            if module.endswith(".__init__"):
                module = module[: -len(".__init__")]
            relpath = os.path.join(display_prefix,
                                   rel_mod.as_posix()).replace(os.sep, "/")
            source = path.read_text()
            tree = ast.parse(source, filename=str(path))
            attach_parents(tree)
            idx.files[relpath] = ModuleFile(module=module, relpath=relpath,
                                            source=source, tree=tree)
        return idx

    # convenience views -----------------------------------------------------
    def modules(self) -> Iterable[ModuleFile]:
        return self.files.values()

    def by_module(self, module: str) -> ModuleFile | None:
        for mf in self.files.values():
            if mf.module == module:
                return mf
        return None

    @property
    def graph(self) -> CallGraph:
        if self._graph is None:
            g = CallGraph()
            for mf in self.files.values():
                g.add_module(mf.module, mf.relpath, mf.tree)
            self._graph = g
        return self._graph

    def symbol_at(self, relpath: str, lineno: int) -> str:
        """Tightest enclosing function qualname at a source line."""
        best = ""
        best_span = None
        for info in self.graph.functions.values():
            if info.relpath != relpath:
                continue
            end = getattr(info.node, "end_lineno", info.lineno)
            if info.lineno <= lineno <= (end or info.lineno):
                span = (end or info.lineno) - info.lineno
                if best_span is None or span < best_span:
                    best, best_span = info.qualname, span
        return best


class Rule(Protocol):
    name: str
    severity: str
    description: str

    def check(self, index: RepoIndex) -> list[Finding]: ...


def run_rules(index: RepoIndex,
              rules: Iterable[Rule]) -> list[Finding]:
    findings: list[Finding] = []
    for rule in rules:
        for f in rule.check(index):
            findings.append(f)
    sources = {rp: mf.source for rp, mf in index.files.items()}
    return sorted(apply_suppressions(findings, sources))
