"""atomic-writes: durable artifacts go through repro_torch/util/io.py.

The crash-safety story depends on every journal, snapshot, manifest and
report write being tmp+fsync+``os.replace`` — a raw ``open(path, "w")``
anywhere in src/repro_torch can leave a torn file that a resume/restore
then half-reads.  The rule flags *every* write-mode ``open`` outside
``repro_torch/util/io.py`` (port of the JAX rule): read-mode opens are
fine, and the rare legitimate non-durable write (a pid file, a debug
dump) carries an explicit ``# lint: disable=atomic-writes``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import RepoIndex
from repro_torch.analysis.findings import Finding

_WRITE_MODES = ("w", "wb", "a", "ab", "w+", "wb+", "a+", "ab+", "x", "xb")


def _write_mode(call: ast.Call) -> str | None:
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) and \
            mode.value in _WRITE_MODES:
        return mode.value
    return None


class AtomicWritesRule:
    name = "atomic-writes"
    severity = "error"
    description = ("no raw write-mode open() outside "
                   "repro_torch/util/io.py — durable writes use "
                   "atomic_write_{bytes,text,json}")

    allowed_module = "repro_torch.util.io"

    def check(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        for mf in index.modules():
            if mf.module == self.allowed_module:
                continue
            for node in ast.walk(mf.tree):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Name) and
                        node.func.id == "open"):
                    continue
                mode = _write_mode(node)
                if mode is None:
                    continue
                findings.append(Finding(
                    path=mf.relpath, line=node.lineno, rule=self.name,
                    severity=self.severity,
                    symbol=index.symbol_at(mf.relpath, node.lineno),
                    message=f'raw open(..., "{mode}") — route durable '
                            "writes through repro_torch.util.io.atomic_write_* "
                            "(tmp+fsync+os.replace)"))
        return findings
