"""dtype-discipline: no implicit float64 in the kernels or the solves that
serving and pruning reach.

The solver stack (core/) and the CUDA kernels' wrappers (kernels/) are
fp32/bf16 by contract.  A stray ``torch.float64`` / ``.double()`` or a
float64 numpy constant doubles the bytes and runs at 1/30 of the card's
fp32 rate (or on the host), and a dtype-less numpy constructor or an
``np.linalg`` host solve is float64 by default.  In the port the traced
code of the JAX rule becomes the code the serve and prune entry points
reach: everything in kernels/, plus every core/ function reachable from
``launch/serve.py``, ``launch/prune.py``, ``serve/engine.py`` or
``serve/supervisor.py`` (call graph).  The kernels' wrappers also take no
``torch.linalg`` call: solves belong in core/.  ``data/pipeline.py``'s
deliberate float64 Zipf ranks lie outside both scopes.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.callgraph import dotted_name
from repro_torch.analysis.engine import RepoIndex
from repro_torch.analysis.findings import Finding

_F64_ATTRS = frozenset({
    "numpy.float64", "numpy.double", "numpy.longdouble",
    "torch.float64", "torch.double",
})
_NP_CTORS = frozenset({
    "numpy.array", "numpy.asarray", "numpy.zeros", "numpy.ones",
    "numpy.empty", "numpy.full", "numpy.arange", "numpy.linspace",
    "numpy.eye",
})
ENTRY_MODULES = ("repro_torch.launch.serve", "repro_torch.launch.prune",
                 "repro_torch.serve.engine", "repro_torch.serve.supervisor")


def _has_dtype_kw(call: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in call.keywords)


class DtypeDisciplineRule:
    name = "dtype-discipline"
    severity = "error"
    description = ("no implicit float64 (torch.float64 / .double() / "
                   "np.float64 / np.linalg / dtype-less numpy "
                   "constructors) in kernels/ or the core/ solves the "
                   "serve and prune entry points reach; no torch.linalg "
                   "in kernels/")

    def _in_scope(self, info, reach) -> bool:
        if info.module.startswith("repro_torch.kernels."):
            return True
        return info.module.startswith("repro_torch.core.") and \
            info.key in reach

    def check(self, index: RepoIndex) -> list[Finding]:
        graph = index.graph
        seeds = [key for mod in ENTRY_MODULES
                 for key in graph.by_module.get(mod, {}).values()]
        reach = graph.reachable(seeds)
        findings: list[Finding] = []
        seen: set[tuple] = set()
        for info in graph.functions.values():
            if not self._in_scope(info, reach):
                continue
            kernels = info.module.startswith("repro_torch.kernels.")
            imports = graph.imports.get(info.module, {})
            for node in ast.walk(info.node):
                msg = None
                if isinstance(node, ast.Attribute):
                    d = dotted_name(node, imports)
                    if d in _F64_ATTRS:
                        msg = (f"{d} in a kernel or a served/pruned solve — "
                               "float64 doubles the bytes and runs at a "
                               "fraction of the fp32 rate")
                    elif d is not None and d.startswith("numpy.linalg."):
                        msg = (f"{d} is a host float64 solve — use "
                               "torch.linalg on the tensor's device")
                    elif kernels and d is not None and \
                            d.startswith("torch.linalg."):
                        msg = (f"{d} in a kernel wrapper — solves belong "
                               "in core/")
                elif isinstance(node, ast.Call):
                    d = dotted_name(node.func, imports)
                    if d in _NP_CTORS and not _has_dtype_kw(node):
                        msg = (f"{d} without dtype= defaults to float64 "
                               "on host — pass an explicit dtype")
                    elif isinstance(node.func, ast.Attribute) and \
                            node.func.attr == "double" and not node.args:
                        msg = (".double() casts to float64 in a kernel or "
                               "a served/pruned solve")
                if msg is None:
                    continue
                key = (info.relpath, node.lineno,
                       getattr(node, "col_offset", 0), msg)
                if key in seen:       # nested walks over shared subtrees
                    continue
                seen.add(key)
                findings.append(Finding(
                    path=info.relpath, line=node.lineno, rule=self.name,
                    severity=self.severity, symbol=info.qualname,
                    message=msg))
        return findings
