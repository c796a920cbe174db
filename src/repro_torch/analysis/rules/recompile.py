"""recompile-hazards: captured signatures that bake a per-call value in,
and graphs that are never reused (port of
``repro/analysis/rules/recompile.py``).

Under ``jax.jit`` a varying Python scalar retraces.  Under a CUDA graph it
is worse: the graph records the kernels with the value it saw at capture,
and every replay silently reuses it.  Two shapes:

* a captured function — called in the body of a ``with torch.cuda.graph``
  block or between ``capture_begin()`` and ``capture_end()``, or a
  ``torch.cuda.make_graphed_callables`` target — whose signature admits a
  Python scalar or dict (an ``int``/``float``/``bool``/``str``/``dict``
  annotation, or a scalar default).  Arguments bound at capture by
  ``functools.partial`` are fixed for that graph by construction, as
  JAX's ``static_argnums`` are, and are not flagged; a value that varies
  per step belongs in a device tensor the caller writes before each
  replay;

* a graph captured in a loop body, or inside a function that keeps
  neither the graph nor the graphed callable (stores it in an attribute
  or a container, or returns it) — a fresh capture per call, never
  replayed again: JAX's ``jax.jit(lambda ...)`` in a body.  A deliberate
  one-off capture carries a ``# lint: disable=recompile-hazards``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.callgraph import (CAPTURE_BEGIN, capture_regions,
                                            dotted_name, module_imports)
from repro_torch.analysis.engine import RepoIndex, ancestors
from repro_torch.analysis.findings import Finding

_SCALAR_ANNOTATIONS = frozenset({"int", "str", "bool", "float", "dict"})
_GRAPHED = "torch.cuda.make_graphed_callables"
_PARTIAL = ("functools.partial", "partial")


def _is_scalar_annotation(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id in _SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        head = ann.value.split("[")[0].strip()
        return head in _SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Subscript):       # dict[str, int], tuple[int, ...]
        return isinstance(ann.value, ast.Name) and \
            ann.value.id in ("dict", "Dict")
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        # `int | None` style optional scalars
        return _is_scalar_annotation(ann.left) or \
            _is_scalar_annotation(ann.right)
    return False


def _is_scalar_default(node: ast.AST | None) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, str, bool)) and \
            node.value is not None
    return isinstance(node, ast.Dict)


def _names(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _kept(fn: ast.AST, name: str) -> bool:
    """Whether function ``fn`` keeps the local ``name`` past its return:
    assigns it into an attribute or a subscript, or returns or yields it."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and name in _names(node.value):
            targets = [t for tg in node.targets
                       for t in (tg.elts if isinstance(tg, ast.Tuple)
                                 else [tg])]
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in targets):
                return True
        elif isinstance(node, (ast.Return, ast.Yield)) and \
                node.value is not None and name in _names(node.value):
            return True
    return False


class RecompileHazardsRule:
    name = "recompile-hazards"
    severity = "warning"
    description = ("captured callables with per-call Python scalars/dicts "
                   "baked into the graph, and graphs captured per call or "
                   "in a loop")

    def check(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        for mf in index.modules():
            imports = module_imports(mf.tree)
            defs: dict[str, ast.AST] = {}
            for node in ast.walk(mf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.setdefault(node.name, node)

            for node in ast.walk(mf.tree):
                if isinstance(node, ast.Call) and \
                        dotted_name(node.func, imports) == _GRAPHED and \
                        node.args:
                    findings += self._graphed(index, mf, node, defs,
                                              imports)
            for site, wrapper, stmts in capture_regions(mf.tree, imports):
                findings += self._fresh_graph(index, mf, site, wrapper)
                for stmt in stmts:
                    for call in ast.walk(stmt):
                        if isinstance(call, ast.Call):
                            findings += self._captured_call(
                                index, mf, call, defs, imports)
        return findings

    # --------------------------------------------------------- the sites
    def _graphed(self, index, mf, node, defs, imports) -> list[Finding]:
        """``torch.cuda.make_graphed_callables(target, ...)``."""
        target, bound = self._unwrap(node.args[0], imports)
        if isinstance(target, ast.Lambda):
            fn = self._enclosing(node)
            if fn is not None and not self._result_kept(node, fn):
                return [self._finding(
                    index, mf, node,
                    "torch.cuda.make_graphed_callables(lambda ...) inside "
                    "a function body captures afresh per call (the graph "
                    "is never replayed) — hoist it to module scope or "
                    "keep the callable")]
            return []
        if isinstance(target, ast.Name) and target.id in defs:
            return self._check_signature(index, mf, defs[target.id], bound,
                                         node.lineno)
        return []

    def _captured_call(self, index, mf, call, defs,
                       imports) -> list[Finding]:
        """A call a graph records: the callee's signature."""
        func, bound = call.func, 0
        if isinstance(func, ast.Call):                 # partial(f, ...)(x)
            func, bound = self._unwrap(func, imports)
        if isinstance(func, ast.Name) and func.id in defs:
            return self._check_signature(index, mf, defs[func.id], bound,
                                         call.lineno)
        return []

    def _fresh_graph(self, index, mf, site, wrapper) -> list[Finding]:
        """A capture in a loop body, or of a graph the function drops."""
        fn = self._enclosing(site)
        loop = None
        for a in ancestors(site):
            if a is fn:
                break
            if isinstance(a, (ast.For, ast.AsyncFor, ast.While)):
                loop = a
                break
        if loop is not None:
            return [self._finding(
                index, mf, site,
                "a CUDA graph captured in a loop body is captured afresh "
                "every iteration — capture once, then replay")]
        if fn is None:
            return []
        graph = (site.args[0] if wrapper != CAPTURE_BEGIN and site.args
                 else getattr(site.func, "value", None))
        if isinstance(graph, ast.Name) and not _kept(fn, graph.id):
            return [self._finding(
                index, mf, site,
                f"the CUDA graph `{graph.id}` captured in `{fn.name}` is "
                "dropped at its return: every call captures afresh and "
                "the graph is never replayed — keep it (an attribute) and "
                "replay it")]
        return []

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _unwrap(target: ast.AST, imports) -> tuple[ast.AST, int]:
        """``partial(f, a, b)`` → (f, 2 bound arguments); else (target, 0)."""
        if isinstance(target, ast.Call) and \
                dotted_name(target.func, imports) in _PARTIAL and \
                target.args:
            return target.args[0], len(target.args) - 1
        return target, 0

    @staticmethod
    def _enclosing(node: ast.AST):
        for a in ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    @staticmethod
    def _result_kept(call: ast.Call, fn: ast.AST) -> bool:
        """Whether the graphed callable ``call`` makes is kept by ``fn``."""
        for a in ancestors(call):
            if isinstance(a, (ast.Return, ast.Yield)):
                return True
            if isinstance(a, ast.Assign):
                names = [t.id for t in a.targets if isinstance(t, ast.Name)]
                return any(isinstance(t, (ast.Attribute, ast.Subscript))
                           for t in a.targets) or \
                    any(_kept(fn, n) for n in names)
            if a is fn:
                break
        return False

    def _check_signature(self, index, mf, fn, bound: int,
                         site_line: int) -> list[Finding]:
        findings = []
        args = fn.args
        pos = list(args.posonlyargs) + list(args.args)
        defaults = [None] * (len(pos) - len(args.defaults)) + \
            list(args.defaults)
        for i, (p, dflt) in enumerate(zip(pos, defaults)):
            if p.arg in ("self", "cls") or i < bound:
                continue
            if _is_scalar_annotation(p.annotation) or \
                    _is_scalar_default(dflt):
                findings.append(self._hazard(mf, fn, p, site_line))
        for p, dflt in zip(args.kwonlyargs, args.kw_defaults):
            if _is_scalar_annotation(p.annotation) or \
                    _is_scalar_default(dflt):
                findings.append(self._hazard(mf, fn, p, site_line))
        return findings

    def _hazard(self, mf, fn, param, site_line: int) -> Finding:
        return Finding(
            path=mf.relpath, line=site_line, rule=self.name,
            severity=self.severity, symbol=fn.name,
            message=f"captured `{fn.name}` takes Python scalar/dict "
                    f"parameter `{param.arg}`: the graph bakes in the value "
                    "it saw at capture and every replay reuses it — pass a "
                    "device tensor written before each replay, or bind it "
                    "at capture with functools.partial")

    def _finding(self, index, mf, node, message: str) -> Finding:
        return Finding(
            path=mf.relpath, line=node.lineno, rule=self.name,
            severity=self.severity,
            symbol=index.symbol_at(mf.relpath, node.lineno),
            message=message)
