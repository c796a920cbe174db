"""Lightweight call graph over ``src/repro_torch`` for reachability rules
(port of ``repro/analysis/callgraph.py``: the same resolver).

Deliberately *lightweight*: per-module import maps give
exact resolution for ``module.func`` calls; method/attribute calls
(``self.foo()``, ``model.decode_step()``) fall back to **name-based**
resolution — an edge to every known function with that bare name.  The
fallback over-approximates (extra edges, never missing ones), which is the
right bias for the reachability rules built on top: serve-never-
decompresses and dtype-discipline must not miss a path.

Jit seeds are the captured-entry points: targets of ``torch.compile`` /
``torch.jit.script`` / ``torch.jit.trace`` / ``torch.cuda.
make_graphed_callables`` and of the port's own capture helpers
(``util.graphs.graphed``, ``util.graphs.Graph``) in call or decorator
forms, unwrapping
``functools.partial`` either way around, and the calls a CUDA graph
records — those in the body of a ``with torch.cuda.graph(...)`` block, and
those after ``<graph>.capture_begin()`` up to ``capture_end()`` in the
same block (the capture-safety rules ``jit-purity`` and
``recompile-hazards`` read them).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

JIT_WRAPPERS = frozenset({
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
    "repro_torch.util.graphs.graphed",
    "repro_torch.util.graphs.Graph",
})
# context managers whose body a CUDA graph records
CAPTURE_BLOCKS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})
CAPTURE_BEGIN = "torch.cuda.CUDAGraph.capture_begin"
_PARTIAL = frozenset({"functools.partial", "partial"})


@dataclasses.dataclass
class FuncInfo:
    key: str                       # "<module>::<qualname>" (unique)
    module: str                    # "repro_torch.serve.engine"
    qualname: str                  # "Engine.decode_once" / "f.<lambda>@12"
    name: str                      # bare name ("decode_once", "<lambda>")
    relpath: str
    node: ast.AST                  # FunctionDef | AsyncFunctionDef | Lambda
    lineno: int
    calls: list = dataclasses.field(default_factory=list)   # (dotted, bare)
    refs: list = dataclasses.field(default_factory=list)    # dotted refs


def dotted_name(node: ast.AST, imports: dict[str, str]) -> str | None:
    """Canonical dotted path of a Name/Attribute chain, import-resolved
    (``np.random.rand`` -> ``numpy.random.rand``); None for other exprs."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    head = parts[0]
    if head in imports:
        parts[0:1] = imports[head].split(".")
    return ".".join(parts)


def module_imports(tree: ast.Module) -> dict[str, str]:
    """alias -> dotted target, from top-level (and nested) import stmts."""
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
                if a.asname is None and "." in a.name:
                    # `import torch.nn` binds `torch` but make the full
                    # path resolvable too
                    imports.setdefault(a.name.split(".")[0],
                                       a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                imports[a.asname or a.name] = f"{node.module}.{a.name}"
    return imports


class CallGraph:
    def __init__(self) -> None:
        self.functions: dict[str, FuncInfo] = {}       # key -> info
        self.by_name: dict[str, list[str]] = {}        # bare name -> keys
        self.by_module: dict[str, dict[str, str]] = {} # module -> qual -> key
        self.imports: dict[str, dict[str, str]] = {}   # module -> alias map
        self.modules: set[str] = set()
        self.jit_seeds: set[str] = set()               # function keys
        self.jit_sites: list = []                      # (module, relpath,
                                                       #  call node, wrapper)
        self._capture_calls: list = []                 # (module, call node)
        self._wrapped: list = []                       # (module, target)
        self._edges: dict[str, set[str]] | None = None

    # ----------------------------------------------------------- indexing
    def add_module(self, module: str, relpath: str, tree: ast.Module) -> None:
        imports = module_imports(tree)
        self.imports[module] = imports
        self.modules.add(module)
        self._index_scope(module, relpath, tree.body, qual="", owner=None)
        self._collect_jit_sites(module, relpath, tree)

    def _register(self, module: str, relpath: str, qual: str,
                  node: ast.AST, name: str) -> FuncInfo:
        key = f"{module}::{qual}"
        info = FuncInfo(key=key, module=module, qualname=qual, name=name,
                        relpath=relpath, node=node, lineno=node.lineno)
        self.functions[key] = info
        self.by_name.setdefault(name, []).append(key)
        self.by_module.setdefault(module, {})[qual] = key
        return info

    def _index_scope(self, module: str, relpath: str, body: Iterable[ast.AST],
                     qual: str, owner: FuncInfo | None) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{stmt.name}" if qual else stmt.name
                info = self._register(module, relpath, q, stmt, stmt.name)
                self._scan_body(module, relpath, stmt, q, info)
            elif isinstance(stmt, ast.ClassDef):
                q = f"{qual}.{stmt.name}" if qual else stmt.name
                self._index_scope(module, relpath, stmt.body, q, owner)
            else:
                # module/class-level statement: lambdas inside it still
                # define capturable code (`F = torch.compile(lambda ...)`)
                scope = owner or self._module_scope(module, relpath)
                self._scan_stmt_exprs(module, relpath, stmt, qual, scope)

    def _module_scope(self, module: str, relpath: str) -> FuncInfo:
        key = f"{module}::<module>"
        if key not in self.functions:
            node = ast.Module(body=[], type_ignores=[])
            node.lineno = 1  # type: ignore[attr-defined]
            self._register(module, relpath, "<module>", node, "<module>")
        return self.functions[key]

    def _scan_body(self, module: str, relpath: str, fn: ast.AST,
                   qual: str, info: FuncInfo) -> None:
        """Collect calls/refs of ``fn`` and register nested defs/lambdas."""
        imports = self.imports[module]
        for stmt in getattr(fn, "body", []):
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node is not fn and not hasattr(node, "_cg_seen"):
                        node._cg_seen = True  # type: ignore[attr-defined]
                        q = f"{qual}.{node.name}"
                        sub = self._register(module, relpath, q, node,
                                             node.name)
                        self._scan_body(module, relpath, node, q, sub)
                        # a nested def is traced when its parent is
                        info.refs.append(sub.key)
                elif isinstance(node, ast.Lambda):
                    if not hasattr(node, "_cg_seen"):
                        node._cg_seen = True  # type: ignore[attr-defined]
                        q = f"{qual}.<lambda>@{node.lineno}"
                        sub = self._register(module, relpath, q, node,
                                             "<lambda>")
                        self._scan_lambda(module, relpath, node, sub)
                        info.refs.append(sub.key)
                elif isinstance(node, ast.Call):
                    dotted = dotted_name(node.func, imports)
                    bare = (node.func.attr
                            if isinstance(node.func, ast.Attribute)
                            else getattr(node.func, "id", None))
                    info.calls.append((dotted, bare, node))
                elif isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Load):
                    info.refs.append(node.id)
                elif isinstance(node, ast.Attribute) and isinstance(
                        node.ctx, ast.Load) and isinstance(
                        node.value, ast.Name) and node.value.id in imports:
                    # a module's function taken by reference
                    # (`dec = X.slstm_decode if ... else X.mlstm_decode`)
                    info.refs.append(f"{imports[node.value.id]}.{node.attr}")

    def _scan_lambda(self, module: str, relpath: str, node: ast.Lambda,
                     info: FuncInfo) -> None:
        imports = self.imports[module]
        for sub in ast.walk(node.body):
            if isinstance(sub, ast.Call):
                dotted = dotted_name(sub.func, imports)
                bare = (sub.func.attr if isinstance(sub.func, ast.Attribute)
                        else getattr(sub.func, "id", None))
                info.calls.append((dotted, bare, sub))
            elif isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                info.refs.append(sub.id)

    def _scan_stmt_exprs(self, module: str, relpath: str, stmt: ast.AST,
                         qual: str, scope: FuncInfo) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Lambda) and not hasattr(node, "_cg_seen"):
                node._cg_seen = True  # type: ignore[attr-defined]
                q = (f"{qual}.<lambda>@{node.lineno}" if qual
                     else f"<lambda>@{node.lineno}")
                info = self._register(module, relpath, q, node, "<lambda>")
                self._scan_lambda(module, relpath, node, info)
            elif isinstance(node, ast.Call):
                imports = self.imports[module]
                dotted = dotted_name(node.func, imports)
                bare = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else getattr(node.func, "id", None))
                scope.calls.append((dotted, bare, node))

    # ------------------------------------------------------------ jit seeds
    def _collect_jit_sites(self, module: str, relpath: str,
                           tree: ast.Module) -> None:
        imports = self.imports[module]

        def is_wrapper(expr: ast.AST) -> str | None:
            d = dotted_name(expr, imports)
            if d in JIT_WRAPPERS:
                return d
            return None

        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    w = is_wrapper(target)
                    if w is None and isinstance(dec, ast.Call):
                        # @partial(torch.compile, ...) / @functools.partial
                        d = dotted_name(dec.func, imports)
                        if d in _PARTIAL and dec.args:
                            w = is_wrapper(dec.args[0])
                            if w is not None:
                                self.jit_sites.append(
                                    (module, relpath, dec, w))
                                self._seed_name(module, node.name)
                        continue
                    if w is not None:
                        self.jit_sites.append((module, relpath, dec, w))
                        self._seed_name(module, node.name)
            elif isinstance(node, ast.Call):
                w = is_wrapper(node.func)
                if w is None:
                    continue
                self.jit_sites.append((module, relpath, node, w))
                # resolved once every module is indexed: a method target
                # (``partial(adapter.block_apply, ...)``) resolves by name
                if node.args:
                    self._wrapped.append((module, node.args[0]))
                else:  # torch.compile(model=..., ...) keyword form
                    for kw in node.keywords:
                        if kw.arg in ("model", "obj", "func", "fn"):
                            self._wrapped.append((module, kw.value))
        for site, wrapper, stmts in capture_regions(tree, imports):
            self.jit_sites.append((module, relpath, site, wrapper))
            self._capture_calls += [(module, sub) for stmt in stmts
                                    for sub in ast.walk(stmt)
                                    if isinstance(sub, ast.Call)]

    def _seed_name(self, module: str, name: str) -> None:
        quals = self.by_module.get(module, {})
        for qual, key in quals.items():
            if qual == name or qual.endswith(f".{name}"):
                self.jit_seeds.add(key)
                return
        for key in self.by_name.get(name, ()):
            self.jit_seeds.add(key)

    def _seed_expr(self, module: str, expr: ast.AST) -> None:
        imports = self.imports[module]
        if isinstance(expr, ast.Lambda):
            key = getattr(expr, "_cg_seen", None)
            # lambdas were registered during indexing; find by identity
            for k, info in self.functions.items():
                if info.node is expr:
                    self.jit_seeds.add(k)
                    return
            return
        if isinstance(expr, ast.Call):
            d = dotted_name(expr.func, imports)
            if d in _PARTIAL and expr.args:        # partial(f, ...) inside jit
                self._seed_expr(module, expr.args[0])
            return
        d = dotted_name(expr, imports)
        if d is None:
            return
        for key in self.resolve(module, d, d.split(".")[-1]):
            self.jit_seeds.add(key)

    # ------------------------------------------------------------ resolution
    def resolve(self, module: str, dotted: str | None,
                bare: str | None) -> list[str]:
        """Function keys a call could target (over-approximate)."""
        if dotted is not None:
            parts = dotted.split(".")
            # exact: longest module prefix in the repo + qualname suffix
            for i in range(len(parts) - 1, 0, -1):
                mod = ".".join(parts[:i])
                if mod in self.modules:
                    qual = ".".join(parts[i:])
                    quals = self.by_module.get(mod, {})
                    if qual in quals:
                        return [quals[qual]]
                    # method called through an instance isn't expressible
                    # as module.qual; fall through to name-based
                    break
            if len(parts) == 1:
                # bare Name call: a module-level def, a closure sibling, or
                # a local variable.  Never fall back to global name
                # matching — that would edge `run()` into every `.run`
                # method in the repo.
                name = parts[0]
                quals = self.by_module.get(module, {})
                if name in quals:
                    return [quals[name]]
                return [k for q, k in quals.items()
                        if q.endswith(f".{name}")]
            head = parts[0]
            if head not in ("self", "cls") and len(parts) > 1 and \
                    ".".join(parts[:-1]) in self.modules:
                return []            # module attr that isn't a function
            # import-resolved external root (torch.save, np.save, …): not
            # a method on a repo object — no name-based fallback, which
            # would edge `torch.save` into every repo `save`
            imports = self.imports.get(module, {})
            roots = {m.split(".")[0] for m in self.modules}
            if len(parts) > 1 and parts[0] not in roots and (
                    head in imports or
                    any(v == head or v.startswith(f"{head}.")
                        for v in imports.values())):
                return []
        if bare is None:
            return []
        return list(self.by_name.get(bare, ()))

    # ---------------------------------------------------------- reachability
    def edges(self) -> dict[str, set[str]]:
        if self._edges is not None:
            return self._edges
        out: dict[str, set[str]] = {}
        for key, info in self.functions.items():
            tgt: set[str] = set()
            for dotted, bare, _node in info.calls:
                tgt.update(self.resolve(info.module, dotted, bare))
            for ref in info.refs:
                if ref in self.functions:              # direct key ref
                    tgt.add(ref)
                elif "." in ref:                       # module.function
                    tgt.update(self.resolve(info.module, ref, None))
                else:
                    # Name load matching a same-module def or an imported
                    # repo function (callback passed by reference)
                    quals = self.by_module.get(info.module, {})
                    if ref in quals:
                        tgt.add(quals[ref])
                    elif any(q.endswith(f".{ref}") for q in quals):
                        tgt.update(k for q, k in quals.items()
                                   if q.endswith(f".{ref}"))
                    else:
                        d = self.imports[info.module].get(ref)
                        if d is not None:
                            tgt.update(self.resolve(info.module, d,
                                                    d.split(".")[-1]))
            tgt.discard(key)
            out[key] = tgt
        self._edges = out
        return out

    def reachable(self, seeds: Iterable[str]) -> dict[str, tuple[str, ...]]:
        """BFS from seed keys → {key: call chain from a seed (inclusive)}."""
        edges = self.edges()
        chains: dict[str, tuple[str, ...]] = {}
        frontier = []
        for s in sorted(set(seeds)):                 # deterministic chains
            if s in self.functions and s not in chains:
                chains[s] = (s,)
                frontier.append(s)
        while frontier:
            nxt = []
            for key in frontier:
                for callee in sorted(edges.get(key, ())):
                    if callee not in chains:
                        chains[callee] = chains[key] + (callee,)
                        nxt.append(callee)
            frontier = nxt
        return chains

    def jit_reachable(self) -> dict[str, tuple[str, ...]]:
        # the wrapped targets and the calls a graph records, resolved once
        # every module is indexed
        for module, expr in self._wrapped:
            self._seed_expr(module, expr)
        self._wrapped = []
        for module, call in self._capture_calls:
            imports = self.imports[module]
            func = call.func
            if isinstance(func, ast.Call):            # partial(f, ...)(x)
                self._seed_expr(module, func)
                continue
            bare = (func.attr if isinstance(func, ast.Attribute)
                    else getattr(func, "id", None))
            self.jit_seeds.update(self.resolve(
                module, dotted_name(func, imports), bare))
        self._capture_calls = []
        return self.reachable(self.jit_seeds)


def capture_regions(tree: ast.AST, imports: dict[str, str]):
    """The code a CUDA graph records, as (site node, wrapper, statements):
    the body of each ``with torch.cuda.graph(...)`` block, and the
    statements after each ``<g>.capture_begin(...)`` up to the one calling
    ``capture_end`` in the same block."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and \
                        dotted_name(ctx.func, imports) in CAPTURE_BLOCKS:
                    yield ctx, "torch.cuda.graph", node.body
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, stmt in enumerate(stmts):
                call = _method_call(stmt, "capture_begin")
                if call is None:
                    continue
                region = []
                for nxt in stmts[i + 1:]:
                    if _method_call(nxt, "capture_end") is not None:
                        break
                    region.append(nxt)
                yield call, CAPTURE_BEGIN, region


def _method_call(stmt: ast.AST, attr: str) -> ast.Call | None:
    """The call of statement ``stmt`` when it is ``<x>.<attr>(...)``."""
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) and \
            isinstance(stmt.value.func, ast.Attribute) and \
            stmt.value.func.attr == attr:
        return stmt.value
    return None
