"""jit-purity: no host effect inside captured code (port of
``repro/analysis/rules/jit_purity.py``).

A function reachable from a capture root — the body of a ``with
torch.cuda.graph(...)`` block, the calls after ``capture_begin()``, a
``torch.cuda.make_graphed_callables`` / ``torch.compile`` target — runs its
Python once, at capture, and then only its kernels replay.  ``np.random``
draws one value that every replay repeats, ``time.time()`` bakes in the
capture's timestamp and ``time.sleep`` waits once.  A host sync over a
tensor — ``bool()`` / ``int()`` / ``float()`` of it, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()`` — and a ``torch.tensor`` /
``torch.as_tensor`` of host data onto the card (a pageable host-to-device
copy) are refused while a stream captures, on the card only, at the first
capture — and so is ``t[idx] = 1.0`` with a tensor index (``index_put_``
copies the host scalar to the card; ``index_fill_`` takes it as an
argument).  This rule catches them at lint time via call-graph
reachability.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import RepoIndex
from repro_torch.analysis.findings import Finding

# dotted-prefix -> why it's impure under capture
_FORBIDDEN_PREFIXES = {
    "numpy.random": "host RNG draws one value every replay repeats",
    "time.time": "wall clock is baked in at capture",
    "time.perf_counter": "wall clock is baked in at capture",
    "time.monotonic": "wall clock is baked in at capture",
    "time.sleep": "host sleep runs once, at capture",
    "datetime.datetime.now": "wall clock is baked in at capture",
    "datetime.date.today": "wall clock is baked in at capture",
    "random.random": "host RNG draws one value every replay repeats",
    "random.randint": "host RNG draws one value every replay repeats",
    "random.choice": "host RNG draws one value every replay repeats",
    "random.shuffle": "host RNG draws one value every replay repeats",
    "random.uniform": "host RNG draws one value every replay repeats",
}

# tensor methods that copy to the host (a sync a capture refuses)
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# tensor reductions whose result bool()/int()/float() would read back
_REDUCTIONS = frozenset({"any", "all", "sum", "max", "min", "amax", "amin",
                         "mean", "prod", "argmax", "argmin", "norm",
                         "count_nonzero"})
_CONCRETIZERS = ("bool", "int", "float")
_HOST_TO_DEVICE = ("torch.tensor", "torch.as_tensor")


def _mentions_tensor(node: ast.AST, imports: dict) -> bool:
    """Whether an expression computes a tensor: it names ``torch`` (or an
    alias of a torch module) or calls a tensor reduction method."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and \
                imports.get(sub.id, sub.id).split(".")[0] == "torch":
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                    ast.Attribute) and \
                sub.func.attr in _REDUCTIONS:
            return True
    return False


def _own_nodes(fn: ast.AST):
    """The nodes of a function's body, not those of the functions and
    lambdas nested in it (the call graph holds those on their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _scalar_index_put(node: ast.AST) -> bool:
    """``t[<index>] = <constant>`` where an index element is a call, a
    subscript or a name — an advanced-index store of a host scalar when it
    is a tensor; a name may hold an int (a basic index, no copy): the rule
    over-approximates, as the call graph does."""
    if not (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Subscript)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, (bool, int, float))):
        return False
    idx = node.targets[0].slice
    elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
    return any(isinstance(e, (ast.Call, ast.Subscript, ast.Name))
               for e in elts)


def _onto_device(call: ast.Call) -> bool:
    """A ``device=`` keyword other than the literal "cpu"."""
    for kw in call.keywords:
        if kw.arg == "device":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value == "cpu")
    return False


class JitPurityRule:
    name = "jit-purity"
    severity = "error"
    description = ("no np.random/time/datetime/host sync/host-to-device "
                   "copy inside functions reachable from a CUDA graph "
                   "capture")

    def check(self, index: RepoIndex) -> list[Finding]:
        graph = index.graph
        findings: list[Finding] = []
        for key, chain in graph.jit_reachable().items():
            info = graph.functions[key]
            imports = graph.imports.get(info.module, {})
            stores = [(None, None, n) for n in _own_nodes(info.node)
                      if _scalar_index_put(n)]
            for dotted, bare, node in info.calls + stores:
                msg = None
                if isinstance(node, ast.Assign):
                    msg = ("a host scalar stored at a tensor index "
                           "(index_put_) is copied to the card, which a "
                           "capture refuses; use index_fill_")
                elif dotted is not None:
                    for prefix, why in _FORBIDDEN_PREFIXES.items():
                        if dotted == prefix or dotted.startswith(
                                prefix + "."):
                            msg = (f"call to {dotted} in captured code "
                                   f"({why})")
                            break
                if msg is None and dotted in _CONCRETIZERS and node.args \
                        and _mentions_tensor(node.args[0], imports):
                    msg = (f"{dotted}() over a tensor expression syncs the "
                           "host (host-side branching), which a capture "
                           "refuses")
                if msg is None and isinstance(node.func, ast.Attribute) \
                        and bare in _SYNC_METHODS and not node.args:
                    msg = (f".{bare}() copies a tensor to the host, a sync "
                           "a capture refuses")
                if msg is None and dotted in _HOST_TO_DEVICE and \
                        _onto_device(node):
                    msg = (f"{dotted}(..., device=) copies host data to the "
                           "card, which a capture refuses (and a replay "
                           "would repeat the captured value)")
                if msg is None:
                    continue
                via = " -> ".join(
                    graph.functions[k].qualname for k in chain)
                findings.append(Finding(
                    path=info.relpath, line=node.lineno, rule=self.name,
                    severity=self.severity, symbol=info.qualname,
                    message=f"{msg}; captured via {via}"))
        return findings
