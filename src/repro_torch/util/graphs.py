"""CUDA graphs: the port's counterpart of ``jax.jit``.

``graphed(fn, static=(...))`` mirrors ``partial(jax.jit,
static_argnames=(...))``.  Inside a ``scope()`` on a card, a call is keyed
by the wrapped function, every tensor argument's shape, stride, dtype and
device, every other argument leaf and the static arguments' values (so a
percdamp escalation gets a graph of its own, as JAX recompiles):

* the first call with a key runs eagerly, on the calling thread's side
  stream: its result is the caller's, and it is the warm-up PyTorch asks
  for before a capture;
* the second call copies its tensor arguments into static buffers it
  allocates, captures ``fn`` over them as a CUDA graph in the scope's
  pool, and replays it; every later call copies its tensors into those
  buffers and replays.  The outputs are cloned out of the pool before the
  call returns, so the scope's graphs can share one pool: replays are
  sequential on one stream.

A call runs ``fn`` as it is written (inline) on the CPU, outside any
``scope()``, and inside another graphed call — its eager warm-up or its
capture, as a jitted function called under ``jax.jit`` is traced inline —
or while the current stream captures for any other reason.  There is no
switch and no eager fallback: a capture that fails raises.

``Graph`` is the capture itself, also used by the serving engine's steps
(``serve/engine._Step``): the calling thread's side stream (thread-local
capture: the SSE front end drives its engine from its own thread), the
collector held off (a dead object's graphs freed mid-capture — a cudaFree
— invalidate it), and the kernel wrappers' launch tally, which a replay
adds back since it runs no Python (``kernels/ops.take_launches``).

The port's solvers factorize on cuSOLVER on the card (``device.
resolve_device``): a captured solve checks that, since MAGMA's batched
routines stage their pointer arrays in host memory a replay would read
stale.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import threading
import time
from typing import Any, Callable, Iterator

import torch
from torch.utils import _pytree as pytree

Tensor = torch.Tensor

_LOCAL = threading.local()   # per thread: side streams, scope, depth


def _local():
    if not hasattr(_LOCAL, "scope"):
        _LOCAL.streams = {}
        _LOCAL.scope = None
        _LOCAL.depth = 0
    return _LOCAL


def side_stream(device) -> "torch.cuda.Stream":
    """The calling thread's side stream on ``device``, made once: every
    warm-up and capture of the thread runs on it, so the streams (and the
    cuBLAS workspaces PyTorch keeps for each) do not grow with the
    graphs."""
    streams = _local().streams
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, Tensor)]


def _clone(tree):
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, Tensor) else t, tree)


def run_on_side(fn: Callable[[], Any], device) -> Any:
    """``fn()`` eagerly on the thread's side stream, ordered after the
    current stream's work and before its later work.  Its tensors are
    returned as clones made on the current stream: a tensor of the side
    stream's would need ``record_stream``, and one that outlives the
    process's CUDA context (a prune's tree handed to another process
    through CUDA IPC is freed at exit) records an event on a dead driver
    and aborts the exit."""
    side = side_stream(device)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(main)
    return _clone(out)


class Graph:
    """``fn()`` captured once as a CUDA graph in ``pool`` on the thread's
    side stream.  ``out`` is what the capture returned: tensors in the
    pool that every ``replay()`` rewrites.  ``capture_s`` is the capture's
    seconds."""

    def __init__(self, fn: Callable[[], Any], device, pool):
        # imported here: the kernels' package imports core/, which graphs
        from repro_torch.kernels import ops as kops

        t0 = time.perf_counter()
        side = side_stream(device)
        # a dead object left in a reference cycle frees its graphs' pool
        # (cudaFree) when the collector finds it: refused while this
        # thread captures, it would invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        before = kops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            # capture_begin, not ``torch.cuda.graph``: that context
            # synchronizes the card and empties the allocator's cache at
            # every capture, so the next allocations cudaMalloc again
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool,
                                         capture_error_mode="thread_local")
                try:
                    self.out = fn()
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            # the capture counted its kernels but launched none
            self.tally = kops.take_launches(before)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def replay(self) -> Any:
        from repro_torch.kernels import ops as kops

        self.graph.replay()
        self.replays += 1
        kops.add_launches(self.tally)
        return self.out


@dataclasses.dataclass
class _Entry:
    """One key of a scope: its calls, and after the second its static
    input buffers (the tensor leaves, in order) and graph."""

    calls: int = 0
    inputs: "list | None" = None
    graph: "Graph | None" = None


class Scope:
    """The graphs of one run and the pool they share (JAX: the jit cache
    of a process).  ``stats()`` counts every graph the scope captured,
    dropped ones included; its ``pool_bytes``, read once at ``close()``,
    is what the pool and the static buffers returned to the card."""

    def __init__(self):
        self.entries: dict = {}
        self.pool = self.anchor = self.device = None
        self._stats = {"calls": 0, "eager": 0, "graphs": 0, "replays": 0,
                       "capture_s": 0.0, "pool_bytes": 0}

    def stats(self) -> dict:
        return dict(self._stats)

    def open_pool(self, device) -> None:
        """Make the pool at the first capture, with its anchor: a
        one-kernel graph kept to the close.  The card's and the host's
        caching allocators count each pool's live graphs, and refuse a
        capture into a pool whose count fell to 0 (a block's passes
        dropped, no solve's graph alive) until both caches are emptied —
        what ``torch.cuda.graph`` does before every capture."""
        if self.pool is None:
            self.pool, self.device = torch.cuda.graph_pool_handle(), device
            one = torch.zeros((), device=device)
            self.anchor = Graph(lambda: one.add_(1.0), device, self.pool)

    def drop(self, fn: "Graphed") -> None:
        """Forget ``fn``'s graphs (a block's passes once it is done)."""
        for key in [k for k in self.entries if k[0] is fn]:
            del self.entries[key]

    def close(self) -> None:
        """Drop every graph and the pool; return their memory to the
        card."""
        if self.pool is None:
            self.entries.clear()
            return
        held = settled_reserve(self.device)
        self.entries.clear()
        self.pool = self.anchor = None
        self._stats["pool_bytes"] = held - settled_reserve(self.device)


def settled_reserve(device) -> int:
    """The card's reserve once its queued work is done and the allocator's
    free cached blocks are returned (a host sync)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


@contextlib.contextmanager
def scope() -> Iterator[Scope]:
    """Graphs for the calls made inside, released at the exit.  Inside an
    open scope it is that scope: one pool a run."""
    st = _local()
    if st.scope is not None:
        yield st.scope
        return
    st.scope = Scope()
    try:
        yield st.scope
    finally:
        s, st.scope = st.scope, None
        s.close()


def _graph_device(leaves: list):
    """The card a call's tensor leaves lie on; None: it runs inline."""
    for x in leaves:
        if isinstance(x, Tensor) and x.is_cuda:
            return x.device
    return None


def _leaf_key(x) -> Any:
    """A leaf's part of the key: a tensor's shape, dtype, device and the
    strides of its static buffer (``empty_like``: its own when it is dense,
    contiguous when it is not — an expanded view copies into a dense
    buffer, so it keys like one); any other leaf by value."""
    if isinstance(x, Tensor):
        return ("tensor", tuple(x.shape),
                torch.empty_like(x, device="meta").stride(), x.dtype,
                x.device)
    return x


def _check_linalg() -> None:
    lib = torch.backends.cuda.preferred_linalg_library()
    if lib != torch._C._LinalgBackend.Cusolver:
        raise RuntimeError(
            f"captured solves need cuSOLVER, not {lib}: MAGMA's batched "
            "routines stage pointer arrays in host memory that a replay "
            "would read stale (repro_torch.device.resolve_device('cuda') "
            "selects cuSOLVER)")


def graphed(fn: "Callable | None" = None, *, static: tuple = ()):
    """``fn`` run from CUDA graphs inside a ``scope()`` (module docstring).

    ``static`` names the arguments that are part of the key by value, as
    JAX's ``static_argnames``; every other argument is a tree whose tensor
    leaves are the graph's inputs.  Use as ``@graphed``,
    ``@graphed(static=(...))`` or ``graphed(functools.partial(f, ...))``
    for a closure whose bound arguments the graph reads in place.
    """
    if fn is None:
        return functools.partial(graphed, static=static)
    return Graphed(fn, tuple(static))


class Graphed:
    """What ``graphed`` returns: ``fn`` with its graphs' keys."""

    def __init__(self, fn: Callable, static: tuple):
        self.fn, self.static = fn, static
        self.sig = inspect.signature(fn)
        missing = set(static) - set(self.sig.parameters)
        if missing:
            raise TypeError(f"static arguments {sorted(missing)} are not "
                            f"parameters of {fn!r}")
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        st = _local()
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        dyn = {k: v for k, v in bound.arguments.items()
               if k not in self.static}
        leaves, spec = pytree.tree_flatten(dyn)
        device = _graph_device(leaves)
        if device is None or st.scope is None or st.depth or (
                device.type == "cuda" and
                torch.cuda.is_current_stream_capturing()):
            return self.fn(*args, **kwargs)
        sc = st.scope
        static = tuple((k, bound.arguments[k]) for k in self.static)
        key = (self, static, spec, tuple(_leaf_key(x) for x in leaves))
        entry = sc.entries.setdefault(key, _Entry())
        entry.calls += 1
        sc._stats["calls"] += 1

        def call(xs):
            args = dict(bound.arguments)
            args.update(pytree.tree_unflatten(xs, spec))
            b = inspect.BoundArguments(self.sig, args)
            return self.fn(*b.args, **b.kwargs)

        st.depth += 1
        try:
            if entry.calls == 1:               # eager: the warm-up
                sc._stats["eager"] += 1
                return run_on_side(lambda: call(leaves), device)
            if entry.graph is None:
                self._capture(sc, entry, leaves, call, device)
        finally:
            st.depth -= 1
        for buf, x in zip(entry.inputs, leaves):
            if isinstance(x, Tensor):
                buf.copy_(x)
        out = entry.graph.replay()
        sc._stats["replays"] += 1
        return _clone(out)

    def _capture(self, sc: Scope, entry: _Entry, leaves: list,
                 call: Callable, device) -> None:
        _check_linalg()
        entry.inputs = [torch.empty_like(x) if isinstance(x, Tensor) else x
                        for x in leaves]
        sc.open_pool(device)
        inputs = entry.inputs
        entry.graph = Graph(lambda: call(inputs), device, sc.pool)
        sc._stats["graphs"] += 1
        sc._stats["capture_s"] += entry.graph.capture_s


def release(fn: Graphed) -> None:
    """Drop ``fn``'s graphs from the open scope, if any."""
    sc = _local().scope
    if sc is not None:
        sc.drop(fn)
