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

``graphed(fn, donate=(...))`` mirrors ``donate_argnums``: a donated
argument's tensor leaves are not copied into static buffers.  The graph
is captured over the caller's own tensors, so their storage is part of the
key (``data_ptr`` with shape, stride and dtype), and an output that is a
donated leaf, or a view of one, comes back as the caller's tensor (the
eager warm-up's too): a train step updates its parameters and moments in
place, with no copy of the tree in and no clone out.  A key holds its
donated storage weakly; a key whose donated storage is gone (a tree
restored from a checkpoint replaced it) is dropped at the next call.

A step that owns its graphs, as a jitted JAX function owns its cache, is
a ``Compiled`` (``train/step.TrainStep``, the tooling's prefill and decode
steps, the training stream's sampler): it keeps a ``Scope(measure=True)``
and enters it around each call with ``scope(own)``, so its pool lives as
long as the step and its ``pool_bytes`` is read around each capture.

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
import weakref
from typing import Any, Callable, Iterator

import torch
from torch.utils import _pytree as pytree

from repro_torch.util.tree import data_ptrs

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


def _storage(t: Tensor) -> int:
    return t.untyped_storage().data_ptr()


def run_on_side(fn: Callable[[], Any], device, keep: list = ()) -> Any:
    """``fn()`` eagerly on the thread's side stream, ordered after the
    current stream's work and before its later work.  Its tensors are
    returned as clones made on the current stream: a tensor of the side
    stream's would need ``record_stream``, and one that outlives the
    process's CUDA context (a prune's tree handed to another process
    through CUDA IPC is freed at exit) records an event on a dead driver
    and aborts the exit.  A tensor on the storage of a tensor of ``keep``
    (the donated leaves: the caller's, written in place) is returned as
    it is."""
    side = side_stream(device)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(main)
    kept = {_storage(t) for t in keep}
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, Tensor) and
        _storage(t) not in kept else t, out)


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
        # the generator a capture registers (the current device's default)
        # leaves capture mode only in torch's epilogue of a capture that
        # succeeds: after a failed one its next draw would raise, so it
        # gets back a copy of its state from before the capture
        gen = torch.cuda.default_generators[side.device.index]
        saved = gen.clone_state()
        try:
            # capture_begin, not ``torch.cuda.graph``: that context
            # synchronizes the card and empties the allocator's cache at
            # every capture, so the next allocations cudaMalloc again
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool,
                                         capture_error_mode="thread_local")
                try:
                    self.out = fn()
                except BaseException:
                    # the capture is invalid: end it (its own error follows
                    # from fn's) and raise fn's
                    with contextlib.suppress(RuntimeError):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
        except BaseException:
            gen.graphsafe_set_state(saved)
            raise
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
    """One key of a scope: its calls, weak references to its donated
    leaves' storage, and after the second call its inputs (a static buffer
    for each copied tensor leaf, None for a donated one between calls),
    graph and output plan (for each output leaf: None, cloned out; i, the
    call's donated leaf i; or a view of it as (i, offset, shape, stride))."""

    calls: int = 0
    refs: list = dataclasses.field(default_factory=list)
    inputs: "list | None" = None
    graph: "Graph | None" = None
    plan: "list | None" = None

    def dead(self) -> bool:
        return any(r() is None for r in self.refs)


class Scope:
    """The graphs of one run and the pool they share (JAX: the jit cache
    of a process).  ``stats()`` counts every graph the scope captured,
    dropped ones included; its ``pool_bytes`` is what the pool and the
    static buffers returned to the card, read once at ``close()`` — or,
    with ``measure=True`` (a step that owns its scope), what each capture
    added to the card's reserve, read around it (a host sync a capture)."""

    def __init__(self, *, measure: bool = False):
        self.entries: dict = {}
        self.measure = measure
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

    def drop_dead(self) -> None:
        """Forget the keys whose donated storage is gone."""
        for key in [k for k, e in self.entries.items() if e.dead()]:
            del self.entries[key]

    def close(self) -> None:
        """Drop every graph and the pool; return their memory to the
        card."""
        if self.pool is None or self.measure:
            self.entries.clear()
            self.pool = self.anchor = None
            return
        held = settled_reserve(self.device)
        self.entries.clear()
        self.pool = self.anchor = None
        self._stats["pool_bytes"] = held - settled_reserve(self.device)


class Compiled:
    """A compiled callable (JAX: a jitted function and its cache):
    ``c(*args)`` runs ``run`` — whose graphed bodies key their graphs —
    inside the object's own ``Scope(measure=True)``; ``__wrapped__`` runs
    ``direct``, the same code with the bodies called directly (no graph).
    ``stats()`` gives the scope's counters (graphs, replays, capture_s,
    pool_bytes); ``release()`` drops the graphs and returns their pool to
    the card, as dropping the object does (a later call captures again)."""

    def __init__(self, run: Callable, direct: Callable):
        self._scope = Scope(measure=True)
        self._run = run
        self.__wrapped__ = direct

    def __call__(self, *args, **kwargs):
        with scope(self._scope):
            return self._run(*args, **kwargs)

    def stats(self) -> dict:
        return self._scope.stats()

    def release(self) -> None:
        self._scope.close()


def check_in_place(ptrs: list, cache, model) -> None:
    """Raise unless ``cache``'s tensors lie at ``ptrs`` (``tree.data_ptrs``
    of the cache before ``model``'s step): a step that rebinds a cache
    tensor would leave a captured graph writing stale buffers."""
    if data_ptrs(cache) != ptrs:
        raise RuntimeError(
            f"{type(model).__name__}.decode_step rebinds a cache tensor: a "
            f"captured step would replay into stale buffers")


def settled_reserve(device) -> int:
    """The card's reserve once its queued work is done and the allocator's
    free cached blocks are returned (a host sync)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


@contextlib.contextmanager
def scope(own: "Scope | None" = None) -> Iterator[Scope]:
    """Graphs for the calls made inside, released at the exit.  Inside an
    open scope it is that scope: one pool a run.  ``scope(own)`` makes
    ``own`` the thread's scope for the block and leaves it open: its
    owner releases it."""
    st = _local()
    if own is not None:
        prev, st.scope = st.scope, own
        try:
            yield own
        finally:
            st.scope = prev
        return
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


def _donated_key(x: Tensor) -> tuple:
    """A donated leaf's part of the key: the storage the graph binds."""
    return ("donated", x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
            x.device)


def graphed(fn: "Callable | None" = None, *, static: tuple = (),
            donate: tuple = ()):
    """``fn`` run from CUDA graphs inside a ``scope()`` (module docstring).

    ``static`` names the arguments that are part of the key by value, as
    JAX's ``static_argnames``; ``donate`` names the arguments whose tensor
    leaves the graph reads and writes in place, as JAX's
    ``donate_argnums``; every other argument is a tree whose tensor leaves
    are copied into the graph's static inputs.  Use as ``@graphed``,
    ``@graphed(static=(...))`` or ``graphed(functools.partial(f, ...))``
    for a closure whose bound arguments the graph reads in place.
    """
    if fn is None:
        return functools.partial(graphed, static=static, donate=donate)
    return Graphed(fn, tuple(static), tuple(donate))


class Graphed:
    """What ``graphed`` returns: ``fn`` with its graphs' keys."""

    def __init__(self, fn: Callable, static: tuple, donate: tuple = ()):
        self.fn, self.static, self.donate = fn, static, donate
        self.sig = inspect.signature(fn)
        for what, names in (("static", static), ("donated", donate)):
            missing = set(names) - set(self.sig.parameters)
            if missing:
                raise TypeError(f"{what} arguments {sorted(missing)} are "
                                f"not parameters of {fn!r}")
        if set(static) & set(donate):
            raise TypeError(f"arguments {sorted(set(static) & set(donate))}"
                            " are both static and donated")
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
        gift = [isinstance(x, Tensor) and d for x, d in zip(
            leaves, pytree.tree_leaves({k: pytree.tree_map(
                lambda _, d=k in self.donate: d, v) for k, v in
                dyn.items()}))]
        static = tuple((k, bound.arguments[k]) for k in self.static)
        key = (self, static, spec, tuple(
            _donated_key(x) if d else _leaf_key(x)
            for x, d in zip(leaves, gift)))
        sc.drop_dead()
        entry = sc.entries.get(key)
        if entry is None:
            entry = sc.entries[key] = _Entry(refs=[
                weakref.ref(x.untyped_storage())
                for x, d in zip(leaves, gift) if d])
        entry.calls += 1
        sc._stats["calls"] += 1

        fixed = dict(static)          # a graph's closure holds no tree

        def call(xs):
            args = dict(fixed, **pytree.tree_unflatten(xs, spec))
            b = inspect.BoundArguments(self.sig, args)
            return self.fn(*b.args, **b.kwargs)

        st.depth += 1
        try:
            if entry.calls == 1:               # eager: the warm-up
                sc._stats["eager"] += 1
                return run_on_side(lambda: call(leaves), device, [
                    x for x, d in zip(leaves, gift) if d])
            if entry.graph is None:
                entry.inputs = [None if d else torch.empty_like(x)
                                if isinstance(x, Tensor) else x
                                for x, d in zip(leaves, gift)]
            ins = entry.inputs
            for i, (x, d) in enumerate(zip(leaves, gift)):
                if d:
                    ins[i] = x      # what a capture binds: the same storage
                elif isinstance(x, Tensor):
                    ins[i].copy_(x)
            try:
                if entry.graph is None:
                    self._capture(sc, entry, leaves, gift, call, device)
                out = entry.graph.replay()
            finally:
                # the graph keeps no donated tensor alive: its key holds
                # them weakly, and each call binds its own
                for i, d in enumerate(gift):
                    if d:
                        ins[i] = None
        finally:
            st.depth -= 1
        sc._stats["replays"] += 1
        outs, out_spec = pytree.tree_flatten(out)
        return pytree.tree_unflatten(
            [_returned(o, p, leaves) for o, p in zip(outs, entry.plan)],
            out_spec)

    def _capture(self, sc: Scope, entry: _Entry, leaves: list, gift: list,
                 call: Callable, device) -> None:
        _check_linalg()
        sc.open_pool(device)
        before = settled_reserve(device) if sc.measure else 0
        inputs = entry.inputs
        graph = Graph(lambda: call(inputs), device, sc.pool)
        if sc.measure:
            sc._stats["pool_bytes"] += settled_reserve(device) - before
        outs, out_spec = pytree.tree_flatten(graph.out)
        entry.plan = _alias_plan(outs, leaves, gift)
        graph.out = pytree.tree_unflatten(
            [o if p is None else None for o, p in zip(outs, entry.plan)],
            out_spec)
        entry.graph = graph
        sc._stats["graphs"] += 1
        sc._stats["capture_s"] += graph.capture_s


def _alias_plan(outs: list, leaves: list, gift: list) -> list:
    """For each output leaf of a capture: None (not on donated storage),
    i (donated leaf i itself) or (i, offset, shape, stride) (a view of
    donated leaf i's storage)."""
    same = {id(x): i for i, (x, d) in enumerate(zip(leaves, gift)) if d}
    store = {_storage(x): i for i, (x, d) in enumerate(zip(leaves, gift))
             if d}
    plan: list = []
    for o in outs:
        if not isinstance(o, Tensor):
            plan.append(None)
        elif id(o) in same:
            plan.append(same[id(o)])
        elif _storage(o) in store:
            plan.append((store[_storage(o)], o.storage_offset(),
                         tuple(o.shape), o.stride()))
        else:
            plan.append(None)
    return plan


def _returned(o, p, leaves: list):
    """A replay's output leaf ``o`` as the caller gets it (``_alias_plan``):
    a clone out of the pool, or the call's donated tensor or a view of
    it."""
    if p is None:
        return o.clone() if isinstance(o, Tensor) else o
    if isinstance(p, int):
        return leaves[p]
    i, offset, shape, stride = p
    x = leaves[i]
    return x.new_empty(0).set_(x.untyped_storage(), offset, shape, stride)


def release(fn: Graphed) -> None:
    """Drop ``fn``'s graphs from the open scope, if any."""
    sc = _local().scope
    if sc is not None:
        sc.drop(fn)
