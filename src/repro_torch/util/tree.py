"""Nested-dict parameter trees: the leaves in one fixed order and a map
that rebuilds the same dicts (the port's stand-in for ``jax.tree``).

A tree is nested dicts whose leaves are tensors (or anything that is not
a dict); the order is the dicts' iteration order, so two trees built the
same way — params, grads, AdamW moments — line up leaf for leaf.

Caches and compressed weights are dicts, lists and tuples of dataclasses:
``flatten`` / ``rebuild`` take such a tree apart into its tensors and a
hashable skeleton and put it together again (what a CUDA graph's key and
its static arguments need), ``fill_`` writes one tree's tensors into
another's in place (a one-row cache resets a cache of any batch), and
``data_ptrs`` reads where its tensors live (a step that rebinds a cache
tensor would leave a captured graph writing stale buffers)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def sorted_leaves(tree) -> list:
    """The leaves with every dict's keys sorted (as ``jax.tree.leaves``
    orders them): the same order for a tree however it was built — by
    ``init`` or by a checkpoint restore, which rebuilds dicts in another
    key order.  Reductions across leaves use it, so their float sums do
    not depend on how the tree was built."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: (isinstance(k, str), k))
        return [x for k in keys for x in sorted_leaves(tree[k])]
    return [tree]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` → a tree of the same dicts."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten_like(tree, values: list):
    """A tree shaped like ``tree`` whose leaves are ``values``, in order."""
    it = iter(values)
    out = map_tree(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


# --------------------------------------------------------------------------
# trees of dicts, lists, tuples and dataclasses (caches, compressed weights)
# --------------------------------------------------------------------------
_TENSOR = "tensor"          # a tensor's place in a skeleton


def _children(x) -> "list | None":
    """A node's (key, child) pairs: a dict's items, a list's or tuple's
    items by index, a dataclass's fields by name; None for a leaf."""
    if isinstance(x, dict):
        return list(x.items())
    if isinstance(x, (list, tuple)):
        return list(enumerate(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    return None


def _child(x, key):
    return getattr(x, key) if dataclasses.is_dataclass(x) else x[key]


def flatten(tree) -> tuple[list, Any]:
    """A tree → (its tensors in order, its skeleton: a hashable description
    that ``rebuild`` fills with tensors again).  Any other leaf stays in
    the skeleton by value."""
    out: list = []
    return out, _walk(tree, out)


def _walk(x, out: list):
    # module-level, not a nested closure: a recursive closure is a
    # reference cycle that would keep ``out`` (a cache's tensors) alive
    # until the collector runs
    if isinstance(x, torch.Tensor):
        out.append(x)
        return _TENSOR
    kids = _children(x)
    if kids is None:
        return (None, x)
    return (type(x), tuple((k, _walk(v, out)) for k, v in kids))


def rebuild(skel, tensors: list):
    """The tree ``flatten`` described by ``skel``, holding ``tensors``."""
    return _build(skel, iter(tensors))


def _build(s, it):
    if s == _TENSOR:
        return next(it)
    kind, body = s
    if kind is None:
        return body
    if issubclass(kind, dict):
        return kind((k, _build(v, it)) for k, v in body)
    if issubclass(kind, (list, tuple)):
        return kind(_build(v, it) for _, v in body)
    return kind(**{k: _build(v, it) for k, v in body})


def fill_(dst, src) -> None:
    """Copy tree ``src`` into ``dst`` in place, tensor by tensor, matched
    by key (any device to any): a one-row source fills every row, so a
    template made by ``init_cache(1, …)`` resets a cache of any batch."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src.expand_as(dst))
        return
    for k, v in _children(dst) or ():
        fill_(v, _child(src, k))


def data_ptrs(tree) -> list:
    """The data pointers of every tensor of a tree, in order."""
    return [t.data_ptr() for t in flatten(tree)[0]]
