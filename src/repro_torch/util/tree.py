"""Nested-dict parameter trees: the leaves in one fixed order and a map
that rebuilds the same dicts (the port's stand-in for ``jax.tree``).

A tree is nested dicts whose leaves are tensors (or anything that is not
a dict); the order is the dicts' iteration order, so two trees built the
same way — params, grads, AdamW moments — line up leaf for leaf."""
from __future__ import annotations

from typing import Any, Callable


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
