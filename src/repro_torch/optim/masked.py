"""Sparsity-preserving gradient transform — sparse finetuning after pruning
(port of ``repro/optim/masked.py``).

``sparsity_preserving`` wraps any (init, update) optimizer so that pruned
coordinates receive a zero gradient before the update and are zeroed again
in the parameters after it (guarding against weight decay and numerical
drift).  Masks are keyed like ``PruneReport.masks``: ``path`` for a whole
(in, out) kernel, ``(*path, e)`` for expert slice e of a stacked
(E, in, out) kernel; a 1 marks a pruned weight.  Leaves without a mask
pass through untouched.

The zeroing is ``masked_fill`` with the boolean masks, not a multiply by a
float keep-tree: the same values for finite inputs, without a second tree
as large as the masked kernels.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.schedule import get_path


def _mask_tree(params, masks: dict[tuple, Any]):
    """{leaf path: [(expert index or None, bool pruned mask)]} for every
    masked leaf of ``params``."""
    out: dict[tuple, list] = {}
    for path, m in masks.items():
        e = path[-1] if isinstance(path[-1], int) and \
            not isinstance(get_path(params, path[:-1]), dict) else None
        leaf = path if e is None else path[:-1]
        dev = get_path(params, leaf).device         # KeyError if stale
        pruned = m if m.dtype == torch.bool else m > 0.5
        out.setdefault(leaf, []).append((e, pruned.to(dev)))
    return out


def _zero(tree, keep: dict, inplace: bool):
    """``tree`` with every pruned coordinate set to 0."""
    if not inplace:
        tree = _copy_dicts(tree)
    for leaf, entries in keep.items():
        x = get_path(tree, leaf)
        if not inplace:
            x = x.clone()
            parent = get_path(tree, leaf[:-1])
            parent[leaf[-1]] = x
        for e, pruned in entries:
            (x if e is None else x[e]).masked_fill_(pruned, 0)
    return tree


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def sparsity_preserving(optimizer, masks: dict[tuple, Any]):
    """Wrap an AdamW-like optimizer to freeze pruned coordinates."""

    class Wrapped:
        def __init__(self):
            self._keep = None

        def init(self, params):
            return optimizer.init(params)

        def update(self, grads, state, params, lr, *, inplace: bool = False):
            if self._keep is None:
                self._keep = _mask_tree(params, masks)
            with torch.no_grad():
                grads = _zero(grads, self._keep, inplace)
                new_params, new_state = optimizer.update(
                    grads, state, params, lr, inplace=inplace)
                # the inner update returned its own tensors: zero in place
                new_params = _zero(new_params, self._keep, True)
            return new_params, new_state

    return Wrapped()


def masks_by_path(params, report_masks: dict[tuple, Any]):
    """Validate that every mask path resolves into the param tree."""
    for path in report_masks:
        p = path[:-1] if isinstance(path[-1], int) else path
        get_path(params, p)  # raises KeyError if stale
    return report_masks
