"""Carry parameter trees from the JAX package into the port.

``params_from_numpy(tree)`` takes the JAX tree after
``jax.tree.map(np.asarray, params)`` — nested dicts with integer block keys,
numpy leaves, and ``NmCompressed`` / ``NmStackedCompressed`` nodes whose
children are numpy arrays — and returns the port's tree on ``device`` (CUDA
unless the caller passes ``device="cpu"``) with the same paths and the same
(in, out) kernel layout.  It recognises a compressed node by its fields
(values, indices, n, m, b, idx_bits; a stacked one also has E), so it never
imports the JAX package.

bfloat16: JAX hands out ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they cross as their raw uint16 bits.  int8
index bytes cross as the port's uint8 bytes (the same bits).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparsity import NmCompressed, NmStackedCompressed
from repro_torch.device import resolve_device


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array → tensor on ``device``, bfloat16 included."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_compressed(node) -> bool:
    return all(hasattr(node, f) for f in ("values", "indices", "n", "m", "b",
                                          "idx_bits"))


def params_from_numpy(tree, device="cuda"):
    """The JAX parameter tree (numpy leaves) → the port's tree."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if _is_compressed(tree):
        kw = dict(values=tensor_from_numpy(tree.values, device),
                  indices=tensor_from_numpy(
                      np.asarray(tree.indices).view(np.uint8), device),
                  n=int(tree.n), m=int(tree.m), b=int(tree.b),
                  idx_bits=int(tree.idx_bits))
        if hasattr(tree, "E"):
            return NmStackedCompressed(E=int(tree.E), **kw)
        return NmCompressed(**kw)
    return tensor_from_numpy(tree, device)
