"""n:m compressed parameter trees for the decode path (port of
``repro/serve/compressed.py``).

``compress_params`` swaps masked (in, out) kernels for ``NmCompressed``
leaves (values + nibble-packed indices), which the serving engine keeps
resident and streams through K2; MoE expert stacks — masks keyed
(..., 'w', e) — pack into one ``NmStackedCompressed`` leaf per stack,
streamed through K3.  With ``plan=`` each path packs with its own plan
cell's (n, m) and every other path stays dense: mixed residency, dense
leaves served by ``x @ W``.  ``decompress_params`` is the inverse: not on
the serve path, it is the oracle the engine is held against.  A mask that
cannot be packed is a residency downgrade — warned
(``CompressionDowngrade``), raised under ``strict=True``, never silent.
"""
from __future__ import annotations

import warnings
from typing import Any

import torch

from repro_torch.core.plan import PrunePlan, path_str
from repro_torch.core.schedule import get_path, set_path
from repro_torch.core.sparsity import (NON_STREAMABLE_KERNELS,
                                       NmCompressed, NmStackedCompressed,
                                       pack_nm, pack_nm_stacked, unpack_nm,
                                       unpack_nm_stacked)


class CompressionDowngrade(UserWarning):
    """A masked layer could not be packed and will serve dense."""


def _downgrade(msg: str, strict: bool) -> None:
    if strict:
        raise ValueError(msg)
    warnings.warn(msg, CompressionDowngrade, stacklevel=3)


def compress_params(params, masks: dict[tuple, Any], n: int | None = None,
                    m: int | None = None, *, plan: PrunePlan | None = None,
                    idx_bits: int = 4, strict: bool = False):
    """Replace masked (in, out) kernels with NmCompressed leaves.

    Masks are keyed by param path (mask 1.0 = pruned, stored (in, out) like
    the kernel); n:m groups run along the input dim, so each kernel is
    packed in the paper's (out, in) layout.  Two calling modes:

    * a global ``(n, m)`` — every masked kernel packs with that cell;
    * ``plan=`` (e.g. ``report.plan``) — each path resolves through the
      plan: a path whose cell has pattern "nm" packs with its own (n, m),
      every other path (unstructured or structured cells, skip rules)
      stays dense.

    Expert slices (an integer tail into a stacked (E, in, out) kernel) are
    grouped by stack; a stack packs into one ``NmStackedCompressed`` only
    when every slice is n:m-masked under one shared (n, m) cell — partial
    coverage or mixed cells are a downgrade.  A stack whose slices are all
    non-n:m stays dense by design, without a warning.
    """
    if plan is None and (n is None or m is None):
        raise ValueError("compress_params needs (n, m) or plan=")
    out = params
    # base path of the stacked kernel -> {expert: (mask, n, m) | None}
    # (None marks a masked slice whose plan cell is not n:m)
    stacks: dict[tuple, dict[int, tuple | None]] = {}
    for path, mask in masks.items():
        if plan is not None:
            cfg = plan.cfg_for(path)
            nm = cfg is not None and cfg.pattern == "nm"
            pn, pm = (cfg.n, cfg.m) if nm else (None, None)
        else:
            nm, pn, pm = True, n, m
        if isinstance(path[-1], int):
            stacks.setdefault(path[:-1], {})[path[-1]] = \
                (mask, pn, pm) if nm else None
            continue
        if not nm:
            continue                       # stays dense in the serve tree
        if any(p in NON_STREAMABLE_KERNELS for p in path
               if isinstance(p, str)):
            _downgrade(f"kernel {path_str(path)!r} is consumed as a "
                       "reshaped raw weight by the absorbed MLA decode and "
                       "cannot stream NmCompressed; the layer will SERVE "
                       "DENSE", strict)
            continue
        kernel = get_path(params, path)
        out = set_path(out, path, pack_nm(kernel.T, mask.T, pn, pm,
                                          idx_bits=idx_bits))

    for base, slices in sorted(stacks.items(), key=lambda kv: path_str(kv[0])):
        nm_slices = {e: v for e, v in slices.items() if v is not None}
        if not nm_slices:
            continue                       # all-unstructured stack: by design
        kernel = get_path(params, base)    # (E, in, out)
        E = kernel.shape[0]
        cells = {v[1:] for v in nm_slices.values()}
        problems = []
        if len(cells) > 1:
            problems.append(f"mixed n:m cells {sorted(cells)}")
        missing = sorted(set(range(E)) - set(nm_slices))
        if missing:
            problems.append(f"experts {missing} not n:m-masked")
        if problems:
            _downgrade(
                f"cannot pack expert stack {path_str(base)!r} "
                f"({'; '.join(problems)}); the stack will SERVE DENSE — "
                "align the recipe so every expert slice shares one (n, m) "
                "cell, or pass strict=False knowingly", strict)
            continue
        pn, pm = next(iter(cells))
        mk = torch.stack([nm_slices[e][0].T for e in range(E)])
        out = set_path(out, base, pack_nm_stacked(
            kernel.transpose(-1, -2), mk, pn, pm, idx_bits=idx_bits))
    return out


def decompress_params(params):
    """Inverse of compress_params — compressed leaves → dense kernels.

    A kernel comes back as the transposed view of the expanded (c, b)
    matrix, so ``x @ W`` is the very product ``x @ Wᵀ`` the plain
    compressed matmul computes (bit-equal serving on the plain path)."""

    def walk(node):
        if isinstance(node, NmCompressed):
            return unpack_nm(node).T       # back to (in, out)
        if isinstance(node, NmStackedCompressed):     # back to (E, in, out)
            return unpack_nm_stacked(node).transpose(-1, -2)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def compressed_bytes(params) -> tuple[int, int]:
    """(compressed_bytes, dense_equivalent_bytes) over compressed leaves."""
    comp = dense = 0

    def walk(node):
        nonlocal comp, dense
        if isinstance(node, (NmCompressed, NmStackedCompressed)):
            item = node.values.element_size()
            comp += node.values.numel() * item + node.indices.numel()
            rows = node.values.numel() // node.values.shape[-1]  # (E·)c
            dense += rows * node.b * item
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(params)
    return comp, dense
