"""n:m compressed parameter trees for the decode path (port of
``repro/serve/compressed.py`` for 2-D kernels).

``compress_params`` swaps every masked (in, out) kernel for an
``NmCompressed`` leaf (values + nibble-packed indices), which the serving
engine keeps resident and streams through K2.  ``decompress_params`` is the
inverse: not on the serve path, it is the oracle the engine is held
against.  A mask that cannot be packed is a residency downgrade — warned
(``CompressionDowngrade``), raised under ``strict=True``, never silent.
"""
from __future__ import annotations

import warnings
from typing import Any

from repro_torch.core.schedule import get_path, path_str, set_path
from repro_torch.core.sparsity import NmCompressed, pack_nm, unpack_nm

# kernels consumed as reshaped raw weights (MLA's absorbed decode), which
# can never stream the compressed form
NON_STREAMABLE_KERNELS = frozenset({"wkv_b"})


class CompressionDowngrade(UserWarning):
    """A masked layer could not be packed and will serve dense."""


def _downgrade(msg: str, strict: bool) -> None:
    if strict:
        raise ValueError(msg)
    warnings.warn(msg, CompressionDowngrade, stacklevel=3)


def compress_params(params, masks: dict[tuple, Any], n: int, m: int, *,
                    idx_bits: int = 4, strict: bool = False):
    """Replace masked (in, out) kernels with NmCompressed leaves.

    Masks are keyed by param path (mask 1.0 = pruned, stored (in, out) like
    the kernel); n:m groups run along the input dim, so each kernel is
    packed in the paper's (out, in) layout.
    """
    out = params
    for path, mask in masks.items():
        if isinstance(path[-1], int):
            _downgrade(f"expert slice {path_str(path)!r}: stacked compressed "
                       "leaves are not ported yet; the stack will SERVE "
                       "DENSE", strict)
            continue
        if any(p in NON_STREAMABLE_KERNELS for p in path
               if isinstance(p, str)):
            _downgrade(f"kernel {path_str(path)!r} cannot stream "
                       "NmCompressed; the layer will SERVE DENSE", strict)
            continue
        kernel = get_path(params, path)
        out = set_path(out, path, pack_nm(kernel.T, mask.T, n, m,
                                          idx_bits=idx_bits))
    return out


def decompress_params(params):
    """Inverse of compress_params — compressed leaves → dense kernels.

    A kernel comes back as the transposed view of the expanded (c, b)
    matrix, so ``x @ W`` is the very product ``x @ Wᵀ`` the plain
    compressed matmul computes (bit-equal serving on the plain path)."""

    def walk(node):
        if isinstance(node, NmCompressed):
            return unpack_nm(node).T       # back to (in, out)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def compressed_bytes(params) -> tuple[int, int]:
    """(compressed_bytes, dense_equivalent_bytes) over compressed leaves."""
    comp = dense = 0

    def walk(node):
        nonlocal comp, dense
        if isinstance(node, NmCompressed):
            item = node.values.element_size()
            comp += node.values.numel() * item + node.indices.numel()
            dense += node.values.shape[0] * node.b * item
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(params)
    return comp, dense
