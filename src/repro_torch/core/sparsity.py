"""n:m compressed weight format (port of ``repro/core/sparsity.py``).

Only the m−n kept values per group are stored, plus their in-group
positions: one per byte (``idx_bits=8``) or two 4-bit positions per byte,
low nibble first (``idx_bits=4``, the serving layout).  2:4 bf16 costs
2×2 bytes of values + 1 byte of indices per 8 dense bytes = 62.5%.

MoE expert stacks pack into one ``NmStackedCompressed`` leaf: the same
layout with a leading expert axis, expert e bitwise ``pack_nm(w[e], mask[e])``.

Index bytes are ``torch.uint8`` here (the JAX package stores the same bytes
as int8 and masks after sign extension); the bytes are identical.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# kernels consumed as reshaped raw weights (MLA's absorbed decode), which
# can never stream the compressed form: compress_params leaves them dense
NON_STREAMABLE_KERNELS = frozenset({"wkv_b"})


@dataclasses.dataclass(frozen=True)
class NmCompressed:
    """n:m-compressed (c, b) weight matrix.

    values:  (c, g·keep) kept weights, group-major, ascending in-group order
    indices: uint8 in-group positions; (c, g·keep) for idx_bits=8,
             (c, ⌈g·keep/2⌉) nibble-packed for idx_bits=4
    """

    values: Tensor
    indices: Tensor
    n: int
    m: int
    b: int           # original column count
    idx_bits: int = 4

    @property
    def kept_per_group(self) -> int:
        return self.m - self.n

    def unpacked_indices(self) -> Tensor:
        """uint8 (c, g·keep) in-group positions regardless of idx_bits."""
        length = (self.b // self.m) * self.kept_per_group
        if self.idx_bits == 4:
            return unpack_indices4(self.indices, length)
        return self.indices


@dataclasses.dataclass(frozen=True)
class NmStackedCompressed:
    """E stacked n:m-compressed expert slices of one (E, in, out) kernel.

    values:  (E, c, g·keep); indices: uint8 (E, c, g·keep) or nibble-packed
    (E, c, ⌈g·keep/2⌉).  Every expert keeps its own mask; the (n, m) cell
    is shared by the stack.
    """

    values: Tensor
    indices: Tensor
    n: int
    m: int
    b: int           # original column count (per expert)
    E: int           # number of stacked expert slices
    idx_bits: int = 4

    @property
    def kept_per_group(self) -> int:
        return self.m - self.n

    def unpacked_indices(self) -> Tensor:
        """uint8 (E, c, g·keep) in-group positions regardless of idx_bits."""
        length = (self.b // self.m) * self.kept_per_group
        if self.idx_bits == 4:
            return unpack_indices4(self.indices, length)
        return self.indices


def pack_indices4(idx: Tensor) -> Tensor:
    """Pack in-group positions (..., L), values ∈ [0, 16), two per byte.

    Byte t holds entries 2t (low nibble) and 2t+1 (high nibble); an odd L is
    zero-padded into the final high nibble.  → (..., ⌈L/2⌉) uint8.
    """
    u = idx.to(torch.uint8)
    if u.shape[-1] % 2:
        u = torch.nn.functional.pad(u, (0, 1))
    u = u.reshape(*u.shape[:-1], -1, 2)
    return u[..., 0] | (u[..., 1] << 4)


def unpack_indices4(packed: Tensor, length: int) -> Tensor:
    """Inverse of pack_indices4 — (..., ⌈L/2⌉) bytes → (..., ``length``)
    uint8."""
    raw = packed.to(torch.uint8)
    both = torch.stack([raw & 0xF, raw >> 4], dim=-1)
    return both.reshape(*raw.shape[:-1], -1)[..., :length]


def _pack(w: Tensor, mask: Tensor, n: int, m: int, idx_bits: int
          ) -> tuple[Tensor, Tensor]:
    """(values, indices) of n:m-masked (..., c, b) weights, the leading axes
    packed independently."""
    if idx_bits not in (4, 8):
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    if idx_bits == 4 and m > 16:
        raise ValueError(f"4-bit indices need m ≤ 16, got {m}")
    *lead, b = w.shape
    keep = m - n
    g = b // m
    kept = (mask <= 0.5).reshape(*lead, g, m)
    ar = torch.arange(m, device=w.device)
    key = torch.where(kept, ar, m + ar)            # kept positions sort first
    order = torch.argsort(key, dim=-1)[..., :keep]  # keys are unique
    vals = torch.gather(w.reshape(*lead, g, m), -1, order)
    idx8 = order.to(torch.uint8).reshape(*lead, g * keep)
    return (vals.reshape(*lead, g * keep),
            pack_indices4(idx8) if idx_bits == 4 else idx8)


def pack_nm(w: Tensor, mask: Tensor, n: int, m: int, *,
            idx_bits: int = 4) -> NmCompressed:
    """Compress an n:m-masked matrix (mask 1.0 = pruned).

    Every m-group must hold exactly n ones in ``mask`` (``masks.check_nm``).
    Kept positions are stored in ascending in-group order.
    """
    values, indices = _pack(w, mask, n, m, idx_bits)
    return NmCompressed(values=values, indices=indices, n=n, m=m,
                        b=w.shape[-1], idx_bits=idx_bits)


def pack_nm_stacked(w: Tensor, mask: Tensor, n: int, m: int, *,
                    idx_bits: int = 4) -> NmStackedCompressed:
    """Compress E stacked n:m-masked expert slices (E, c, b), paper layout
    per expert (mask 1.0 = pruned); expert e is bitwise
    ``pack_nm(w[e], mask[e])``."""
    if w.dim() != 3 or w.shape != mask.shape:
        raise ValueError(f"need stacked (E, c, b) weights and mask, got "
                         f"{tuple(w.shape)} and {tuple(mask.shape)}")
    values, indices = _pack(w, mask, n, m, idx_bits)
    return NmStackedCompressed(values=values, indices=indices, n=n, m=m,
                               b=w.shape[-1], E=w.shape[0],
                               idx_bits=idx_bits)


def _unpack(packed: "NmCompressed | NmStackedCompressed") -> Tensor:
    """Dense (..., c, b): each kept value lands at its position."""
    *lead, L = packed.values.shape
    g = packed.b // packed.m
    vals = packed.values.reshape(*lead, g, packed.kept_per_group)
    idx = packed.unpacked_indices().reshape(vals.shape).to(torch.int64)
    dense = torch.zeros((*lead, g, packed.m), dtype=packed.values.dtype,
                        device=packed.values.device)
    dense.scatter_(-1, idx, vals)
    return dense.reshape(*lead, packed.b)


def unpack_nm(packed: NmCompressed) -> Tensor:
    """Decompress to dense (c, b)."""
    return _unpack(packed)


def unpack_nm_stacked(packed: NmStackedCompressed) -> Tensor:
    """Decompress to dense (E, c, b) — the oracle of the stacked path."""
    return _unpack(packed)


def compression_ratio(packed: "NmCompressed | NmStackedCompressed") -> float:
    """Bytes(compressed) / bytes(dense)."""
    item = packed.values.element_size()
    val_bytes = packed.values.numel() * item
    idx_bytes = packed.indices.numel()
    rows = packed.values.numel() // packed.values.shape[-1]   # E·c or c
    return (val_bytes + idx_bytes) / (rows * packed.b * item)
