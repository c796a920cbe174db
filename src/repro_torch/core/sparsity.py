"""n:m compressed weight format (port of ``repro/core/sparsity.py``).

Only the m−n kept values per group are stored, plus their in-group
positions: one per byte (``idx_bits=8``) or two 4-bit positions per byte,
low nibble first (``idx_bits=4``, the serving layout).  2:4 bf16 costs
2×2 bytes of values + 1 byte of indices per 8 dense bytes = 62.5%.

Index bytes are ``torch.uint8`` here (the JAX package stores the same bytes
as int8 and masks after sign extension); the bytes are identical.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


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


def pack_indices4(idx: Tensor) -> Tensor:
    """Pack in-group positions (c, L), values ∈ [0, 16), two per byte.

    Byte t holds entries 2t (low nibble) and 2t+1 (high nibble); an odd L is
    zero-padded into the final high nibble.  → (c, ⌈L/2⌉) uint8.
    """
    c, L = idx.shape
    u = idx.to(torch.uint8)
    if L % 2:
        u = torch.nn.functional.pad(u, (0, 1))
    u = u.reshape(c, -1, 2)
    return u[..., 0] | (u[..., 1] << 4)


def unpack_indices4(packed: Tensor, length: int) -> Tensor:
    """Inverse of pack_indices4 — (c, ⌈L/2⌉) bytes → (c, ``length``) uint8."""
    c = packed.shape[0]
    raw = packed.to(torch.uint8)
    both = torch.stack([raw & 0xF, raw >> 4], dim=-1).reshape(c, -1)
    return both[:, :length]


def pack_nm(w: Tensor, mask: Tensor, n: int, m: int, *,
            idx_bits: int = 4) -> NmCompressed:
    """Compress an n:m-masked matrix (mask 1.0 = pruned).

    Every m-group must hold exactly n ones in ``mask`` (``masks.check_nm``).
    Kept positions are stored in ascending in-group order.
    """
    if idx_bits not in (4, 8):
        raise ValueError(f"idx_bits must be 4 or 8, got {idx_bits}")
    if idx_bits == 4 and m > 16:
        raise ValueError(f"4-bit indices need m ≤ 16, got {m}")
    c, b = w.shape
    keep = m - n
    g = b // m
    kept = (mask <= 0.5).reshape(c, g, m)
    ar = torch.arange(m, device=w.device)
    key = torch.where(kept, ar, m + ar)            # kept positions sort first
    order = torch.argsort(key, dim=-1)[..., :keep]  # keys are unique
    vals = torch.gather(w.reshape(c, g, m), -1, order)
    idx8 = order.to(torch.uint8).reshape(c, g * keep)
    return NmCompressed(
        values=vals.reshape(c, g * keep),
        indices=pack_indices4(idx8) if idx_bits == 4 else idx8,
        n=n, m=m, b=b, idx_bits=idx_bits,
    )


def unpack_nm(packed: NmCompressed) -> Tensor:
    """Decompress to dense (c, b): each kept value lands at its position."""
    c = packed.values.shape[0]
    keep = packed.kept_per_group
    g = packed.b // packed.m
    vals = packed.values.reshape(c, g, keep)
    idx = packed.unpacked_indices().reshape(c, g, keep).to(torch.int64)
    dense = torch.zeros((c, g, packed.m), dtype=packed.values.dtype,
                        device=packed.values.device)
    dense.scatter_(-1, idx, vals)
    return dense.reshape(c, packed.b)


def compression_ratio(packed: NmCompressed) -> float:
    """Bytes(compressed) / bytes(dense)."""
    item = packed.values.element_size()
    val_bytes = packed.values.numel() * item
    idx_bytes = packed.indices.numel()
    return (val_bytes + idx_bytes) / (packed.values.shape[0] * packed.b * item)
