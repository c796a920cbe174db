"""Small shared utilities (crash-safe IO, parameter trees)."""
from repro_torch.util.io import (
    atomic_write_bytes, atomic_write_json, atomic_write_text,
)

__all__ = ["atomic_write_bytes", "atomic_write_json", "atomic_write_text"]
