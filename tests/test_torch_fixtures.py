"""Shared helpers of the PyTorch port's tests (``tests/test_torch_*.py``).

Importing this module caps torch's intra-op threads: the suite runs in
several pytest-xdist workers at once, and each would otherwise start one
thread per core.  Inputs are made with numpy from a seed and handed to both
packages; JAX stays on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def t(a, dtype=None) -> "torch.Tensor":
    """numpy / JAX array → CPU tensor (bfloat16 through its bits)."""
    from repro_torch.convert import tensor_from_numpy

    out = tensor_from_numpy(np.asarray(a), device="cpu")
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor → numpy (float32 for bfloat16)."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy()


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_thread_cap():
    assert torch.get_num_threads() == 1
