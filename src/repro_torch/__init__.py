"""PyTorch/CUDA port of the Thanos pruning system (``src/repro`` is the JAX
reference it is held against).

Same subpackage layout and module names as ``repro``; parameters are
nested dicts of tensors with the JAX tree's paths and its ``(in, out)``
kernel layout.  The two Pallas kernels on the main path are hand-written
CUDA C++ for ``sm_90a`` (``kernels/csrc``), built at first use.

Every entry point takes ``device`` (default ``"cuda"``) and raises when CUDA
is absent unless the caller passes ``device="cpu"``.  This package never
imports ``jax`` or ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
