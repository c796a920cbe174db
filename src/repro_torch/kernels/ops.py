"""Dispatch over the kernels (port of ``repro/kernels/ops.py``).

``impl`` picks the implementation: ``"auto"`` (the default) launches the
CUDA kernel for a CUDA tensor and runs the plain PyTorch version for a CPU
tensor; ``"ref"`` runs the plain version wherever the tensor lies (the
oracle the kernels are held against); ``"kernel"`` demands the CUDA kernel
and raises on a CPU tensor.  No path quietly gives way to another: a failed
build or launch raises.

``NmKernelConfig`` is the serving-side choice: the engine threads it from
``ServeConfig`` through ``model_builder`` into ``layers.dense``.

Each CUDA wrapper counts the launches it makes (``launches``, and
``by_shape``).  A CUDA graph replays kernels without running the wrappers,
so the serving engine takes a graph's tally at capture
(``launch_counts`` / ``take_launches``) and adds it on every replay
(``add_launches``).
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.sparsity import NmCompressed, NmStackedCompressed
from repro_torch.kernels import hessian_accum, nm_spmm, ref

Tensor = torch.Tensor

IMPLS = ("auto", "ref", "kernel")


@dataclasses.dataclass(frozen=True)
class NmKernelConfig:
    """How ``layers.dense`` runs an NmCompressed matmul."""

    impl: str = "auto"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; known: {IMPLS}")


def use_kernel(t: Tensor, impl: str) -> bool:
    """Whether ``impl`` runs the CUDA kernel on tensor ``t``."""
    if impl in ("auto", ""):
        return t.is_cuda
    if impl == "ref":
        return False
    if impl == "kernel":
        if not t.is_cuda:
            raise ValueError("impl='kernel' needs a CUDA tensor; the CUDA "
                             f"kernels do not run on {t.device}")
        return True
    raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


def nm_matmul(x: Tensor, packed: NmCompressed, *, impl: str = "",
              cfg: NmKernelConfig | None = None) -> Tensor:
    """y = x @ Wᵀ for n:m compressed W (c, b); x (..., b) → y (..., c)."""
    cfg = cfg if cfg is not None else NmKernelConfig()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel(x2, impl or cfg.impl):
        y = nm_spmm.nm_matmul_cuda(x2, packed.values, packed.indices,
                                   n=packed.n, m=packed.m, b=packed.b,
                                   idx_bits=packed.idx_bits)
    else:
        y = ref.nm_matmul_ref(x2, packed.values, packed.indices, packed.n,
                              packed.m, packed.b, packed.idx_bits)
    return y.reshape(*lead, -1)


def nm_matmul_stacked(x: Tensor, packed: NmStackedCompressed, *,
                      impl: str = "",
                      cfg: NmKernelConfig | None = None) -> Tensor:
    """Batched expert matmul over one stacked compressed leaf:
    x (E, C, b) → y (E, C, c), y[e] = x[e] @ W_eᵀ — K3 (one launch for
    the stack) on a CUDA tensor, the plain version on a CPU tensor."""
    cfg = cfg if cfg is not None else NmKernelConfig()
    if use_kernel(x, impl or cfg.impl):
        return nm_spmm.nm_matmul_stacked_cuda(
            x, packed.values, packed.indices, n=packed.n, m=packed.m,
            b=packed.b, idx_bits=packed.idx_bits)
    return ref.nm_matmul_stacked_ref(x, packed.values, packed.indices,
                                     packed.n, packed.m, packed.b,
                                     packed.idx_bits)


def hessian_update(x: Tensor, valid: "Tensor | None", xtx: Tensor,
                   count: Tensor, skipped: Tensor) -> None:
    """The fused accumulator update (kernels/hessian_accum.py), in place:
    K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        hessian_accum.hessian_update_cuda(x, valid, xtx, count, skipped)
    else:
        hessian_accum.hessian_update_plain(x, valid, xtx, count, skipped)


def hessian_xtx(x: Tensor) -> Tensor:
    """H = 2·XᵀX for token-major activations x (..., b): K1 on a CUDA
    tensor, the plain version on a CPU tensor."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        return hessian_accum.hessian_xtx_cuda(x2)
    return ref.hessian_ref(x2)


def _counted() -> tuple:
    """The CUDA wrappers that count their launches (read at call time)."""
    return (hessian_accum.hessian_update_cuda, nm_spmm.nm_matmul_cuda,
            nm_spmm.nm_matmul_stacked_cuda)


def launch_counts() -> list:
    """Each wrapper's counts, read now → [(wrapper, launches, by_shape)]."""
    return [(fn, fn.launches, collections.Counter(fn.by_shape))
            for fn in _counted()]


def take_launches(before: list) -> list:
    """The launches counted since ``before`` (a ``launch_counts()``
    reading), with every wrapper's counts put back to it — a capture counts
    the kernels it records but launches none → the tally
    [(wrapper, launches, by_shape)] that ``add_launches`` adds."""
    tally = []
    for fn, n, shapes in before:
        delta = collections.Counter(fn.by_shape)
        delta.subtract(shapes)
        tally.append((fn, fn.launches - n, +delta))
        fn.launches = n
        fn.by_shape.clear()
        fn.by_shape.update(shapes)
    return tally


def add_launches(tally: list) -> None:
    """Add a tally to its wrappers' counts (a replay's launches)."""
    for fn, n, shapes in tally:
        fn.launches += n
        for key, k in shapes.items():
            fn.by_shape[key] = fn.by_shape.get(key, 0) + k
