"""Shared NN layers — plain functions on tensors, tape-instrumented for
Alg.-3 calibration (port of ``repro/models/layers.py``).

Every prunable linear goes through ``dense()`` (or ``stacked_dense()`` for
an (E, in, out) expert stack), which records its input on the capture tape
when one is threaded.  Params are nested dicts; kernels are stored (in,
out).
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import NmCompressed, NmStackedCompressed
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor
Tape = dict | None
Path = tuple[Any, ...]

# The active NmKernelConfig for NmCompressed leaves (None = ops default).
# A module-level slot, as in the JAX package: ``dense`` sits below call
# sites that thread (tape, path) only, and the serving engine wraps its
# steps in ``nm_kernel_scope``.
_NM_KERNEL = None


@contextlib.contextmanager
def nm_kernel_scope(cfg):
    """Activate an NmKernelConfig around a region."""
    global _NM_KERNEL
    prev = _NM_KERNEL
    _NM_KERNEL = cfg
    try:
        yield
    finally:
        _NM_KERNEL = prev


# --------------------------------------------------------------------------
# initializers (explicit torch.Generator; values differ from JAX's threefry)
# --------------------------------------------------------------------------
def he_init(gen: torch.Generator, shape, dtype, device,
            fan_in: int | None = None) -> Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    fan = fan_in if fan_in is not None else shape[0]
    return (w * (2.0 / fan) ** 0.5).to(dtype)


def linear_params(gen, d_in: int, d_out: int, *, bias: bool = False,
                  dtype=torch.float32, device="cpu") -> dict:
    p = {"w": he_init(gen, (d_in, d_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def stacked_linear_params(gen, n: int, d_in: int, d_out: int,
                          dtype=torch.float32, device="cpu") -> dict:
    """n stacked expert kernels (n, d_in, d_out), fan-in d_in."""
    return {"w": he_init(gen, (n, d_in, d_out), dtype, device, fan_in=d_in)}


def embedding_params(gen, vocab: int, d: int, dtype=torch.float32,
                     device="cpu") -> dict:
    t = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return {"table": (t * 0.02).to(dtype)}


def rmsnorm_params(d: int, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# tape-instrumented linear
# --------------------------------------------------------------------------
def dense(p: dict, x: Tensor, tape: Tape = None, path: Path = ()) -> Tensor:
    """y = x @ W (+ b).  x (..., d_in).  Records x on the tape.

    An ``NmCompressed`` kernel is consumed compressed through
    ``kernels/ops.nm_matmul`` under the active ``NmKernelConfig`` — K2 on
    the card, its plain version on the CPU.
    """
    w = p["w"]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, NmCompressed):
        y = kops.nm_matmul(x2, w, cfg=_NM_KERNEL)
    else:
        if tape is not None:
            tape[path + ("w",)] = x2
        y = x2 @ w
    if "b" in p:
        y = y + p["b"]
    return y.reshape(*x.shape[:-1], -1)


def stacked_dense(p: dict, x: Tensor, tape: Tape = None, path: Path = (),
                  valid: "Tensor | None" = None) -> Tensor:
    """Batched expert matmul: x (E, C, d_in) @ W (E, d_in, d_out).

    An ``NmStackedCompressed`` kernel is consumed compressed through
    ``kernels/ops.nm_matmul_stacked`` (K3 on the card, one launch for the
    stack).  The tape records expert e's input under (path, 'w', e); with
    ``valid`` (E, C) bool — the capacity rows holding routed tokens — the
    entry is the pair (x[e], valid[e]), so each expert's Hessian counts only
    its routed tokens.
    """
    w = p["w"]
    if isinstance(w, NmStackedCompressed):
        return kops.nm_matmul_stacked(x, w, cfg=_NM_KERNEL)
    if tape is not None:
        for e in range(w.shape[0]):
            tape[path + ("w", e)] = (x[e] if valid is None
                                     else (x[e], valid[e]))
    return torch.einsum("ecd,edf->ecf", x, w)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------
def rmsnorm(p: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"]


def act_fn(name: str):
    return {"silu": F.silu, "gelu": F.gelu, "relu": F.relu}[name]


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device) -> Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (B, S, H, Dh); positions (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (B,S,Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# embeddings / head / loss
# --------------------------------------------------------------------------
def embed(p: dict, tokens: Tensor) -> Tensor:
    return p["table"][tokens]


def unembed(p: dict, x: Tensor) -> Tensor:
    """Tied LM head (logits = x @ tableᵀ)."""
    return x @ p["table"].T


def cross_entropy(logits: Tensor, labels: Tensor, ignore: int = -1) -> Tensor:
    """Mean next-token CE; labels == ignore are masked out."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels != ignore).to(torch.float32)
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
