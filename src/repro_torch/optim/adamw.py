"""AdamW with decoupled weight decay + global-norm clipping (port of
``repro/optim/adamw.py``).

The functional (init, update) protocol over the port's nested-dict trees.
Moments are stored in ``moment_dtype`` and their arithmetic is float32; the
new parameters are cast back to each parameter's dtype.  The update runs
as ``torch._foreach_*`` operations over all leaves at once (a handful of
launches per step on the card), with the JAX package's operation order:

    mu  = b1·m + (1 − b1)·g            nu = b2·v + (1 − b2)·g²
    bc1 = 1 − b1**t,  bc2 = 1 − b2**t  (t the new step, float32)
    Δ   = (mu / bc1) / (sqrt(nu / bc2) + eps)  [+ wd·p where p.ndim ≥ 2]
    p'  = p − lr·Δ

``AdamWState.step`` is a 0-d int32 tensor on the host: the schedule and
the bias corrections are float32 scalars computed there and handed to the
device operations as exact scalars, so a step never waits on the card.
``update(..., inplace=True)`` writes the moments and the parameters into
their own storage (the train step's ``donate=True``); otherwise the
caller's trees are left as they were.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.util.tree import (leaves, map_tree, sorted_leaves,
                                   unflatten_like)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the host
    mu: object           # tree like params, in moment_dtype
    nu: object           # tree like params, in moment_dtype


class AdamW(NamedTuple):
    """AdamW hyperparameters; ``lr`` is supplied per step (a schedule).

    ``moment_dtype='bfloat16'`` stores 16-bit moments; the moment math
    stays float32."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0       # 0 disables clipping
    moment_dtype: str = "float32"

    @property
    def _mdt(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype)

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self._mdt, device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=map_tree(zeros, params),
                          nu=map_tree(zeros, params))

    def update(self, grads, state: AdamWState, params, lr, *,
               inplace: bool = False):
        """→ (new_params, new_state).  ``lr`` is a 0-d float32 tensor (or a
        number).  ``inplace`` also lets clipping scale ``grads`` in place."""
        with torch.no_grad():
            return self._update(grads, state, params, lr, inplace)

    def _update(self, grads, state, params, lr, inplace):
        if self.clip_norm > 0:
            grads, _ = clip_by_global_norm(grads, self.clip_norm,
                                           inplace=inplace)
        ps, gs = leaves(params), leaves(grads)
        mus, nus = leaves(state.mu), leaves(state.nu)
        g32 = [g.float() for g in gs]
        b1, b2, mdt = self.b1, self.b2, self._mdt
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = float(1.0 - b1 ** t)          # exact float32 values
        bc2 = float(1.0 - b2 ** t)
        lr = float(torch.as_tensor(lr, dtype=torch.float32))

        def moment(ms, beta, gterm):
            if inplace and mdt == torch.float32:
                torch._foreach_mul_(ms, beta)
                torch._foreach_add_(ms, gterm)
                return ms, ms
            m32 = torch._foreach_mul([m.float() for m in ms], beta)
            torch._foreach_add_(m32, gterm)
            stored = [m.to(mdt) for m in m32]
            if inplace:
                torch._foreach_copy_(ms, stored)
                stored = ms
            return stored, [m.float() for m in stored]

        mu, mu32 = moment(mus, b1, torch._foreach_mul(g32, 1 - b1))
        sq = torch._foreach_mul(g32, g32)
        torch._foreach_mul_(sq, 1 - b2)
        del g32
        nu, nu32 = moment(nus, b2, sq)
        del sq
        delta = torch._foreach_div(mu32, bc1)
        den = torch._foreach_div(nu32, bc2)
        del mu32, nu32
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(delta, den)
        del den
        decay = [i for i, p in enumerate(ps) if p.ndim >= 2]
        if self.weight_decay > 0 and decay:
            # decoupled weight decay — skip 1-D params (norms, biases)
            torch._foreach_add_(
                [delta[i] for i in decay],
                torch._foreach_mul([ps[i].float() for i in decay],
                                   self.weight_decay))
        torch._foreach_mul_(delta, lr)
        new32 = torch._foreach_sub([p.float() for p in ps], delta)
        del delta
        new = [x.to(p.dtype) for x, p in zip(new32, ps)]
        if inplace:
            torch._foreach_copy_(ps, new)
            return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
        return unflatten_like(params, new), AdamWState(
            step=step, mu=unflatten_like(params, mu),
            nu=unflatten_like(params, nu))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), accumulated in float32 over the leaves
    in sorted-key order."""
    norms = torch._foreach_norm(sorted_leaves(tree), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float, *, inplace: bool = False):
    """→ (clipped grads, pre-clip global norm).  Scale
    min(1, max_norm / max(gnorm, 1e-12)), applied in float32 and cast back
    to each leaf's dtype."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        gs = leaves(grads)
        if inplace:
            torch._foreach_mul_(gs, scale)
            return grads, gnorm
        return unflatten_like(grads, torch._foreach_mul(gs, scale)), gnorm
