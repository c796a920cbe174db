"""train_step factory — loss → grad → clip → AdamW (port of
``repro/train/step.py``).

The step is eager PyTorch.  Gradients come from ``torch.autograd.grad``
over fresh views of the caller's leaves that the step itself marks as
requiring grad, so the caller's tree never becomes autograd leaves.

Remat: ``remat='block'`` runs each ``model.block`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: a block keeps
only its input carry and recomputes its forward in the backward pass.
JAX's policy (``checkpoint_dots_with_no_batch_dims``) also keeps the
matmul outputs; the plain recompute gives the same numbers and saves more
memory for one more forward pass.

Donation: ``donate=True`` (the default) updates the parameters and the
moments in place, JAX's ``donate_argnums`` in PyTorch terms; with
``donate=False`` the step returns new tensors and leaves the caller's trees
untouched.  ``make_sharded_train_step`` belongs to the distribution slice
and is not ported here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.adamw import global_norm
from repro_torch.util.tree import leaves, unflatten_like


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    step: int = 0


def _loss_with_remat(model, remat: str):
    """Model loss with per-block activation checkpointing.  Every port
    model has ``loss_from_carry``, so JAX's ``_final_loss`` fallback has no
    counterpart here."""
    if remat == "none":
        return model.loss
    if remat != "block":
        raise ValueError(f"remat={remat!r}: expected 'block' or 'none'")

    def loss(params, batch):
        carry = model.embed_batch(params, batch)
        for i in range(model.num_blocks()):
            # blocks draw no random numbers and have no data-dependent
            # shapes, so the RNG state and the recompute's metadata check
            # (host time for every saved tensor) are skipped
            carry = checkpoint(model.block, params, i, carry,
                               use_reentrant=False, preserve_rng_state=False,
                               determinism_check="none")
        return model.loss_from_carry(params, carry, batch)

    return loss


def value_and_grad(loss_fn, params, batch):
    """→ (loss, grads tree) of ``loss_fn(params, batch)``; the caller's
    leaves are not marked as requiring grad."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten_like(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), unflatten_like(params, [
        torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)])


def make_train_step(
    model,
    optimizer: AdamW,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    remat: str = "block",
    donate: bool = True,
) -> Callable:
    """→ step(params, opt_state, batch) → (params, opt_state, metrics) with
    metrics {"loss", "lr", "grad_norm"} (the norm of the unclipped grads)."""
    loss_fn = _loss_with_remat(model, remat)

    def step(params, opt_state: AdamWState, batch):
        lr = lr_schedule(opt_state.step)
        loss, grads = value_and_grad(loss_fn, params, batch)
        gnorm = global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params, lr,
                                               inplace=donate)
        return new_params, new_opt, {"loss": loss, "lr": lr,
                                     "grad_norm": gnorm}

    return step
