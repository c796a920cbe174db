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
untouched.

``make_sharded_train_step`` is the data-parallel step on a DeviceMesh:
params and both moments enter and leave as DTensors in ``param_pspecs``'
layout, each rank takes its rows of the batch (``batch_pspecs``), and the
gradients are averaged over the data axes with one ``all_reduce`` a dtype.
Inside, the step gathers the leaves (``full_tensor()``, no traffic for a
replicated leaf) and runs this module's own step math on them, rather
than propagating DTensor through the model: the models' custom kernels,
the remat checkpoint and the foreach AdamW then run on plain tensors, and
on one rank the step is bitwise ``make_train_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.adamw import global_norm
from repro_torch.util.tree import leaves, map_tree, unflatten_like


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


def _full(x):
    """A DTensor's whole value on this rank — its own storage, with no
    collective, when its local block is the whole tensor (replicated, or
    sharded only over size-1 mesh dims); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    local = x.to_local()
    return local if local.shape == x.shape else x.full_tensor()


def all_reduce_mean(tensors: list, group, n: int) -> None:
    """Average ``tensors`` over ``group`` in place: one SUM all_reduce a
    dtype over a flat copy, then ÷ n (n = 1: untouched)."""
    import torch.distributed as dist
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)

    if n == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


def make_sharded_train_step(model, optimizer: AdamW, lr_schedule, mesh,
                            example_batch, params, *, remat: str = "block"
                            ) -> Callable:
    """→ step(params, opt_state, batch) → (params, opt_state, metrics) on
    ``mesh`` (a DeviceMesh), metrics {"loss", "lr"} as JAX's.

    ``params`` (plain tensors or DTensors: only their shapes are read) and
    ``example_batch`` fix the layouts: params and the AdamW moments in
    ``param_pspecs``' layout, the batch's leading dim over the data axes
    (``batch_pspecs``).  The step takes the global batch on every rank
    (plain tensors or DTensors) and keeps its own rows.  Equal shards make
    the mean of the ranks' mean losses and gradients the global token mean.
    The params and moments handed in are donated: the update is written
    into their gathered storage, as ``make_train_step(donate=True)``.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.prune import axis_group
    from repro_torch.dist.sharding import (_size, batch_pspecs, data_axes,
                                           local_shard, param_pspecs,
                                           placements)

    loss_fn = _loss_with_remat(model, remat)
    p_specs = param_pspecs(params, mesh)
    b_specs = batch_pspecs(example_batch, mesh)
    dp = data_axes(mesh)
    n = _size(mesh, dp)
    group = axis_group(mesh, dp).group if n > 1 else None

    def shard(tree):
        return map_tree(lambda x, s: DTensor.from_local(
            local_shard(x, s, mesh), mesh, placements(s, x.ndim, mesh),
            run_check=False), tree, p_specs)

    def step(params, opt_state: AdamWState, batch):
        p = map_tree(_full, params)
        state = AdamWState(step=opt_state.step, mu=map_tree(_full,
                                                           opt_state.mu),
                           nu=map_tree(_full, opt_state.nu))
        rows = map_tree(lambda x, s: local_shard(_full(x), s, mesh),
                        batch, b_specs)
        lr = lr_schedule(state.step)
        loss, grads = value_and_grad(loss_fn, p, rows)
        all_reduce_mean([loss] + leaves(grads), group, n)
        new_p, new_state = optimizer.update(grads, state, p, lr,
                                            inplace=True)
        return shard(new_p), AdamWState(
            step=new_state.step, mu=shard(new_state.mu),
            nu=shard(new_state.nu)), {"loss": loss, "lr": lr}

    return step
