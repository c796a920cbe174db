"""train_step factory — loss → grad → clip → AdamW (port of
``repro/train/step.py``).

The step is JAX's jitted step: ``make_train_step`` returns a ``TrainStep``
whose body — the schedule, the loss and its grads, the global norm, the
clip, the (masked) AdamW and the metrics — runs from one CUDA graph per
batch shape on the card (``util.graphs.graphed``: the first call with a
key runs eagerly, the second captures, later ones replay), and inline on
the CPU.  The step owns its graphs and their pool (``TrainStep.stats``,
``release``); its caller opens no ``graphs.scope()``.  ``__wrapped__``
runs the same body without a graph.

Inside the body the step counter is a 0-d int32 tensor on the params'
device: the host counter ``AdamWState.step`` is copied there before each
call (into the graph's static buffer before a replay) and advances on the
host beside it, so the schedule and the bias corrections follow every
step of a replayed graph.

Gradients come from ``torch.autograd.grad`` over fresh views of the
caller's leaves that the step itself marks as requiring grad, so the
caller's tree never becomes autograd leaves.

Remat: ``remat='block'`` runs each ``model.block`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: a block keeps
only its input carry and recomputes its forward in the backward pass (in
the capture too).  JAX's policy (``checkpoint_dots_with_no_batch_dims``)
also keeps the matmul outputs; the plain recompute gives the same numbers
and saves more memory for one more forward pass.

Donation: ``donate=True`` (the default) updates the parameters and the
moments in place, JAX's ``donate_argnums``: the graph is captured over
the caller's own tensors and returns them (a tree restored into new
storage is a new key).  With ``donate=False`` the step returns new
tensors and leaves the caller's trees untouched; on the card they are
copied into the graph and the new ones cloned out of it.

``make_sharded_train_step`` is the data-parallel step on a DeviceMesh:
params and both moments enter and leave as DTensors in ``param_pspecs``'
layout, each rank takes its rows of the batch (``batch_pspecs``), and the
gradients are averaged over the data axes with one ``all_reduce`` a dtype.
Inside, the step gathers the leaves (``full_tensor()``, no traffic for a
replicated leaf) and runs this module's own step math on them, rather
than propagating DTensor through the model: the models' custom kernels,
the remat checkpoint and the foreach AdamW then run on plain tensors, and
on one rank the step is bitwise ``make_train_step``.  Each rank runs two
graphed segments, its loss and grads, then the update; the collective
between them stays eager (gloo stages a CUDA collective through the host,
which a capture refuses).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.optim import AdamW, AdamWState, SparsityPreserving
from repro_torch.optim.adamw import global_norm
from repro_torch.util import graphs
from repro_torch.util.tree import leaves, map_tree, unflatten_like

# the arguments a donated step body updates in place
DONATED = ("params", "mu", "nu")


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


class TrainStep(graphs.Compiled):
    """A compiled train step (JAX: a jitted function and its cache):
    ``step(params, opt_state, batch) → (params, opt_state, metrics)`` runs
    ``run`` — whose graphed bodies key their graphs — inside the step's
    own ``graphs.Scope``; ``__wrapped__`` runs ``direct``, the same code
    with the bodies called directly (no graph).  ``stats()`` gives the
    scope's counters (graphs, replays, capture_s, pool_bytes);
    ``release()`` drops the graphs and returns their pool to the card, as
    dropping the step does."""


def advance(body: Callable, params, opt_state: AdamWState, batch):
    """One step of ``body(params, mu, nu, count, batch) → (params, mu, nu,
    metrics)`` with ``count``, the step counter, a 0-d int32 tensor on the
    params' device; the host counter advances beside it."""
    count = opt_state.step.to(leaves(params)[0].device, non_blocking=True)
    new_p, mu, nu, metrics = body(params, opt_state.mu, opt_state.nu, count,
                                  batch)
    return new_p, AdamWState(step=opt_state.step + 1, mu=mu, nu=nu), metrics


def make_train_step(
    model,
    optimizer: "AdamW | SparsityPreserving",
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    remat: str = "block",
    donate: bool = True,
) -> TrainStep:
    """→ step(params, opt_state, batch) → (params, opt_state, metrics) with
    metrics {"loss", "lr", "grad_norm"} (the norm of the unclipped grads)."""
    loss_fn = _loss_with_remat(model, remat)

    def step_body(params, mu, nu, count, batch):
        lr = lr_schedule(count)
        loss, grads = value_and_grad(loss_fn, params, batch)
        gnorm = global_norm(grads)
        new_params, new_opt = optimizer.update(
            grads, AdamWState(step=count, mu=mu, nu=nu), params, lr,
            inplace=donate)
        return new_params, new_opt.mu, new_opt.nu, {
            "loss": loss, "lr": lr, "grad_norm": gnorm}

    body = graphs.graphed(step_body, donate=DONATED if donate else ())
    return TrainStep(functools.partial(advance, body),
                     functools.partial(advance, step_body))


def _full(x):
    """A DTensor's whole value on this rank — its own storage, with no
    collective, when its local block is the whole tensor (replicated, or
    sharded only over size-1 mesh dims); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    local = x.to_local()
    return local if local.shape == x.shape else x.full_tensor()


def _split(tree) -> tuple:
    """(own, fresh): the whole values of ``tree``'s leaves on this rank,
    as two trees with None elsewhere — the leaves on their own storage
    (plain tensors, whole local blocks), which a graph binds in place, and
    those gathered afresh by ``full_tensor()`` at every call, which it
    copies."""
    from torch.distributed.tensor import DTensor

    def own(x):
        return not isinstance(x, DTensor) or x.to_local().shape == x.shape

    whole = map_tree(lambda x: (_full(x), own(x)), tree)
    return (map_tree(lambda w: w[0] if w[1] else None, whole),
            map_tree(lambda w: None if w[1] else w[0], whole))


def _merge(own, fresh):
    return map_tree(lambda a, b: b if a is None else a, own, fresh)


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


def make_sharded_train_step(model,
                            optimizer: "AdamW | SparsityPreserving",
                            lr_schedule, mesh, example_batch, params, *,
                            remat: str = "block") -> TrainStep:
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
    The rank's gradients go into a buffer the step keeps, shaped like the
    params, which both segments bind in place.
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
    grad_buf: list = []

    def shard(tree):
        return map_tree(lambda x, s: DTensor.from_local(
            local_shard(x, s, mesh), mesh, placements(s, x.ndim, mesh),
            run_check=False), tree, p_specs)

    def local_grads(own, fresh, rows, out):
        loss, grads = value_and_grad(loss_fn, _merge(own, fresh), rows)
        torch._foreach_copy_(leaves(out), leaves(grads))
        return loss

    def sharded_update(own_p, fresh_p, own_mu, fresh_mu, own_nu, fresh_nu,
                       grads, count):
        lr = lr_schedule(count)
        new_p, new = optimizer.update(
            grads, AdamWState(step=count, mu=_merge(own_mu, fresh_mu),
                              nu=_merge(own_nu, fresh_nu)),
            _merge(own_p, fresh_p), lr, inplace=True)
        return new_p, new.mu, new.nu, lr

    def run(grads_fn, update_fn, params, opt_state: AdamWState, batch):
        p, mu, nu = (_split(t) for t in (params, opt_state.mu, opt_state.nu))
        rows = map_tree(lambda x, s: local_shard(_full(x), s, mesh),
                        batch, b_specs)
        if not grad_buf:
            grad_buf.append(map_tree(torch.zeros_like, _merge(*p)))
        out = grad_buf[0]
        loss = grads_fn(*p, rows, out)
        all_reduce_mean([loss] + leaves(out), group, n)
        count = opt_state.step.to(leaves(out)[0].device, non_blocking=True)
        new_p, new_mu, new_nu, lr = update_fn(*p, *mu, *nu, out, count)
        return shard(new_p), AdamWState(
            step=opt_state.step + 1, mu=shard(new_mu),
            nu=shard(new_nu)), {"loss": loss, "lr": lr}

    grads_seg = graphs.graphed(local_grads, donate=("own", "out"))
    update_seg = graphs.graphed(sharded_update, donate=(
        "own_p", "own_mu", "own_nu", "grads"))
    return TrainStep(functools.partial(run, grads_seg, update_seg),
                     functools.partial(run, local_grads, sharded_update))
