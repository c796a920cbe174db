"""Row-parallel distributed pruning (port of ``repro/dist/prune.py``).

The layer-wise OBS problem factorizes over rows of W: the Hessian
``H = 2XXᵀ`` lives on the *input* dimension and is identical for every row,
so with H replicated each rank runs the full block-wise solve on its slice
of rows with **zero inter-row communication**.  The port's collectives are
an ``all_gather`` of the rows (every rank returns the whole
``PruneResult``, as JAX's ``out_specs`` give every device the logical
array) and a SUM ``all_reduce`` of the per-shard OBS losses.  This holds for
all four methods and all sparsity patterns.

Mask selection under sharding (as in the JAX package): n:m and structured
patterns are row-local, so the sharded mask equals the single-rank one at
any shard count while the OBS-updated weights agree to float tolerance (a
(c/k, b) matmul may round differently from a (c, b) one).  Unstructured
patterns have a global budget ⌊p·c·b⌋; each shard spends its own
⌊p·c_loc·b⌋, so the mask can differ at shard boundaries.  On a one-rank
mesh every method and pattern is bitwise ``prune_layer``.

Row counts the mesh does not divide fall back to coarser partitions
(all axes, data-only, model-only) and finally to replication — every rank
then solves all rows and no collective runs — rather than padding, since
zero rows would poison the unstructured budget.

PyTorch is multi-controller: each rank is a process and holds only its own
tensors, and a rank's coordinate in the row-partition group picks its
rows.  The groups are the mesh dims' process groups; a group over several
mesh dims is made once per mesh by every rank together.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

from repro_torch.core.api import PruneConfig, prune_layer
from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.plan import PrunePlan
from repro_torch.core.thanos import PruneResult
from repro_torch.dist.sharding import _size, axis_names, axis_sizes, data_axes

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group over a set of mesh axes, seen from this rank:
    ``index`` is the rank's row-major coordinate over the axes, ``size``
    their product, ``order[g]`` the coordinate of the group's rank g."""

    group: object
    index: int
    size: int
    order: tuple[int, ...]


_GROUPS: dict = {}       # (id(mesh), axes) → (mesh, AxisGroup)


def axis_group(mesh, axes: tuple[str, ...]) -> AxisGroup:
    """This rank's ``AxisGroup`` over ``axes`` of a DeviceMesh.  Size-1 axes
    drop out; one axis left is that mesh dim's own group, several form a
    group made on first use — every rank of the mesh must then call this
    together, as every rank runs the same prune schedule."""
    key = (id(mesh), tuple(axes))
    hit = _GROUPS.get(key)
    if hit is not None:
        return hit[1]
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    coord = dict(zip(names, mesh.get_coordinate()))
    live = [a for a in axes if sizes[a] > 1] or list(axes[:1])

    def flat(c: dict) -> int:
        i = 0
        for a in axes:
            i = i * sizes[a] + c[a]
        return i

    ranks = mesh.mesh                           # rank at each coordinate
    if len(live) == 1:
        group = mesh.get_group(live[0])
    else:
        rest = [a for a in names if a not in live]
        lists = []
        for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
            sel = dict(zip(rest, fixed))
            members = []
            for inner in itertools.product(*(range(sizes[a]) for a in live)):
                sel.update(zip(live, inner))
                members.append(int(ranks[tuple(sel[a] for a in names)]))
            lists.append(members)
        group, _ = dist.new_subgroups_by_enumeration(lists)
    where = {int(r): dict(zip(names, idx)) for idx, r in
             zip(itertools.product(*(range(sizes[a]) for a in names)),
                 ranks.reshape(-1).tolist())}
    n = dist.get_world_size(group)
    order = tuple(flat(where[dist.get_global_rank(group, g)])
                  for g in range(n))
    out = AxisGroup(group, flat(coord), _size(mesh, axes), order)
    _GROUPS[key] = (mesh, out)
    return out


def row_partition(c: int, mesh) -> tuple[str, ...]:
    """Largest mesh-axis group whose size divides the row count ``c``.

    Candidate groups (all axes, data-only, model-only) are tried in
    decreasing size — maximal parallelism wins — with () as the
    replicated fallback for row counts nothing divides.
    """
    dp = data_axes(mesh)
    tp = ("model",) if "model" in axis_names(mesh) else ()
    groups = sorted((g for g in (dp + tp, dp, tp) if g),
                    key=lambda g: -_size(mesh, g))
    for axes in groups:
        if c % _size(mesh, axes) == 0:
            return axes
    return ()


def _gather_rows(t: Tensor, ag: AxisGroup) -> Tensor:
    """The row blocks of every rank of ``ag``, concatenated in coordinate
    order."""
    parts = [torch.empty_like(t) for _ in range(ag.size)]
    dist.all_gather(parts, t.contiguous(), group=ag.group)
    blocks = [None] * ag.size
    for g, i in enumerate(ag.order):
        blocks[i] = parts[g]
    return torch.cat(blocks, dim=0)


def prune_layer_sharded(w: Tensor, h: "Tensor | None",
                        cfg: "PruneConfig | PrunePlan", mesh, *,
                        path: "tuple | str" = ()) -> PruneResult:
    """Row-parallel ``prune_layer``: rows of W split over ``mesh``, Hessian
    replicated, per-row block-wise solves, rows all-gathered, loss summed.

    ``cfg`` may be a ``PrunePlan``: the layer's ``path`` resolves through
    the plan's rules to its cell, and a skip resolution returns the layer
    untouched (zero mask, zero loss) without a collective.  Every rank of
    the mesh calls this with the same arguments and gets the whole result.
    """
    if isinstance(cfg, PrunePlan):
        if cfg.allocation is not None:
            raise ValueError(
                "plan carries an unexpanded allocation block; expand it "
                "first (plan.allocate_sparsity(collect_hessian_stats(...)))"
                " — a single layer cannot run a model-level allocation")
        cfg = cfg.cfg_for(path)
        if cfg is None:                     # skip rule — layer stays dense
            zero = torch.zeros((), dtype=torch.float32, device=w.device)
            return PruneResult(w, torch.zeros(w.shape, dtype=torch.float32,
                                              device=w.device), zero)
    if h is None and cfg.method != "magnitude":
        raise ValueError(f"{cfg.method} is data-aware: Hessian required")
    axes = row_partition(w.shape[0], mesh)
    if not axes:                            # replicated: every rank, all rows
        return prune_layer(w, h, cfg)
    ag = axis_group(mesh, axes)
    rows = w.shape[0] // ag.size
    res = prune_layer(w[ag.index * rows:(ag.index + 1) * rows], h, cfg)
    loss = res.loss.clone()
    dist.all_reduce(loss, group=ag.group)
    # the mask is 0/1: gathered as bytes, a quarter of its fp32 bytes
    mask = _gather_rows(res.mask.to(torch.bool), ag).to(res.mask.dtype)
    return PruneResult(_gather_rows(res.weights, ag), mask, loss)


def hessian_all_reduce(acc: HessianAccumulator, mesh,
                       axes: tuple[str, ...] = ("data",)
                       ) -> HessianAccumulator:
    """Cross-replica calibration reduction, so data-parallel calibration
    composes with the sharded prune: the summed Hessian comes back on every
    rank, which is what the row-parallel solve needs.

    A stacked accumulator — ``xtx`` (n, b, b), ``count`` and ``skipped``
    (n,), one partial per replica of ``axes`` — is summed over its leading
    axis; the leading size must equal the axes' size.  An unstacked one on
    a one-rank group passes through unchanged, as JAX's does.  Here JAX
    and the port part: a single-controller ``jax.Array`` is one logical,
    already global value, while a rank's unstacked accumulator is its own
    partial, so under a group of several ranks it is summed over the
    group (``HessianAccumulator.psum``, in place) and returned.
    """
    axes = tuple(a for a in axes if a in axis_names(mesh))
    n = _size(mesh, axes)
    stacked = acc.xtx.ndim == 3
    if stacked and acc.xtx.shape[0] != n:
        raise ValueError(
            f"leading replica axis {acc.xtx.shape[0]} != mesh axes size {n}")
    if stacked:
        return HessianAccumulator(acc.xtx.sum(0), acc.count.sum(0),
                                  acc.skipped.sum(0))
    if n == 1:
        return acc
    return acc.psum(axis_group(mesh, axes).group)

