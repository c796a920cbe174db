"""PartitionSpec derivation for the ("data", "model") production mesh (port
of ``repro/dist/sharding.py``).

Rules are *name-and-shape* driven: the param trees use a consistent
vocabulary (wq/wk/wv/up/gate are column-parallel, wo/down are row-parallel,
``table`` is the vocab-sharded embedding, 1-D scales/biases stay
replicated), so a path walk plus a divisibility check per dim lays out every
architecture in the registry.  Every rule is divisibility-aware: a dim the
assigned mesh axes do not divide falls back to replication (``P()``) —
whisper's 51 865-token vocab on a 16-way model axis is the canonical case.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` ("data", "model") or ("pod", "data", "model").  The spec
functions read only axis names and sizes, so they also take a
``MeshShape(axis_names, shape)``: a 16 × 16 layout is derived without 256
ranks.  A spec is a ``PartitionSpec`` — a tuple whose entries are ``None``,
an axis name or a tuple of names, ``P()`` meaning replicated — and
``shard_params`` turns it into DTensor placements (``Shard(d)`` on every
mesh dim named in dim d's entry, ``Replicate()`` elsewhere).

Kernels are stored (in, out), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# path names with row-parallel kernels (shard the INPUT dim — dim 0 of the
# (in, out) kernel); everything else 2-D defaults to column-parallel.
_ROW_PARALLEL = frozenset({"wo", "down"})
# 1-D / scalar leaves and these names are always replicated
_REPLICATED = frozenset({"scale", "bias", "b", "A_log", "dt_bias"})


class PartitionSpec(tuple):
    """``P("data", None)``: one entry per tensor dim (trailing dims may be
    left out); ``P()`` is fully replicated.  Equal to the plain tuple of its
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without ranks: what the spec
    functions read."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(axis_names(mesh), (int(s) for s in tuple(mesh.shape))))


def data_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis that is not the tensor-parallel 'model' axis.

    ("data", "model") → ("data",);  ("pod", "data", "model") → ("pod",
    "data") — the DP gradient all-reduce spans pods.
    """
    return tuple(a for a in axis_names(mesh) if a != "model")


def _size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def _entry(axes):
    """P entry for an axis group: bare name for one axis, tuple for many."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _tp(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def _path_names(path) -> list[str]:
    """String key names along a path of the port's trees: dict keys and
    dataclass field names, as JAX's keypaths name them."""
    return [str(k) for k in path]


def _spec(entries) -> P:
    """Normalize: all-None → P() (fully replicated), else P(*entries)."""
    if all(e is None for e in entries):
        return P()
    return P(*entries)


def map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *matching)`` over the array leaves of ``tree`` (nested
    dicts and dataclasses — the port's params, batches and caches);
    anything else (a cache's static ``window``) is kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name),
                                  *(getattr(r, f.name) for r in rest),
                                  path=path + (f.name,))
            for f in dataclasses.fields(tree) if f.init})
    if hasattr(tree, "shape"):
        return fn(path, tree, *rest)
    return tree


# ==========================================================================
# parameter layouts
# ==========================================================================
def param_pspecs(a_params: Any, mesh) -> Any:
    """Tensor-parallel (weights-resident) layout: Megatron row/column rules
    on the 'model' axis, everything else replicated."""
    tp = _tp(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        nn = [n for n in _path_names(path) if not n.isdigit()]
        name = nn[-1] if nn else ""
        if name in ("w", "b") and len(nn) >= 2:   # generic kernel/bias leaf
            name = nn[-2]                         # → the layer name (wo, up…)
        if name in _REPLICATED or len(shape) < 2:
            return P()
        if len(shape) == 2:
            if name == "table":                       # embedding (V, d)
                return P("model", None) if shape[0] % tp == 0 else P()
            if name in _ROW_PARALLEL:
                return P("model", None) if shape[0] % tp == 0 else P()
            # column-parallel default (wq/wk/wv/up/gate/lm_head/…)
            return P(None, "model") if shape[1] % tp == 0 else P()
        if len(shape) == 3:
            # stacked expert kernels (E, in, out) → expert-parallel on
            # 'model'; conv-style (k, in, out) falls through to column
            if shape[0] % tp == 0 and shape[0] >= tp:
                return P("model", None, None)
            if shape[-1] % tp == 0:
                return P(None, None, "model")
            return P()
        return P()

    return map_with_path(rule, a_params)


def fsdp_pspecs(a_params: Any, mesh) -> Any:
    """FSDP + TP layout: the TP layout of param_pspecs with each leaf
    additionally sharded over the data axes on its first divisible
    still-replicated dim (ZeRO-3-style fully-sharded residency)."""
    dp = data_axes(mesh)
    dps = _size(mesh, dp)
    tp_specs = param_pspecs(a_params, mesh)

    def add_data(path, leaf, spec):
        shape = tuple(leaf.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for dim, e in enumerate(entries):
            if e is None and shape[dim] % dps == 0:
                entries[dim] = _entry(dp)
                break
        return _spec(entries)

    return map_with_path(add_data, a_params, tp_specs)


# ==========================================================================
# activation / batch / cache layouts
# ==========================================================================
def batch_spec(mesh, batch: int, rank: int = 2) -> P:
    """Batch-dim-over-data spec for a rank-``rank`` activation tensor."""
    dp = data_axes(mesh)
    if not dp or batch % _size(mesh, dp) != 0:
        return P()
    return P(_entry(dp), *([None] * (rank - 1)))


def batch_pspecs(a_batch: Any, mesh) -> Any:
    """Input batch dict: leading (global-batch) dim over the data axes."""
    return map_with_path(
        lambda path, leaf: batch_spec(mesh, leaf.shape[0], len(leaf.shape))
        if len(leaf.shape) >= 1 else P(), a_batch)


def cache_pspecs(a_cache: Any, mesh, batch: int) -> Any:
    """KV/state cache layout: batch over data; heads over 'model' when the
    head count divides it, else sequence-sharded (flash-decoding fallback —
    GQA serving with kv_heads < model-axis size); scalars/pos replicated.

    Cache leaves are (B, L, H, Dh) KV tensors, (B, L, H) quant scales,
    (B, L, R) MLA latents, or small per-layer state — the dim-candidate
    order (2, then 1) shards the heads/feature dim first and the sequence
    dim second for all of them, keeping k/v and their scales on identical
    layouts.  The result mirrors the cache tree: each cache dataclass keeps
    its static fields and holds a spec in each tensor field.
    """
    tp = _tp(mesh)
    dp = data_axes(mesh)
    dps = _size(mesh, dp)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) < 2 or shape[0] != batch:
            return P()
        entries: list = [None] * len(shape)
        if dp and batch % dps == 0:
            entries[0] = _entry(dp)
        candidates = (2, 1) if len(shape) >= 3 else (1,)
        for dim in candidates:
            if dim > 0 and shape[dim] % tp == 0:
                entries[dim] = "model"
                break
        return _spec(entries)

    return map_with_path(rule, a_cache)


# ==========================================================================
# placement
# ==========================================================================
def placements(spec, ndim: int, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that dim d's entry names, ``Replicate()`` on the others.  A dim
    sharded over several axes takes them in mesh order (data-major), which
    is the order of JAX's tuple entries."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for dim, e in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} not in mesh order "
                             f"{names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a full tensor laid out by ``spec``: each dim
    sharded over an axis group is cut into its group's size, and the rank
    keeps the block at its row-major coordinate in the group.  A block
    smaller than ``x`` is copied, so it does not hold ``x``'s storage."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    out = x
    for dim, e in enumerate(spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n = math.prod(sizes[a] for a in axes) if axes else 1
        if n == 1:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        step = x.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out if out.shape == x.shape else out.clone()


def shard_params(params: Any, mesh, *, fsdp: bool = True) -> Any:
    """Place a (restored) param tree onto ``mesh`` per the derived layout,
    as DTensors.

    Each rank holds the whole tree (every rank restored the checkpoint, the
    multi-controller form of JAX's logical arrays), so each keeps its own
    blocks and nothing is sent (``src_data_rank=None``).  This is the
    elastic-scaling re-shard step: the mesh may differ from the one that
    wrote the checkpoint.
    """
    from torch.distributed.tensor import distribute_tensor

    specs = (fsdp_pspecs if fsdp else param_pspecs)(params, mesh)
    return map_with_path(
        lambda path, x, s: distribute_tensor(
            x, mesh, placements(s, x.ndim, mesh), src_data_rank=None),
        params, specs)
