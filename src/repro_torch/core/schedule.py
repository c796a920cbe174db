"""Block-wise model pruning driver — the paper's Alg. 3 (port of
``repro/core/schedule.py`` for a bare ``PruneConfig``).

For each transformer block: pass 1 forwards the calibration carries through
it, capturing the input of every prunable linear and accumulating its
Hessian (K1 on the card); every linear is then pruned independently; pass 2
re-forwards through the pruned block to produce the next block's inputs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Protocol

import torch

from repro_torch.core.api import (PruneConfig, method_spec,
                                  prune_layer_guarded)
from repro_torch.core.hessian import HessianAccumulator

Tensor = torch.Tensor
Path = tuple[Any, ...]


def path_str(path: Path) -> str:
    """Canonical string form of a param path: elements joined with '/'."""
    return "/".join(str(k) for k in path)


def get_path(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree, path: Path, value):
    """Functionally replace a leaf of nested dicts; untouched subtrees are
    shared.  An integer element indexes the leading axis of a stacked
    tensor leaf (expert slice e of an (E, in, out) kernel as
    (..., 'w', e)); that leaf is copied, not written in place."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        new = dict(tree)
    else:
        new = tree.clone()
    new[head] = set_path(tree[head], rest, value)
    return new


def _write_layer(params, path: Path, value, owned: set):
    """``set_path`` for the prune loop: an expert slice is written in place
    into this run's own copy of its stack, made at the stack's first slice
    — one copy per stack, not one per slice (a full-width expert stack is
    hundreds of MB and has 128 slices)."""
    if not isinstance(path[-1], int):
        return set_path(params, path, value)
    base = path[:-1]
    if base not in owned:
        params = set_path(params, base, get_path(params, base).clone())
        owned.add(base)
    get_path(params, base)[path[-1]] = value
    return params


class BlockwiseAdapter(Protocol):
    """What a model must expose for Alg.-3 pruning."""

    def num_blocks(self, params) -> int: ...

    def prepare(self, params, batch) -> Any: ...

    def block_apply(self, params, i: int, carry, *, capture: bool
                    ) -> tuple[Any, dict[Path, Tensor]]: ...

    def block_linear_paths(self, params, i: int) -> list[Path]: ...


@dataclasses.dataclass
class LayerReport:
    path: Path
    sparsity: float
    obs_loss: float
    seconds: float
    tag: str = ""           # PruneConfig.tag()
    params: int = 0         # kernel parameter count
    damp_attempts: int = 0  # failed solve attempts before success/fallback
    percdamp_used: float = 0.0
    fallback: str = ""      # "magnitude" when on_singular fell back
    calib_skipped: int = 0  # non-finite calibration batches dropped


@dataclasses.dataclass
class PruneReport:
    layers: list[LayerReport]
    masks: dict[Path, Tensor]
    seconds: float
    cfg: PruneConfig | None = None

    def mean_sparsity(self) -> float:
        tot = sum(m.numel() for m in self.masks.values())
        ones = sum(float(m.sum()) for m in self.masks.values())
        return ones / max(tot, 1)


def prune_model(params, adapter: BlockwiseAdapter, batches: Iterable[Any],
                cfg: PruneConfig, *, on_singular: str = "escalate",
                max_escalations: int = 4,
                min_calib_samples: int = 1) -> tuple[Any, PruneReport]:
    """Run Alg. 3 over the whole model.  Returns (pruned params, report).

    ``on_singular`` / ``max_escalations`` are the numerical-failure policy
    of ``prune_layer_guarded``; a data-aware layer whose accumulator closed
    with fewer than ``min_calib_samples`` tokens raises
    ``InsufficientCalibration``.
    """
    t_start = time.perf_counter()
    carries = [adapter.prepare(params, b) for b in batches]
    data_aware = method_spec(cfg.method).data_aware
    reports: list[LayerReport] = []
    masks: dict[Path, Tensor] = {}
    owned: set[Path] = set()          # expert stacks copied by this run

    with torch.no_grad():
        for i in range(adapter.num_blocks(params)):
            # ---- pass 1: capture inputs, accumulate Hessians -------------
            accs: dict[Path, HessianAccumulator] = {}
            for carry in carries:
                _, caps = adapter.block_apply(params, i, carry, capture=True)
                for path, x in caps.items():
                    # MoE expert slices tape (activations, row validity):
                    # only routed capacity rows count as samples
                    valid = None
                    if isinstance(x, tuple):
                        x, valid = x
                    if path not in accs:
                        accs[path] = HessianAccumulator.init(x.shape[-1],
                                                             x.device)
                    accs[path].update(x, valid)

            # ---- prune every linear in the block --------------------------
            for path in adapter.block_linear_paths(params, i):
                t0 = time.perf_counter()
                kernel = get_path(params, path)          # (in, out)
                acc = accs.pop(path, None)
                h = None
                calib_skipped = 0
                if acc is not None:
                    h = acc.finalize(
                        min_count=min_calib_samples if data_aware else 0)
                    calib_skipped = int(float(acc.skipped))
                res, guard = prune_layer_guarded(     # paper layout (out, in)
                    kernel.T, h, cfg, on_singular=on_singular,
                    max_escalations=max_escalations, path=path_str(path))
                params = _write_layer(
                    params, path, res.weights.T.contiguous().to(kernel.dtype),
                    owned)
                masks[path] = res.mask.T.contiguous()       # (in, out)
                rep = LayerReport(
                    path=path, sparsity=float(res.mask.mean()),
                    obs_loss=float(res.loss),
                    seconds=time.perf_counter() - t0, tag=cfg.tag(),
                    params=kernel.numel(),
                    damp_attempts=guard.damp_attempts,
                    percdamp_used=guard.percdamp_used,
                    fallback=guard.fallback, calib_skipped=calib_skipped)
                reports.append(rep)

            # ---- pass 2: propagate through the pruned block ---------------
            carries = [adapter.block_apply(params, i, c, capture=False)[0]
                       for c in carries]

    return params, PruneReport(layers=reports, masks=masks,
                               seconds=time.perf_counter() - t_start, cfg=cfg)
