"""Block-wise model pruning driver — the paper's Alg. 3 (port of
``repro/core/schedule.py``).

For each transformer block: pass 1 forwards the calibration carries through
it, capturing the input of every prunable linear and accumulating its
Hessian (K1 on the card); every linear is then pruned independently; pass 2
re-forwards through the pruned block to produce the next block's inputs.

Which cell prunes which layer is a ``PrunePlan`` (``core/plan.py``): each
param path resolves through the plan's ordered rules to a ``PruneConfig``
or to *skip* (the layer stays dense and no Hessian is accumulated for it).
A bare ``PruneConfig`` is the shim ``PrunePlan.uniform(cfg)``.

A ``core.jobs.PruneJournal`` makes the run resumable: every solved layer
is journaled, and journaled layers are loaded instead of solved while
every forward still replays (``core/jobs.py``).  An armed
``repro_torch.faults.FaultPlan`` fires the prune sites ``calib_batch``,
``hessian_accum`` (here), ``cholesky`` (``prune_layer_guarded``) and
``journal_write`` (the journal).

On a card each run is one ``util.graphs.scope()``: every layer solve
(``core/api.prune_layer`` → the method's graphed solver) and each block's
two passes run from CUDA graphs, captured at a key's second use, in one
pool released when the run returns (JAX jits the same functions).  A
block's pass 1 is captured over its carry before the block is pruned, its
pass 2 after (``_write_layer`` rebinds the block's params), and both are
dropped once the block is done, as JAX compiles per static block index.
K1's accumulation, the guard's host checks, the journal, the fault sites
and a mesh's collectives stay outside the graphs.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Callable, Iterable, Mapping, Protocol

import torch

from repro_torch.core.api import (PruneConfig, method_spec,
                                  prune_layer_guarded)
from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.plan import LayerStat, PrunePlan, as_plan, path_str
from repro_torch.faults import CalibrationError
from repro_torch.util import graphs

Tensor = torch.Tensor
Path = tuple[Any, ...]


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
    rule: int = -1          # index of the PrunePlan rule that claimed it
    tag: str = ""           # resolved PruneConfig.tag(), or "skip"
    params: int = 0         # kernel parameter count (rollup weighting)
    skipped: bool = False   # True = a skip rule / no rule matched: dense
    damp_attempts: int = 0  # failed solve attempts before success/fallback
    percdamp_used: float = 0.0
    fallback: str = ""      # "magnitude" when on_singular fell back
    calib_skipped: int = 0  # non-finite calibration batches dropped

    # journal-fragment serde: path element types (str against int expert
    # index) survive exactly, unlike the display-oriented PruneReport.to_dict
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["path"] = list(self.path)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "LayerReport":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown LayerReport keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        d = dict(d)
        d["path"] = tuple(d["path"])
        return cls(**d)


@dataclasses.dataclass
class PruneReport:
    layers: list[LayerReport]
    masks: dict[Path, Tensor]
    seconds: float
    plan: PrunePlan | None = None
    # the run's CUDA graphs (util.graphs.Scope.stats; empty on the CPU);
    # not part of the artifact
    graphs: dict = dataclasses.field(default_factory=dict)

    def mean_sparsity(self) -> float:
        tot = sum(m.numel() for m in self.masks.values())
        ones = sum(float(m.sum()) for m in self.masks.values())
        return ones / max(tot, 1)

    def rule_rollup(self) -> list[dict]:
        """Per-rule attribution: which rule claimed which layers, with a
        size-weighted sparsity and summed-loss rollup.  Rule -1 collects
        the layers no rule matched (skipped)."""
        by_rule: dict[int, list[LayerReport]] = {}
        for rep in self.layers:
            by_rule.setdefault(rep.rule, []).append(rep)
        out = []
        for idx in sorted(by_rule):
            reps = by_rule[idx]
            rule = (self.plan.rules[idx]
                    if self.plan is not None
                    and 0 <= idx < len(self.plan.rules) else None)
            size = sum(r.params for r in reps)
            out.append({
                "rule": idx,
                "match": rule.match if rule else None,
                "action": ("skip" if rule is None or rule.skip else "prune"),
                "tag": (rule.cfg.tag() if rule is not None
                        and rule.cfg is not None else "skip"),
                "layers": len(reps),
                "params": size,
                "mean_sparsity": (sum(r.params * r.sparsity for r in reps)
                                  / size if size else 0.0),
                "obs_loss": sum(r.obs_loss for r in reps),
                "seconds": sum(r.seconds for r in reps),
            })
        return out

    def to_dict(self) -> dict:
        """JSON-able artifact; the embedded plan makes the run reproducible
        (``PrunePlan.from_dict(report['plan'])``); masks stay out."""
        return {
            "plan": None if self.plan is None else self.plan.to_dict(),
            "seconds": self.seconds,
            "mean_sparsity": self.mean_sparsity(),
            "rules": self.rule_rollup(),
            "layers": [{
                "path": path_str(r.path),
                "rule": r.rule,
                "tag": r.tag,
                "skipped": r.skipped,
                "sparsity": r.sparsity,
                "obs_loss": r.obs_loss,
                "params": r.params,
                "seconds": r.seconds,
                "damp_attempts": r.damp_attempts,
                "percdamp_used": r.percdamp_used,
                "fallback": r.fallback,
                "calib_skipped": r.calib_skipped,
            } for r in self.layers],
        }

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        """Crash-safe artifact write (tmp + ``os.replace``)."""
        from repro_torch.util.io import atomic_write_text

        atomic_write_text(path, self.to_json() + "\n")


def _capture(adapter, params, i: int, carries: list, accs: dict,
             keep=None, faults=None) -> None:
    """Pass 1 of block i: forward every carry with the tape on and add each
    captured linear input into its accumulator (K1 on the card).  MoE
    expert slices tape (activations, row validity) pairs: only routed
    capacity rows count.  ``keep(path)`` False leaves a path out.  The
    ``calib_batch`` site fires once per (block, batch) forward and raises;
    ``hessian_accum`` fires once per accumulator update and turns the
    batch into NaNs, which the accumulator's non-finite guard drops."""
    block = graphs.graphed(functools.partial(adapter.block_apply, params, i,
                                             capture=True))
    for bi, carry in enumerate(carries):
        if faults is not None and \
                faults.fire("calib_batch", uid=i) is not None:
            raise CalibrationError(
                f"injected calibration failure (block {i}, batch {bi})",
                site="calib_batch")
        _, caps = block(carry)
        for path, x in caps.items():
            if keep is not None and path not in accs and not keep(path):
                continue
            valid = None
            if isinstance(x, tuple):
                x, valid = x
            if path not in accs:
                accs[path] = HessianAccumulator.init(x.shape[-1], x.device)
            if faults is not None and \
                    faults.fire("hessian_accum") is not None:
                x = torch.full_like(x, torch.nan)
            accs[path].update(x, valid)
    graphs.release(block)


def _forward(adapter, params, i: int, carries: list) -> list:
    """Pass 2 of block i: every carry through the (pruned) block."""
    block = graphs.graphed(functools.partial(adapter.block_apply, params, i,
                                             capture=False))
    out = [block(c)[0] for c in carries]
    graphs.release(block)
    return out


def prune_model(params, adapter: BlockwiseAdapter, batches: Iterable[Any],
                plan: "PrunePlan | PruneConfig", *, keep_masks: bool = True,
                progress: "Callable[[str], None] | None" = None,
                journal=None, faults=None, mesh=None,
                on_singular: str = "escalate", max_escalations: int = 4,
                min_calib_samples: int = 1) -> tuple[Any, PruneReport]:
    """Run Alg. 3 over the whole model.  Returns (pruned params, report).

    ``plan`` is a ``PrunePlan`` or a bare ``PruneConfig``.  A plan with an
    ``allocation`` block expands itself first (one dense capture pass,
    ``collect_hessian_stats``); the report embeds the expanded plan.
    ``on_singular`` / ``max_escalations`` are the run-level
    numerical-failure policy of ``prune_layer_guarded`` (a rule's own
    ``on_singular`` overrides it); a data-aware layer whose accumulator
    closed with fewer than ``min_calib_samples`` tokens raises
    ``InsufficientCalibration``.

    ``journal`` (a ``core.jobs.PruneJournal``; use ``core.jobs.PruneJob``)
    persists each layer as soon as it is solved, and loads the layers it
    already holds instead of solving them; the forwards replay, so
    accumulators and carries are bitwise those of an uninterrupted run.
    ``faults`` is an armed ``FaultPlan`` for the prune sites.

    ``keep_masks=False`` leaves the masks out of the report (a full-size
    run's fp32 masks are as large as its weights); ``progress`` gets one
    line a layer, JAX's text.  ``mesh`` (a DeviceMesh) routes every layer
    solve — escalation and the magnitude fallback included — through
    ``dist.prune.prune_layer_sharded``; every rank of the mesh calls
    ``prune_model`` with the same arguments, runs the same captures (K1) on
    the same batches, solves its rows of each layer and gets the whole
    pruned tree back.  The report's ``graphs`` holds the run's graph
    counters (``util.graphs.Scope.stats``).
    """
    plan = as_plan(plan)
    t_start = time.perf_counter()
    batches = list(batches)
    if plan.allocation is not None:
        plan = plan.allocate_sparsity(
            collect_hessian_stats(params, adapter, batches))
    carries = [adapter.prepare(params, b) for b in batches]
    solver = None
    if mesh is not None:
        from repro_torch.dist.prune import prune_layer_sharded

        def solver(w, h, cfg):     # row-parallel per-layer solve
            return prune_layer_sharded(w, h, cfg, mesh)

    reports: list[LayerReport] = []
    masks: dict[Path, Tensor] = {}
    owned: set[Path] = set()          # expert stacks copied by this run

    # Hessian accumulators persist ACROSS blocks: a weight-shared layer
    # (zamba2's shared attention and MLP sets) runs at several block
    # indices and is pruned once, at its last site, with the statistics of
    # every site.  An entry goes when its layer is pruned or skipped.
    accs: dict[Path, HessianAccumulator] = {}
    ordinal = 0                  # global sequential layer index (journal key)
    with torch.no_grad(), graphs.scope() as sc:
        for i in range(adapter.num_blocks(params)):
            # ---- pass 1: capture inputs, accumulate Hessians -------------
            # replays for journaled blocks too (see ``journal`` above)
            _capture(adapter, params, i, carries, accs,
                     keep=lambda path: plan.cfg_for(path) is not None,
                     faults=faults)

            # ---- prune every linear in the block --------------------------
            for path in adapter.block_linear_paths(params, i):
                if journal is not None and ordinal < journal.completed:
                    rec = journal.load(ordinal)
                    if tuple(rec.report.path) != tuple(path):
                        raise ValueError(
                            f"journal layer {ordinal} is "
                            f"{path_str(rec.report.path)!r}, expected "
                            f"{path_str(path)!r} — job dir belongs to a "
                            "different model/plan")
                    if not rec.report.skipped:
                        dev = get_path(params, path).device
                        params = _write_layer(params, path,
                                              rec.kernel.to(dev), owned)
                        if keep_masks and rec.mask is not None:
                            masks[path] = rec.mask.to(dev)
                    accs.pop(path, None)
                    reports.append(rec.report)
                    ordinal += 1
                    if progress:
                        progress(f"block {i} {path_str(path)}: journaled "
                                 f"(layer {ordinal - 1})")
                    continue
                t0 = time.perf_counter()
                kernel = get_path(params, path)          # (in, out)
                rule_idx, cfg = plan.resolve(path)
                acc = accs.pop(path, None)
                if cfg is None:                          # dense: skip
                    rep = LayerReport(
                        path=path, sparsity=0.0, obs_loss=0.0,
                        seconds=time.perf_counter() - t0, rule=rule_idx,
                        tag="skip", params=kernel.numel(), skipped=True)
                    if journal is not None:
                        journal.write(ordinal, rep, faults=faults)
                    reports.append(rep)
                    ordinal += 1
                    if progress:
                        progress(f"block {i} {path_str(path)}: skipped "
                                 f"(rule {rule_idx})")
                    continue
                h = None
                calib_skipped = 0
                if acc is not None:
                    h = acc.finalize(
                        min_count=(min_calib_samples
                                   if method_spec(cfg.method).data_aware
                                   else 0))
                    calib_skipped = int(float(acc.skipped))
                pol = (plan.rules[rule_idx].on_singular
                       if rule_idx >= 0 else "") or on_singular
                res, guard = prune_layer_guarded(     # paper layout (out, in)
                    kernel.T, h, cfg, on_singular=pol,
                    max_escalations=max_escalations, solver=solver,
                    faults=faults, path=path_str(path))
                new_kernel = res.weights.T.contiguous().to(kernel.dtype)
                params = _write_layer(params, path, new_kernel, owned)
                mask_t = res.mask.T.contiguous()            # (in, out)
                if keep_masks:
                    masks[path] = mask_t
                rep = LayerReport(
                    path=path, sparsity=float(res.mask.mean()),
                    obs_loss=float(res.loss),
                    seconds=time.perf_counter() - t0, rule=rule_idx,
                    tag=cfg.tag(), params=kernel.numel(),
                    damp_attempts=guard.damp_attempts,
                    percdamp_used=guard.percdamp_used,
                    fallback=guard.fallback, calib_skipped=calib_skipped)
                if journal is not None:
                    journal.write(ordinal, rep, kernel=new_kernel,
                                  mask=mask_t, faults=faults)
                reports.append(rep)
                ordinal += 1
                if progress:
                    progress(f"block {i} {path_str(path)}: "
                             f"sparsity={rep.sparsity:.3f} "
                             f"loss={rep.obs_loss:.3e}")

            # ---- pass 2: propagate through the pruned block ---------------
            carries = _forward(adapter, params, i, carries)

    return params, PruneReport(layers=reports, masks=masks,
                               seconds=time.perf_counter() - t_start,
                               plan=plan, graphs=sc.stats())


def collect_hessian_stats(params, adapter: BlockwiseAdapter,
                          batches: Iterable[Any]) -> dict[str, LayerStat]:
    """One dense calibration pass → {path_str: LayerStat(size, trace)}.

    Alg. 3's pass 1 (capture + Hessian accumulation, K1 on the card) over
    the unpruned model, each layer's Hessian reduced to its mean diagonal
    tr(H)/b — the saliency proxy ``PrunePlan.allocate_sparsity`` reads.
    No pruning, no weight change; one forward per block and batch, from
    CUDA graphs on a card (``prune_model``'s).
    """
    carries = [adapter.prepare(params, b) for b in batches]
    stats: dict[str, LayerStat] = {}
    with torch.no_grad(), graphs.scope():
        for i in range(adapter.num_blocks(params)):
            accs: dict[Path, HessianAccumulator] = {}
            _capture(adapter, params, i, carries, accs)
            for path in adapter.block_linear_paths(params, i):
                if path not in accs:
                    continue
                h = accs.pop(path).finalize()
                stats[path_str(path)] = LayerStat(
                    size=get_path(params, path).numel(),
                    trace=float(torch.trace(h)) / h.shape[0])
            carries = _forward(adapter, params, i, carries)
    return stats
