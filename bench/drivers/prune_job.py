"""A Thanos prune job through the port's ``core.schedule.prune_model``.

Set-up draws the dense weights and the calibration ids from the seed and
starts the job.  The harness sees the job through two objects it hands to
``prune_model``: an adapter around the port's ``ModelAdapter`` that marks
each block's start (its first pass-1 call, after a sync: the previous
block's pass 2 has ended) and a journal that receives every solved layer
(its ``LayerReport`` and pruned kernel).  The first ``warm_blocks`` blocks
warm the job up (every solve shape captured); the window opens at the next
block's start and closes at the first block start after ``seconds``,
where the harness stops the job (or at the job's end, if it prunes every
block first).  Whole blocks fill the window.

After the window the program's state is freed and the reference
(``bench/reference``, float32) prunes the window's first block again: the
calibration forward from the ids through the program's pruned earlier
blocks, the block's Hessians from its dense weights, and Thanos n:m from
``thanos_nm``.  The numbers judged are the program's pruned kernels
against the reference's, and the n:m guarantee of every kernel the
reference reads (the earlier blocks' too).  With ``control`` the same
numbers of the control (the reference one precision below, in the
program's place) are judged against the same limits beside them.
"""
from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from bench.lib import weights as W
from bench.lib.common import judge, log
from bench.lib.flops import block_forward_flops
from bench.lib.port import model_config
from bench.lib.trace import Slice
from bench.lib.traffic import calibration_ids, sub_seed
from bench.reference import decoder_lm as R
from bench.reference import thanos_nm


class WindowClosed(Exception):
    """Raised at the first block start after the window's length."""


class Journal:
    """The journal ``prune_model`` writes each layer to: it keeps every
    report and the pruned kernels of the blocks in ``keep``."""

    completed = 0

    def __init__(self, keep: set):
        self.keep = keep
        self.reports = []
        self.kernels = {}

    def write(self, ordinal, rep, *, kernel=None, mask=None, faults=None):
        self.reports.append((rep.path, rep.seconds))
        if kernel is not None and rep.path[1] in self.keep:
            self.kernels[rep.path] = kernel


class Watch:
    """The port's adapter with each block's start marked."""

    def __init__(self, inner, on_block):
        self.inner = inner
        self.on_block = on_block
        self.seen = -1

    def num_blocks(self, params):
        return self.inner.num_blocks(params)

    def prepare(self, params, batch):
        return self.inner.prepare(params, batch)

    def block_linear_paths(self, params, i):
        return self.inner.block_linear_paths(params, i)

    def block_apply(self, params, i, carry, *, capture):
        if capture and i > self.seen:
            self.seen = i
            self.on_block(i, params)
        return self.inner.block_apply(params, i, carry, capture=capture)


def _k1_counts() -> collections.Counter:
    from repro_torch.kernels import hessian_accum

    return collections.Counter(hessian_accum.hessian_update_cuda.by_shape)


def run(ctx) -> dict:
    dev, mix, seed = ctx.device, ctx.mix, ctx.seed
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.schedule import prune_model
    from repro_torch.models.model_builder import ModelAdapter
    from repro_torch.models.transformer import TransformerLM

    cfg = model_config(ctx.conf)
    warm = int(mix["warm_blocks"])
    traced = warm + int(mix["trace"]["block"])
    dt = cfg.torch_dtype
    model = TransformerLM(cfg, device=dev)
    params = W.head_weights(torch, cfg, seed, dev, dt)
    params["blocks"] = {i: W.block_weights(torch, cfg, i, seed, dev, dt)
                        for i in range(cfg.num_layers)}
    ids = calibration_ids(mix, seed, cfg.vocab_size, dev, torch)
    plan = PruneConfig(method=mix["method"], pattern=mix["pattern"],
                       n=int(mix["n"]), m=int(mix["m"]),
                       block_size=int(mix["block_size"]))
    journal = Journal(keep=set(range(warm + 1)))
    starts: dict[int, float] = {}     # a block's start
    ends: dict[int, float] = {}       # a traced block's end, before export
    k1: dict[int, collections.Counter] = {}
    slc = Slice(torch) if ctx.trace else None
    state = {"deadline": None}

    def on_block(i: int, _params) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        if dev.type == "cuda":
            k1[i] = _k1_counts()
        if slc is not None:
            if slc.prof is not None:       # a slice ends with block i − 1
                ends[i - 1] = now
                slc.stop()
                if i == warm:              # the profiler's warm-up slice
                    slc.summary = None
                now = time.perf_counter()
            # the profiler's first start costs seconds: pay it on the
            # last warm-up block
            if i in (warm - 1, traced):
                slc.start()
        starts[i] = now
        if i == warm:
            state["deadline"] = now + ctx.seconds
        elif state["deadline"] is not None and now >= state["deadline"]:
            raise WindowClosed

    holder = [params]
    del params
    try:
        prune_model(holder.pop(), Watch(ModelAdapter(model), on_block),
                    [{"tokens": t} for t in ids], plan, keep_masks=False,
                    journal=journal)
    except WindowClosed:
        pass
    else:
        # every block pruned before the window's length: it closes at the
        # job's end, the last block's pass 2
        if dev.type == "cuda":
            torch.cuda.synchronize()
        starts[cfg.num_layers] = time.perf_counter()
        if slc is not None and slc.prof is not None:
            ends[cfg.num_layers - 1] = starts[cfg.num_layers]
            slc.stop()
        if dev.type == "cuda":
            k1[cfg.num_layers] = _k1_counts()
        log(f"the job ended {state['deadline'] - starts[cfg.num_layers]:.3f}"
            f" s before the window's length: the window is its last "
            f"{cfg.num_layers - warm} blocks")
    t_end = time.perf_counter()
    last = max(starts)
    blocks = list(range(warm, last))
    if len(blocks) < 1:
        raise RuntimeError("no whole block in the window")
    t_open, t_close = starts[warm], starts[last]
    mem_peak = int(torch.cuda.max_memory_allocated(0)) \
        if dev.type == "cuda" else 0
    prune_block_s = (t_close - t_open) / len(blocks)
    log(f"window {t_close - t_open:.3f} s: blocks {blocks[0]}..{blocks[-1]},"
        f" {prune_block_s:.3f} s a block; stopped {t_end - t_close:.3f} s "
        f"after the close")
    ctx.setup_lines.append(
        "block starts (s from the window's opening): " + ", ".join(
            f"{i}:{starts[i] - t_open:.3f}" for i in sorted(starts)))

    # spans from the blocks the profiler did not slow
    clean = [i for i in blocks if not (slc is not None and i == traced)]
    solve_s = sum(s for path, s in journal.reports
                  if path[1] in clean)
    clean_s = sum(starts[i + 1] - starts[i] for i in clean)
    k1_clean: collections.Counter = collections.Counter()
    if dev.type == "cuda":
        for i in clean:
            k1_clean.update(k1[i + 1] - k1[i])
    seqs, seq_len = sum(int(t.shape[0]) for t in ids), int(ids[0].shape[1])
    rec = {"clean_blocks": len(clean), "clean_s": clean_s, "solve_s": solve_s,
           "forward_flops": 2 * block_forward_flops(cfg, warm, seqs, seq_len),
           "batch_tokens": int(ids[0].numel()), "k1_clean": k1_clean,
           "trace": slc.summary if slc is not None else None,
           "slice_s": ((ends[traced] - starts[traced])
                       if slc is not None and traced in ends else None),
           "k1": ((k1[traced + 1] - k1[traced])
                  if dev.type == "cuda" and traced + 1 in k1 else None)}
    if slc is not None and rec["slice_s"] is None:
        raise RuntimeError("the traced block did not end inside the window")

    # --------------------------------------------------------- the check
    kernels = journal.kernels
    del journal, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the 2:4 guarantee of every kernel the reference reads: the warm-up
    # blocks' feed its calibration forward, and are otherwise unchecked
    warm_nm = max(_nm_violations(k.T, plan) for k in kernels.values())
    t_ref = time.perf_counter()
    readings = reference_check(cfg, seed, dev, ids, kernels, warm, plan,
                               experts=int(ctx.limits.get("experts_sample",
                                                          0)),
                               control=ctx.control)
    log(f"reference of block {warm}: {time.perf_counter() - t_ref:.1f} s")
    readings["nm_violations"] = max(readings["nm_violations"], warm_nm)
    compared = ctx.limits["compared"]
    checks = judge(readings, ctx.limits, compared)
    control = judge(readings, ctx.limits, compared, "control_") \
        if ctx.control else None
    return {"end_to_end": {"prune_block_s": prune_block_s}, "records": rec,
            "checks": checks, "control_checks": control,
            "readings": readings,
            "attempted": len(blocks), "failed": 0,
            "memory_peak_bytes": mem_peak, "t_open": t_open}


def _capacity(cfg, tokens: int) -> int:
    """The configuration's expert capacity for a forward of ``tokens``:
    ⌊tokens · k / E · capacity_factor⌋ rounded up to 8, at least 8 (0 for
    a model with no experts)."""
    if not cfg.num_experts:
        return 0
    c = int(tokens * cfg.num_experts_per_tok / cfg.num_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def reference_check(cfg, seed: int, dev, ids: list, kernels: dict, blk: int,
                    plan, *, experts: int = 0, control: bool = False) -> dict:
    """Prune block ``blk`` again in float32 and compare it with the
    program's: the calibration forward through the program's pruned
    blocks before it, the block's Hessians from its dense weights, and
    ``thanos_nm.prune`` of every linear — of an MoE block the attention
    linears and the three of ``experts`` experts drawn from the seed.
    With ``control`` the same done in float8 (``decoder_lm.fp8_cast`` on
    every product and on the inputs the Hessians sum) beside it, compared
    with the float32 result."""
    R.setup_fp32()
    dt = cfg.torch_dtype
    head = W.head_weights(torch, cfg, seed, dev, dt)
    table = head["embed"]["table"]
    blocks = []
    for i in range(blk):
        b = _f32(W.block_weights(torch, cfg, i, seed, dev, dt))
        for path, k in kernels.items():
            if path[1] == i:
                sub = b
                for key in path[2:-2] if isinstance(path[-1], int) \
                        else path[2:-1]:
                    sub = sub[key]
                if isinstance(path[-1], int):
                    sub["w"][path[-1]] = k.to(torch.float32)
                else:
                    sub["w"] = k.to(torch.float32)
        blocks.append(b)
    dense = _f32(W.block_weights(torch, cfg, blk, seed, dev, dt))
    mine = [p for p in kernels if p[1] == blk]
    if experts and any(isinstance(p[-1], int) for p in mine):
        rng = np.random.default_rng(sub_seed(seed, 5))
        pick = set(rng.choice(cfg.num_experts,
                              size=min(experts, cfg.num_experts),
                              replace=False).tolist())
        mine = [p for p in mine if not isinstance(p[-1], int)
                or p[-1] in pick]
    wanted = {_tape_key(p) for p in mine}
    casts = {"ref": R.identity}
    if control:
        casts["ctl"] = R.fp8_cast
    sums: dict = {name: {} for name in casts}
    moe_of = [bool(cfg.num_experts) and i >= cfg.num_dense_layers
              for i in range(blk + 1)]
    with torch.no_grad():
        for batch in ids:
            cap = _capacity(cfg, int(batch.numel()))
            for name, cast in casts.items():
                x = table[batch].to(torch.float32)
                for i, b in enumerate(blocks):
                    x = R.block(cfg, b, x, moe_layer=moe_of[i], cast=cast,
                                capacity=cap)
                tape: dict = {}
                R.block(cfg, dense, x, moe_layer=moe_of[blk], cast=cast,
                        capacity=cap, tape=tape)
                _accumulate(sums[name], tape, cast, wanted)
                del x, tape
    del blocks
    out = {}
    worst = {name: collections.defaultdict(lambda: float("-inf"))
             for name in ("prog", "ctl")}
    results = {}
    for path in sorted(mine, key=str):
        k = kernels[path]
        key = _tape_key(path)
        w_dense = _leaf(dense, path).T                    # (out, in)
        xtx, n = sums["ref"][key]
        h = thanos_nm.hessian(xtx, n)
        ref_w, ref_mask = _solve(sums["ref"], key, w_dense, plan)
        prog = k.to(torch.float32).T
        results[path] = _compare(prog, ref_w, ref_mask, plan, w_dense, h)
        for m, v in results[path].items():
            worst["prog"][m] = max(worst["prog"][m], v)
        if control:
            ctl_w, _ = _solve(sums["ctl"], key, w_dense, plan)
            for m, v in _compare(ctl_w, ref_w, ref_mask, plan, w_dense,
                                 h).items():
                worst["ctl"][m] = max(worst["ctl"][m], v)
        del h, ref_w, ref_mask, prog
    out.update(dict(worst["prog"]))
    out["linears"] = len(results)
    if control:
        out.update({"control_" + m: v for m, v in worst["ctl"].items()})
    return out


def _tape_key(path: tuple):
    """The reference tape's key of a kernel path ('blocks', i, ..., 'w'[, e])."""
    if isinstance(path[-1], int):
        return (path[2], path[3], path[-1])       # ('moe', 'gate', e)
    return (path[2], path[3])                     # ('attn', 'wq')


def _leaf(tree: dict, path: tuple):
    sub = tree
    for key in path[2:]:
        sub = sub[key]
    return sub


def _accumulate(sums: dict, tape: dict, cast, wanted: set) -> None:
    """Add each wanted taped input's XᵀX (float32) and row count, once a
    distinct tensor: q, k and v read one input, as do gate and up."""
    seen = {}
    for key, x in tape.items():
        if key not in wanted:
            continue
        if id(x) not in seen:
            xc = cast(x)
            seen[id(x)] = (xc.T @ xc, x.shape[0])
        xtx, n = seen[id(x)]
        if key in sums:
            sums[key][0].add_(xtx)
            sums[key][1] += n
        else:
            sums[key] = [xtx.clone(), n]


def _solve(sums: dict, key, w_dense, plan):
    if key not in sums:                      # an expert no token reached
        raise RuntimeError(f"no calibration rows reached {key}")
    xtx, n = sums[key]
    return thanos_nm.prune(w_dense, thanos_nm.hessian(xtx, n), n=plan.n,
                           m=plan.m, block=plan.block_size,
                           percdamp=plan.percdamp)


def _compare(w, ref_w, ref_mask, plan, w0, h) -> dict:
    """Groups of m inputs holding more than m − n nonzero weights (the n:m
    guarantee, exact); the share of positions whose pruned/kept state
    differs from the reference's, over the layer and over its first block
    of columns (before any update has carried a difference on);
    ‖W − W_ref‖ / ‖W_ref‖; and the layer's reconstruction loss
    tr(ΔW H ΔWᵀ), ΔW = W − W_dense, on the reference's H, over the
    reference's loss, less 1."""
    differ = (w == 0) != ref_mask
    return {"nm_violations": _nm_violations(w, plan),
            "mask_mismatch": float(differ.double().mean()),
            "mask_mismatch_first": float(
                differ[:, :plan.block_size].double().mean()),
            "weight_rel_err": float((w - ref_w).norm() / ref_w.norm()),
            "loss_excess": float(_loss(w, w0, h) / _loss(ref_w, w0, h) - 1.0)}


def _nm_violations(w, plan) -> int:
    """Groups of m inputs of ``w`` (out, in) with more than m − n nonzero
    weights."""
    c, b = w.shape
    nz = (w != 0).reshape(c, b // plan.m, plan.m).sum(-1)
    return int((nz > plan.m - plan.n).sum())


def _loss(w, w0, h) -> float:
    d = w - w0
    return float(((d @ h) * d).sum())
