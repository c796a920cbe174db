"""Perf ladders — hypothesis → change → rebuild → measure (port of
``repro/launch/perf.py``).

The same three cells and rungs as the JAX package, each rung a
``DecodeOptions`` change with its recorded hypothesis and napkin-math
prediction (kept verbatim: they were written for the 256-chip TPU mesh).
Here each rung is built by ``steps.make_decode_step`` and **run** on one
card at full width and the cell's batch (B = 128) and cache depth; the
model is cut in depth only, one depth per ladder so its rungs compare
(``LADDER_DEPTH``), and whisper's ``cache448`` rungs run again at full
depth.  A record holds JAX's keys minus the compiler's (``collectives``,
``memory``, ``compile_s``): the roofline terms at chips = 1 on the card's
peaks (at the run's depth), the bottleneck, ``step_s`` (the bound) and
``mfu``; beside them the measured step (median of ``RUNS`` after a
warm-up), the peak bytes, measured over bound, and the speedups against
the previous rung and the baseline, measured and predicted by the bound.

``tp`` rungs lay every weight whole on one card, as ``fsdp`` does: on one
card they change nothing, and are run all the same.  ``nm`` rungs pack
magnitude n:m masks through ``serve.compressed.compress_params`` (no
calibration: only the shapes matter) and serve every packed linear
through K2.  ``int8_cache_check`` holds an int8 rung against the same
model over a bf16 cache, both filled with the same random k/v.

    PYTHONPATH=src python -m repro_torch.launch.perf [--cell KEY]
"""
from __future__ import annotations

import argparse
import math
import os
import statistics

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.dist.sharding import MeshShape
from repro_torch.launch import costmodel as CM
from repro_torch.launch import steps as S
from repro_torch.launch.dryrun import model_flops, roofline, timed_runs
from repro_torch.launch.steps import DecodeOptions
from repro_torch.models import attention as A
from repro_torch.models.model_builder import build_model
from repro_torch.util.io import atomic_write_json

# ---------------------------------------------------------------------------
# The three hillclimb cells (as the JAX package selected them):
#   mistral-large decode_32k — most representative of the paper's technique
#     (weight-stream reduction is §4.8's entire point);
#   xlstm decode_32k        — the only collective-bound baseline on the TPU
#     mesh;
#   whisper decode_32k      — worst roofline fraction of the whole grid.
# Each rung: (tag, options, hypothesis, predicted effect on dominant term).
# ---------------------------------------------------------------------------
LADDERS = {
    "mistral-large-123b/decode_32k": [
        ("baseline", DecodeOptions(),
         "memory-bound: 1.5 TB bf16 KV cache dominates the 246 GB weight "
         "stream (cache:weights ≈ 6:1)", "—"),
        ("int8-kv", DecodeOptions(kv_dtype="int8"),
         "cache bytes halve with int8 KV + per-(slot,head) scales; weights "
         "untouched → memory term ≈ ×0.57 of baseline "
         "((0.5·1.5T+0.25T)/1.75T)", "memory −43%"),
        ("int8-kv+nm24", DecodeOptions(kv_dtype="int8", nm=(2, 4)),
         "paper §4.8: 2:4-compressed linears stream 0.625× of dense bf16 "
         "bytes (values 0.5 + int8 idx 0.125); on top of int8-kv the "
         "memory term drops another ~9%", "memory −9% on top"),
    ],
    "xlstm-1.3b/decode_32k": [
        ("baseline", DecodeOptions(),
         "collective-bound: FSDP weight sharding all-gathers every "
         "projection shard each token step across the data axis",
         "—"),
        ("tp-weights", DecodeOptions(weight_sharding="tp"),
         "2.6 GB of weights fit TP-16-resident (163 MB/chip) — switching "
         "decode to weight-stationary TP removes the per-step weight "
         "all-gathers entirely; collective term should collapse to the "
         "row-parallel output reductions", "collective −80%+"),
        ("tp+nm24", DecodeOptions(weight_sharding="tp", nm=(2, 4)),
         "with collectives gone the cell is memory-bound again; 2:4 "
         "weights cut the dominant weight stream by 0.625×",
         "memory −25%"),
        ("tp+nm24+bf16state",
         DecodeOptions(weight_sharding="tp", nm=(2, 4), kv_dtype="bf16"),
         "memory is actually dominated by the fp32 mLSTM matrix memory "
         "(B·H·hd²·L = 103 GB, 10× the weight stream) — store C/n in bf16 "
         "(update math stays fp32): state bytes halve",
         "memory −45%"),
    ],
    "whisper-medium/decode_32k": [
        ("baseline", DecodeOptions(),
         "worst cell of the grid (mfu 0.002): a 32k-slot self-attention "
         "cache for a decoder whose horizon is 448 tokens, plus cross-"
         "attention k/v re-projected from the 1500-frame source every "
         "step", "—"),
        ("cache448", DecodeOptions(cache_len=448),
         "whisper's decoder never exceeds dec_seq=448 — architecture-aware "
         "cache sizing cuts self-cache bytes 73× (32768→448 slots)",
         "cache bytes ÷73"),
        ("cache448+crosskv", DecodeOptions(cache_len=448, cross_cache=True),
         "precompute per-layer cross-attention k/v once per request: "
         "removes 2·B·1500·d·(2·Hkv·Dh)·L_dec MACs per step (the dominant "
         "remaining compute) in exchange for streaming the cached cross-KV",
         "compute −95%"),
        ("cache448+crosskv+int8",
         DecodeOptions(cache_len=448, cross_cache=True, kv_dtype="int8"),
         "remaining traffic is weights + cross-KV reads; int8 self-cache "
         "is small but free; the bigger lever left is batching",
         "memory −few%"),
    ],
}

# One depth a ladder, so that its rungs compare on one 80 GB card at
# B = 128 and the cell's cache depth (every width kept): mistral's bf16 KV
# is 17.2 GB a layer, and int8-kv dequantizes a layer's whole cache through
# two 16 GiB fp32 temporaries, so 2 of 88 layers (beside 2.8 GB of weights
# a layer and the untied head; int8-kv peaks near 68 GB); xlstm's fp32
# matrix memory is 2 GB an mLSTM block (30 of 48 blocks: 27 mLSTM, 3 sLSTM,
# ~2 GB temporaries a block); whisper's self-KV at 32 768 slots is 17.2 GB
# a decoder layer (3 of 24; the encoder, which a decode step never runs,
# keeps its 24).
LADDER_DEPTH = {"mistral-large-123b/decode_32k": 2,
                "xlstm-1.3b/decode_32k": 30,
                "whisper-medium/decode_32k": 3}
# rungs that also run at full depth (whisper's 448-slot cache: ~5.6 GB)
FULL_DEPTH_RUNGS = {"whisper-medium/decode_32k": (
    "cache448", "cache448+crosskv", "cache448+crosskv+int8")}
RUNS = 5
# rows of an int8 rung's filled-cache check (int8_cache_check)
INT8_GATE_ROWS = 8


def cut_depth(cfg, depth: int | None):
    """``cfg`` cut to ``depth`` blocks (decoder layers for encdec)."""
    if depth is None:
        return cfg
    if cfg.family == "encdec":
        return cfg.replace(decoder_layers=depth)
    return cfg.replace(num_layers=depth)


def _depth_of(cfg) -> int:
    return cfg.decoder_layers if cfg.family == "encdec" else cfg.num_layers


def measure(arch: str, cell_name: str, opts: DecodeOptions, *,
            device: str = "cuda", depth: int | None = None,
            reduced: bool = False, seed: int = 0, runs: int = RUNS,
            cell=None, keep: dict | None = None) -> dict:
    """One rung on one card (chips = 1): build the step, run it on
    random-init weights from ``seed``, and return JAX's record keys (minus
    the compiler's) beside the measurement.  ``keep``, when given, receives
    the step, its concrete arguments and the first step's logits, taken
    from the fresh cache (the caller's correctness gates: a recurrent
    state has moved on since, so a comparison starts from
    ``step.model.init_cache`` again).  ``cell`` replaces the named cell's
    shape (small CPU runs)."""
    cell = cell or SHAPES[cell_name]
    full = registry.get_config(arch, reduced=reduced)
    cfg = cut_depth(full, depth)
    model = build_model(cfg, device=device)
    mesh = MeshShape(("data", "model"), (1, 1))
    step, a_args = S.make_decode_step(model, mesh, cell, opts)
    run = timed_runs(step, seed, runs)
    first = run["first"].float().cpu()
    # the cost model sees the option-transformed config, params and cache
    cfg_eff = step.model.cfg
    ac = CM.step_cost(cfg_eff, cell, a_args[0], a_cache=a_args[1],
                      cross_cached=opts.cross_cache)
    mf = model_flops(cfg, S.abstract_params(model), cell)
    line = roofline(ac.flops, ac.hbm_bytes, mf["model_flops"], 1)
    ms = statistics.median(run["times"])
    cuts = [] if depth is None or depth == _depth_of(full) else [
        f"{'decoder layers' if cfg.family == 'encdec' else 'layers'} "
        f"{_depth_of(full)} → {depth}"]
    if keep is not None:
        keep.update(step=step, args=run["args"], logits=first)
    return {
        "terms": line["roofline"], "bottleneck": line["bottleneck"],
        "step_s": line["roofline_step_s"], "mfu": line["roofline_mfu"],
        "analytic": {"flops": ac.flops, "hbm_bytes": ac.hbm_bytes,
                     "weight_bytes": ac.weight_bytes, **ac.detail},
        "chips": 1, "depth": _depth_of(cfg), "cuts": cuts,
        "batch": cell.global_batch,
        "cache_len": opts.cache_len or cell.seq_len,
        "device": str(model.device),
        "card": (torch.cuda.get_device_name(0)
                 if model.device.type == "cuda" else "cpu"),
        "measured_ms": ms, "measured_ms_all": run["times"],
        "argument_bytes": CM._tree_bytes(run["args"]),
        "peak_bytes": run["peak"],
        "measured_over_bound": ms / 1e3 / line["roofline_step_s"],
        "finite": bool(torch.isfinite(run["last"].float()).all()),
        "note": ("weight_sharding 'tp' and 'fsdp' both hold every weight "
                 "whole on one card" if opts.weight_sharding == "tp"
                 else ""),
    }


def _fill_pair(c16, c8, fill, gen) -> None:
    """Row r of the bf16 cache ``c16`` gets random k/v in its lanes 0 …
    fill[r] − 1 (positions 0 … fill[r] − 1); the int8 cache ``c8`` gets the
    same draws through the decode write path's quantizer."""
    for r, n in enumerate(fill.tolist()):
        shape = (n,) + tuple(c16.k.shape[2:])
        for field in ("k", "v"):
            t = torch.randn(shape, generator=gen, device=c16.k.device,
                            dtype=torch.float32).to(c16.k.dtype)
            getattr(c16, field)[r, :n] = t
            q, scale = A._quantize_kv(t)
            getattr(c8, field)[r, :n] = q
            getattr(c8, field + "_scale")[r, :n] = scale
        ids = torch.arange(n, device=c16.pos_ids.device)
        c16.pos_ids[r, :n] = ids
        c8.pos_ids[r, :n] = ids


def int8_cache_check(step, args, *, rows: int = INT8_GATE_ROWS,
                     seed: int = 0) -> dict:
    """An int8-cache decode step against the same model over a bf16 cache,
    both filled with the same random k/v: row r of the first ``rows`` rows
    of ``args`` holds lanes 0 … p_r − 1 valid, p_r log-spaced from 1 to the
    cache's last lane, and decodes at p_r, so the step reads every lane it
    dequantizes (a fresh cache holds one).  → {"max_abs": max |Δ| of the
    logits, "content": max |Δ| of the bf16 logits from the filled cache
    against a fresh one — what a cache that reads back nothing would
    cost}."""
    m8 = step.model
    m16 = S._with_cfg(m8, m8.cfg.replace(kv_cache_dtype=""))
    depth = step.opts.cache_len or step.cell.seq_len
    c8, c16 = m8.init_cache(rows, depth), m16.init_cache(rows, depth)
    slots = min(c.k.shape[1] for c in c16.values())
    fill = torch.logspace(0, math.log10(slots - 1), rows).round().long()
    gen = torch.Generator(device=m8.device).manual_seed(seed)
    for j in c16:
        _fill_pair(c16[j], c8[j], fill, gen)
    params, _, tokens, _, *rest = args
    rest = [a[:rows] if torch.is_tensor(a) else
            {j: {k: v[:rows] for k, v in kv.items()} for j, kv in a.items()}
            for a in rest]
    pos = fill.to(device=m8.device, dtype=registry.TOKEN_DTYPE)
    with torch.no_grad():
        l8, _ = m8.decode_step(params, c8, tokens[:rows], pos, *rest)
        l16, _ = m16.decode_step(params, c16, tokens[:rows], pos, *rest)
        l0, _ = m16.decode_step(params, m16.init_cache(rows, depth),
                                tokens[:rows], pos, *rest)
    return {"max_abs": (l8.float() - l16.float()).abs().max().item(),
            "content": (l0.float() - l16.float()).abs().max().item()}


def run_ladder(key: str, *, device: str = "cuda", reduced: bool = False,
               depth: int | None = None, cell=None, runs: int = RUNS,
               on_rung=None) -> list:
    """Every rung of ``LADDERS[key]`` at the ladder's depth (``depth``
    overrides it; ``cell`` the cell's shape), then its
    ``FULL_DEPTH_RUNGS`` at full depth; each record
    gets its hypothesis, prediction and speedups within its depth series.
    ``on_rung(tag, opts, record, keep)`` is called after each rung, while
    its step and arguments are still alive."""
    arch, cell_name = key.split("/")
    depth = depth if depth is not None else (
        None if reduced else LADDER_DEPTH.get(key))
    series = [(tag, opts, hyp, pred, depth)
              for tag, opts, hyp, pred in LADDERS[key]]
    full_tags = () if reduced else FULL_DEPTH_RUNGS.get(key, ())
    series += [(f"{tag}@full", opts, hyp, pred, None)
               for tag, opts, hyp, pred in LADDERS[key] if tag in full_tags]
    records: list = []
    firsts: dict = {}
    for tag, opts, hyp, pred, d in series:
        keep: dict = {}
        rec = measure(arch, cell_name, opts, device=device, depth=d,
                      reduced=reduced, runs=runs, cell=cell, keep=keep)
        entry = {"tag": tag, "hypothesis": hyp, "prediction": pred, **rec}
        first = firsts.setdefault(rec["depth"], entry)
        prev = next((r for r in reversed(records)
                     if r["depth"] == rec["depth"]), None)
        if prev is not None:
            entry["speedup_vs_prev"] = prev["step_s"] / rec["step_s"]
            entry["speedup_vs_baseline"] = first["step_s"] / rec["step_s"]
            entry["measured_speedup_vs_prev"] = (prev["measured_ms"]
                                                 / rec["measured_ms"])
            entry["measured_speedup_vs_baseline"] = (first["measured_ms"]
                                                     / rec["measured_ms"])
        if on_rung is not None:
            on_rung(tag, opts, entry, keep)
        keep.clear()
        if rec["device"].startswith("cuda"):
            torch.cuda.empty_cache()
        records.append(entry)
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all")
    ap.add_argument("--out", default="experiments/torch_perf")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    keys = list(LADDERS) if args.cell == "all" else [args.cell]
    for key in keys:
        records = run_ladder(key, device=args.device)
        for rec in records:
            print(f"{key} [{rec['tag']}] depth {rec['depth']}: measured "
                  f"{rec['measured_ms']:.3f} ms, bound "
                  f"{rec['step_s'] * 1e3:.3f} ms ({rec['bottleneck']}, "
                  f"×{rec['measured_over_bound']:.2f}), peak "
                  f"{(rec['peak_bytes'] or 0) / 1e9:.2f} GB on {rec['card']}")
        path = os.path.join(args.out, key.replace("/", "_") + ".json")
        atomic_write_json(path, records)
        base, last = records[0], [r for r in records
                                  if r["depth"] == records[0]["depth"]][-1]
        print(f"== {key}: measured {base['measured_ms'] / last['measured_ms']:.2f}×"
              f", bound {base['step_s'] / last['step_s']:.2f}× total\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
