#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
non-zero without the final result line):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one ``nvcc`` per source, in parallel).
2. kernels — hold each kernel against its plain PyTorch version on the card:
             K1 (Hessian update) fp32/bf16 at b ∈ {2048, 5632}, a masked-rows
             batch and a NaN batch that must be skipped; K2 (n:m matmul) at
             the serving shapes for idx_bits 4/8, fp32/bf16, plus odd shapes.
3. prune   — the main path: Thanos 2:4 prunes tinyllama-1.1b at full width
             and depth from a seeded random init (K1 carries the Hessians).
4. serve   — compress the pruned linears and serve 4 requests through the
             continuous-batching engine, compressed-resident (K2 carries
             every pruned linear); then hold the kernel path's first-step
             logits against the same params decompressed and served dense.
5. times   — each kernel at each main-path shape: kernel, plain version and
             one library call, beside the bound the card's peaks give.

Kernel launch counts are zeroed just before phase 3 and read just after
phase 4's serve; the comparison and timing launches are not counted.  The
line before the last is the kernels JSON; the last line is the device
JSON.  Results are also written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_ms(fn, per_graph: int, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in one
    CUDA graph and replayed, so the host's launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def eager_ms(fn, iters: int) -> float:
    """Time of one eager ``fn`` call, host launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def errs(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return d, d / scale if scale else d


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"the port's sources are not beside this script ({src})")
    sys.path.insert(0, str(src))

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.masks import check_nm, nm_mask
    from repro_torch.core.sparsity import pack_nm
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, hessian_accum as K1, nm_spmm as K2
    from repro_torch.kernels import ref
    from repro_torch.launch.prune import prune_arch
    from repro_torch.models.model_builder import build_model
    from repro_torch.serve.compressed import (compress_params,
                                              compressed_bytes,
                                              decompress_params)
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    dev = resolve_device("cuda")          # also turns TF32 off
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict = {"gpu": gpu_line(), "device": torch.cuda.get_device_name(0)}
    t_all = time.perf_counter()

    # ---- 1. build ---------------------------------------------------------
    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"phase build: {len(_build.SOURCES)} kernels in {secs:.2f} s")
    results["build_seconds"] = secs

    # ---- 2. kernels vs plain ---------------------------------------------
    k1_err: dict = {}
    n1, worst1 = 0, (0.0, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for b in (2048, 5632):
            x = torch.randn((1024, b), generator=gen, device=dev).to(dtype)
            acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                     torch.zeros((), device=dev)]
            acc_p = [t.clone() for t in acc_k]
            for _ in range(2):                    # twice: the sum accumulates
                K1.hessian_update_cuda(x, None, *acc_k)
                K1.hessian_update_plain(x, None, *acc_p)
            torch.cuda.synchronize()
            e = errs(acc_k[0], acc_p[0])
            # fp32 sums in another order: rtol 1e-3 / atol 2e-2
            check(torch.allclose(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2),
                  f"K1 {dtype} b={b}: max abs err {e[0]:.3g}")
            check(float(acc_k[1]) == float(acc_p[1]) == 2048.0,
                  f"K1 {dtype} b={b}: count {float(acc_k[1])}")
            k1_err[(1024, b, str(dtype))] = e
            n1 += 1
            worst1 = max(worst1, e)
    for dtype in (torch.float32, torch.bfloat16):
        b = 2048
        x = torch.randn((1024, b), generator=gen, device=dev).to(dtype)
        valid = torch.rand((1024,), generator=gen, device=dev) < 0.5
        x[~valid] = torch.nan                     # garbage in invalid rows
        acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                 torch.zeros((), device=dev)]
        acc_p = [t.clone() for t in acc_k]
        K1.hessian_update_cuda(x, valid, *acc_k)
        K1.hessian_update_plain(x, valid, *acc_p)
        torch.cuda.synchronize()
        e = errs(acc_k[0], acc_p[0])
        check(torch.allclose(acc_k[0], acc_p[0], rtol=1e-3, atol=2e-2)
              and float(acc_k[1]) == float(valid.sum())
              and float(acc_k[2]) == 0.0,
              f"K1 masked rows {dtype}: err {e[0]:.3g}, count "
              f"{float(acc_k[1])} vs {int(valid.sum())}")
        x = torch.randn((1024, b), generator=gen, device=dev).to(dtype)
        x[7, 11] = torch.nan                      # a poisoned valid row
        acc_k = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
                 torch.zeros((), device=dev)]
        K1.hessian_update_cuda(x, None, *acc_k)
        torch.cuda.synchronize()
        check(float(acc_k[0].abs().max()) == 0.0 and float(acc_k[1]) == 0.0
              and float(acc_k[2]) == 1.0, f"K1 NaN batch {dtype} not skipped")
        n1 += 2
        worst1 = max(worst1, e)
    print(f"kernels: hessian_xtx (cuda) vs plain: {n1} checks ok, max abs err "
          f"{worst1[0]:.3g}, max rel err {worst1[1]:.3g} "
          f"(rtol 1e-3 / atol 2e-2; masked rows and NaN skip exact)")

    serve_shapes = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632)]
    packs: dict = {}
    k2_err: dict = {}
    n2, worst2 = 0, {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = [(c, b, B, 2, 4) for c, b in serve_shapes for B in (1, 4)]
    cases += [(37, 96, 3, 2, 4), (37, 96, 3, 5, 8)]
    for (c, b, B, n, m) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            w = (torch.randn((c, b), generator=gen, device=dev)
                 / math.sqrt(b)).to(dtype)
            xn = torch.rand((b,), generator=gen, device=dev) + 0.5
            mask = nm_mask(w.float(), xn, n, m)
            x = torch.randn((B, b), generator=gen, device=dev).to(dtype)
            for bits in (4, 8):
                pk = pack_nm(w, mask, n, m, idx_bits=bits)
                y_k = K2.nm_matmul_cuda(x, pk.values, pk.indices, n=n, m=m,
                                        b=b, idx_bits=bits)
                y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, n, m, b,
                                         bits)
                torch.cuda.synchronize()
                e = errs(y_k, y_p)
                # fp32: sum order only (1e-4); bf16: one output rounding
                # each side (rtol 2e-2 / atol 1e-2)
                tol = ((1e-4, 1e-4) if dtype == torch.float32
                       else (2e-2, 1e-2))
                check(y_k.shape == (B, c) and y_k.dtype == dtype and
                      torch.allclose(y_k.float(), y_p.float(), rtol=tol[0],
                                     atol=tol[1]),
                      f"K2 c={c} b={b} B={B} {n}:{m} {dtype} idx{bits}: "
                      f"max abs err {e[0]:.3g}")
                k2_err[(B, c, b, str(dtype), bits)] = e
                worst2[dtype] = max(worst2[dtype], e)
                n2 += 1
                if dtype == torch.bfloat16 and bits == 4 and (c, b) in \
                        serve_shapes:
                    packs[(c, b)] = (pk, w.masked_fill(mask > 0.5, 0))
    print(f"kernels: nm_matmul (cuda) vs plain: {n2} checks ok; max abs/rel "
          f"err fp32 {worst2[torch.float32][0]:.3g}/"
          f"{worst2[torch.float32][1]:.3g} (rtol 1e-4 / atol 1e-4), bf16 "
          f"{worst2[torch.bfloat16][0]:.3g}/{worst2[torch.bfloat16][1]:.3g} "
          f"(rtol 2e-2 / atol 1e-2)")

    # ---- 3. main path: prune ----------------------------------------------
    for fn in (K1.hessian_update_cuda, K2.nm_matmul_cuda):
        fn.launches = 0
        fn.by_shape.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pruned, report, out = prune_arch(
        "tinyllama-1.1b",
        PruneConfig("thanos", "nm", n=2, m=4, block_size=64),
        reduced=False, device="cuda", log=None)
    torch.cuda.synchronize()
    t_prune = time.perf_counter() - t0
    cfg = get_config("tinyllama-1.1b")
    check(all(check_nm(mk.T, 2, 4) for mk in report.masks.values()),
          "a pruned linear breaks 2:4")
    check(len(report.masks) == 7 * cfg.num_layers,
          f"{len(report.masks)} pruned linears")
    check(abs(out["mean_sparsity"] - 0.5) < 1e-9,
          f"sparsity {out['mean_sparsity']}")
    check(math.isfinite(out["dense_loss"]) and
          math.isfinite(out["pruned_loss"]), "non-finite held-out loss")
    check(all(r.fallback == "" for r in report.layers),
          "a layer fell back to magnitude pruning")
    print(f"phase prune: tinyllama-1.1b full width (d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, {cfg.num_layers} layers), thanos 2:4 B=64: "
          f"dense loss {out['dense_loss']:.4f}, pruned loss "
          f"{out['pruned_loss']:.4f}, sparsity {out['mean_sparsity']:.4f}, "
          f"prune {out['prune_seconds']:.1f} s (phase {t_prune:.1f} s), "
          f"K1 launches {K1.hessian_update_cuda.launches} (expect "
          f"{2 * 7 * cfg.num_layers})")
    results["prune"] = dict(out, phase_seconds=t_prune)

    # ---- 4. compress + serve ------------------------------------------
    comp = compress_params(pruned, report.masks, 2, 4)
    cb, db = compressed_bytes(comp)
    check(abs(cb / db - 0.625) < 1e-6, f"compressed ratio {cb / db}")
    model = build_model(cfg, device="cuda")
    engine = ServingEngine(model, comp, ServeConfig(batch_slots=4,
                                                    max_len=16 + 12 + 8))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=16) for _ in range(4)]
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid, p, max_new=12))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    k1_launches = K1.hessian_update_cuda.launches
    k2_launches = K2.nm_matmul_cuda.launches
    k1_main = dict(K1.hessian_update_cuda.by_shape)
    k2_main = dict(K2.nm_matmul_cuda.by_shape)
    ntok = sum(len(r.out) for r in done)
    check(len(done) == 4 and all(r.done and len(r.out) == 12 for r in done)
          and all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "served requests incomplete or out of vocabulary")
    check(k1_launches > 0 and k2_launches > 0,
          f"main path launches K1 {k1_launches} K2 {k2_launches}")
    st = engine.stats
    print(f"phase serve: compressed {cb / db:.4f} of dense bf16 bytes on "
          f"the pruned linears ({cb / 2**20:.1f} MiB vs "
          f"{db / 2**20:.1f} MiB); 4 requests, {ntok} tokens in "
          f"{t_serve:.2f} s ({ntok / t_serve:.1f} tok/s, "
          f"{st['decode_steps']} decode steps, {st['prefills']} prefills)"
          f"; K2 launches {k2_launches} (154 per decode step)")
    print(f"  req 0: {done[0].out}")

    # first-step logits: compressed kernel path vs decompressed dense
    dense = decompress_params(comp)
    tok = torch.tensor([[int(p[0])] for p in prompts], device=dev)
    with torch.no_grad():
        lg_k, _ = model.decode_step(comp, model.init_cache(4, 8), tok, 0)
        lg_d, _ = model.decode_step(dense, model.init_cache(4, 8), tok, 0)
    torch.cuda.synchronize()
    e = errs(lg_k, lg_d)
    agree = float((lg_k.argmax(-1) == lg_d.argmax(-1)).float().mean())
    # bf16 through 22 layers, summed in another order: max abs error
    # within 5e-2 of the logits' max magnitude
    check(bool(torch.isfinite(lg_k).all()) and e[1] <= 5e-2,
          f"compressed vs dense logits: max abs err {e[0]:.3g} "
          f"(rel {e[1]:.3g})")
    print(f"  first-step logits, K2 path vs decompressed dense: max abs "
          f"err {e[0]:.4g}, rel {e[1]:.4g} (limit 5e-2), argmax agree "
          f"{agree:.2f}")
    results["serve"] = {"ratio": cb / db, "tokens": ntok,
                        "seconds": t_serve, "tok_per_s": ntok / t_serve,
                        "stats": st, "logits_max_abs_err": e[0],
                        "logits_rel_err": e[1], "argmax_agree": agree,
                        "k1_launches": k1_launches,
                        "k2_launches": k2_launches}
    del pruned, comp, dense, engine, model
    torch.cuda.empty_cache()

    # ---- 5. times at the main-path shapes ---------------------------------
    entries = []
    for b in (2048, 5632):
        x = torch.randn((1024, b), generator=gen, device=dev).to(torch.bfloat16)
        x32 = x.float()
        acc = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
               torch.zeros((), device=dev)]
        ms = device_ms(lambda: K1.hessian_update_cuda(x, None, *acc), 10)
        eager = eager_ms(lambda: K1.hessian_update_cuda(x, None, *acc), 10)
        plain = device_ms(lambda: K1.hessian_update_plain(x, None, *acc), 10)
        lib = device_ms(lambda: torch.addmm(acc[0], x32.T, x32), 10)
        nbytes = x.numel() * 2 + 2 * b * b * 4
        ops = 2 * 1024 * b * b
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
        key = (1024, b, str(torch.bfloat16))
        entries.append({
            "name": "hessian_xtx", "shape": f"x (1024, {b}) bf16",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hessian_xtx.cu",
            "replaces": "src/repro/kernels/hessian_accum.py:66",
            "launches": k1_main.get(key, 0),
            "max_abs_err": k1_err[key][0], "ms": ms, "eager_ms": eager,
            "plain_ms": plain,
            "bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib})
    for (c, b) in serve_shapes:
        pk, wd = packs[(c, b)]
        per = (pk.values.numel() * 2 + pk.indices.numel())
        copies = max(1, math.ceil(128 * 2**20 / per))   # stream from HBM
        vals = [pk.values.clone() for _ in range(copies)]
        idxs = [pk.indices.clone() for _ in range(copies)]
        dens = [wd.clone() for _ in range(max(1, math.ceil(
            128 * 2**20 / (wd.numel() * 2))))]
        for B in (1, 4):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            ring = itertools.cycle(range(copies))
            dring = itertools.cycle(range(len(dens)))

            def kern():
                i = next(ring)
                K2.nm_matmul_cuda(x, vals[i], idxs[i], n=2, m=4, b=b,
                                  idx_bits=4)

            def plain():
                i = next(ring)
                ref.nm_matmul_ref(x, vals[i], idxs[i], 2, 4, b, 4)

            def lib():
                torch.matmul(x, dens[next(dring)].T)

            reps = copies * max(1, 64 // copies)
            ms = device_ms(kern, reps)
            eager = eager_ms(kern, 200)
            plain_ms = device_ms(plain, reps)
            lib_ms = device_ms(lib, len(dens) * max(1, 64 // len(dens)))
            nbytes = per + 2 * B * b + 2 * B * c
            ops = 2 * B * c * pk.values.shape[1]
            t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
            key = (B, c, b, str(torch.bfloat16), 4)
            entries.append({
                "name": "nm_matmul", "shape": f"B={B} W ({c}, {b}) 2:4 bf16",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/nm_spmm.cu",
                "replaces": "src/repro/kernels/nm_spmm.py:135",
                "launches": k2_main.get(key, 0),
                "max_abs_err": k2_err[key][0], "ms": ms, "eager_ms": eager,
                "plain_ms": plain_ms,
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": lib_ms})
        del vals, idxs, dens
    torch.cuda.synchronize()
    print(f"phase times on {results['gpu']} (name, power limit):")
    for e in entries:
        print(f"  {e['name']:12s} {e['shape']:28s} launches {e['launches']:6d}"
              f"  kernel {e['ms']:.4f} ms (eager {e['eager_ms']:.4f})  "
              f"plain {e['plain_ms']:.4f} ms  "
              f"library {e['library_ms']:.4f} ms  bound {e['bound_ms']:.4f} "
              f"ms ({e['bound_by']})")
    results["kernels"] = entries
    results["seconds"] = time.perf_counter() - t_all
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1,
                                                        default=str))
    print(f"total {results['seconds']:.1f} s")
    print(f"gpu: {results['gpu']}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
