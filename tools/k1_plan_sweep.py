#!/usr/bin/env python3
"""Time K1 (the fused Hessian update xtx += XᵀX) under every launch plan it
could take, on one NVIDIA GPU, and print the table ``_k1_plan`` is set from.

    python3 tools/k1_plan_sweep.py            # from the root of a checkout
    python3 tools/k1_plan_sweep.py --quick    # the path shapes at b ≤ 7 168

bf16 x.  At each shape: the wgmma kernel in each ring configuration
(``hessian_accum.VARIANTS``: tiles of 64 in 4 stages of 64 tokens, 3 stages
of 64 and 3 of 128; tiles of 128 in 3 stages of 64) at token splits CS ∈
``hessian_accum.SPLITS`` (each CTA keeping at least one stage; only where
the grid is short) and, from b = 2 560, unsplit with xtx prefetched into L2
at 4, 6 and 7 eighths of the stages; the mma.sync kernel's scalar-load
form (the plan for b % 8 ≠ 0); and one ``torch.addmm(xtx, xᵀ, x,
out_dtype=float32)`` call.  Beside them, the time the mma.sync kernel that
the wgmma one replaced had in ``chip_smoke``'s phase 5 before it
(``chip_smoke.K1_EARLIER_MS``, recorded, not measured here).  Every plan is first held against the plain
version (rtol 1e-3 / atol 2e-2, xtx exactly symmetric), then timed as
device time of CUDA-graph replays (``chip_smoke.device_ms``; the scan and
the product of each launch).  The plan ``_k1_plan`` chooses is marked with
``*``, the fastest with ``<``.

Shapes: x (1 024, b) at every b the card paths launch K1 at (the 19 rows
of ``chip_smoke``'s phase 5), the MoE path's capacity buffers (80, 2 048)
and (80, 768) with a row mask, and 2 048 and 16 384 tokens at b ∈ {1 024,
2 048, 5 632} (the calibration pipeline's 8 × 256 and 8 × 2 048 a batch).
The results also go to ``chiprun_out/k1_plan_sweep.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (HBM_BYTES_PER_S, K1_EARLIER_MS, PEAK_OPS,  # noqa: E402
                        device_ms, gpu_line)

PATH_B = [512, 1024, 1152, 1536, 2048, 2560, 3584, 4096, 5632, 6912, 7168,
          8192, 12288, 14336, 16384, 18432, 28672]
MASKED = [(80, 2048), (80, 768)]
LONG = [(t, b) for t in (2048, 16384) for b in (1024, 2048, 5632)]
PREFETCH, PREFETCH_MIN_B = (4, 6, 7), 2560   # xtx prefetch points, eighths


def shapes(quick: bool) -> list:
    bs = [b for b in PATH_B if not quick or b <= 7168]
    return ([(1024, b, False) for b in bs] + [(t, b, True) for t, b in MASKED]
            + [(t, b, False) for t, b in LONG])


def candidates(tokens: int, b: int, masked: bool) -> list:
    from repro_torch.kernels import hessian_accum as K1

    out = []
    for variant, BM in ((K1.K1_WG, 64), (K1.K1_WG, 128), (K1.K1_WG_TIGHT, 64),
                        (K1.K1_WG_DEEP, 64)):
        nt = -(-b // BM)
        tiles = nt * (nt + 1) // 2
        stages = -(-tokens // K1._BK[variant])
        smem = K1.k1_smem(variant, BM)
        for CS in K1.SPLITS:
            # a split only where each CTA keeps a stage and the grid is short
            if CS > stages or (CS > 1 and tiles >= 2 * K1._SMS):
                continue
            out.append((BM, CS, variant, smem, 0))
        if b >= PREFETCH_MIN_B:
            out += [(BM, 1, variant, smem, pf) for pf in PREFETCH]
    BM = 64 if b <= 2048 else 128
    out.append((BM, 1, K1.K1_SCALAR, K1.k1_smem(K1.K1_SCALAR, BM), 0))
    return out


def bound_ms(tokens: int, b: int, rows: int) -> float:
    """x and the mask read once, xtx read and written once; the products
    of the symmetric half (rows · b · (b + 1) operations)."""
    nbytes = tokens * b * 2 + 2 * b * b * 4 + (tokens if rows < tokens else 0)
    ops = rows * b * (b + 1)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"])


def sweep_shape(gen, dev, tokens: int, b: int, masked: bool) -> dict:
    import torch

    from repro_torch.kernels import hessian_accum as K1

    x = torch.randn((tokens, b), generator=gen, device=dev).to(torch.bfloat16)
    valid = None
    if masked:
        valid = torch.rand((tokens,), generator=gen, device=dev) < 0.6
        x[~valid] = torch.nan                     # garbage in masked rows
    rows = tokens if valid is None else int(valid.sum())
    acc_p = [torch.zeros((b, b), device=dev), torch.zeros((), device=dev),
             torch.zeros((), device=dev)]
    K1.hessian_update_plain(x, valid, *acc_p)
    acc = [torch.zeros_like(t) for t in acc_p]
    chosen = K1.k1_operands(x, valid, acc[0])[2]
    per_graph = 10 if b <= 4096 else (4 if b <= 8192 else 2)
    out = {"tokens": tokens, "b": b, "masked": masked, "plans": [],
           "chosen": list(chosen), "bound_ms": bound_ms(tokens, b, rows)}
    for plan in candidates(tokens, b, masked):
        for t in acc:
            t.zero_()
        K1._launch(x, valid, *acc, plan)
        torch.cuda.synchronize()
        if not (torch.allclose(acc[0], acc_p[0], rtol=1e-3, atol=2e-2)
                and torch.equal(acc[0], acc[0].T)
                and float(acc[1]) == float(acc_p[1])):
            raise SystemExit(f"K1 plan {plan} at ({tokens}, {b}) "
                             f"masked={masked} disagrees with the plain "
                             "version")
        ms = device_ms(lambda p=plan: K1._launch(x, valid, *acc, p),
                       per_graph)
        out["plans"].append({"plan": list(plan), "ms": ms})
    xm = x.float() if valid is None else torch.where(valid[:, None],
                                                     x.float(), 0.0)
    xb = xm.to(torch.bfloat16)
    out["addmm_bf16_ms"] = device_ms(
        lambda: torch.addmm(acc[0], xb.T, xb, out_dtype=torch.float32),
        per_graph)
    del x, acc, acc_p, xm, xb
    torch.cuda.empty_cache()
    return out


def report(r: dict) -> None:
    from repro_torch.kernels import hessian_accum as K1

    best = min(r["plans"], key=lambda p: p["ms"])
    old = [p for p in r["plans"] if p["plan"][2] == K1.K1_SCALAR][0]
    shape = f"x ({r['tokens']}, {r['b']}) bf16" + (" + row mask"
                                                   if r["masked"] else "")
    rec = K1_EARLIER_MS.get(shape)
    rec = "none" if rec is None else f"{rec:.4f} ms"
    chosen = [p for p in r["plans"] if p["plan"] == r["chosen"]]
    print(f"{shape}: bound {r['bound_ms']:.4f} ms, "
          f"bf16 addmm {r['addmm_bf16_ms']:.4f} ms, mma.sync scalar loads "
          f"{old['ms']:.4f} ms, the earlier mma.sync kernel recorded {rec}; "
          f"best {best['ms']:.4f} ms "
          f"(BM {best['plan'][0]}, CS {best['plan'][1]}, "
          f"{K1.VARIANTS[best['plan'][2]]}, pf {best['plan'][4]}); chosen "
          + (f"{chosen[0]['ms']:.4f} ms" if chosen else "not swept"))
    for p in sorted(r["plans"], key=lambda p: (p["plan"][2], p["plan"][0],
                                               p["plan"][1])):
        BM, CS, variant, _, pf = p["plan"]
        mark = ("*" if p["plan"] == r["chosen"] else " ") + \
            ("<" if p is best else " ")
        print(f"   {mark} {K1.VARIANTS[variant]:22s} BM {BM:3d} CS {CS:2d} "
              f"pf {pf}  {p['ms']:.4f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the path shapes at b ≤ 7 168 only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    _build.build_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gpu: {gpu_line()}")
    results = []
    for tokens, b, masked in shapes(args.quick):
        r = sweep_shape(gen, dev, tokens, b, masked)
        report(r)
        results.append(r)
        sys.stdout.flush()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k1_plan_sweep.json").write_text(json.dumps(
        {"gpu": gpu_line(), "results": results}, indent=1))


if __name__ == "__main__":
    main()
