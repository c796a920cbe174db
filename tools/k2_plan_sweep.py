#!/usr/bin/env python3
"""Time K2 (the n:m compressed matmul) under every launch plan it could take,
on one NVIDIA GPU, and print the crossover that sets ``_ROWS_MIN_B``.

    python3 tools/k2_plan_sweep.py          # from the root of a checkout
    python3 tools/k2_plan_sweep.py --part rows

bf16 2:4 with 4-bit indices; device times of CUDA-graph replays, the
weights rotated through copies so that every launch streams them from HBM;
every plan first held against the plain version (bf16 rtol 2e-2 / atol
1e-2).  The plan ``_k2_plan`` chooses is marked with ``*``.

Part ``path``: each (c, b) that K2 runs on the two serving paths
(tinyllama-1.1b and qwen3-moe-30b-a3b's attention) at B ∈ {1, 4}: the
8-row tensor-core path (mode 2) at every cluster split CS ∈ {1, 2, 4, 8}
that fits, the warp-per-row kernel (mode 1) and ``torch.matmul`` on the
dense weight.

Part ``rows``: the perf ladders' shapes (mistral-large-123b, xlstm-1.3b)
and whisper-medium's at B ∈ {8, 16, 32, 64, 128} (whisper also at its
encoder's 6 000), and the wide rows (deepseek-v3, mistral, internvl) at
B = 4: the 8-row path under its own plan, the many-row path (mode 3) at
every tile BM × BN ∈ {128, 256} × {64, 128} and split CS, and
``torch.matmul``.  Per shape the least B from which the many-row path's
best plan stays faster than the 8-row path; the largest of these over the
ladder and whisper shapes is the threshold.

Part ``decode``: every (c, b) of PERF.md's K2 table at B ∈ {1, 4, 8, 16,
32, 63}: the 8-row path (mode 2) under its plan, the decode path (mode 4)
at every split CS ∈ {1, 2, 4, 8} and ring depth (2, 4, 8 stages and the
deepest that fits, each cut to the CTA's own stages) of its 64-row tiles,
``torch.matmul``, and the many-row path (mode 3) under its plan.  At
B = 64 the decode path's best against mode 3's plan: the crossover that
sets ``_ROWS_MIN_B``.  Every timing also goes to
``chiprun_out/k2_decode_sweep.json``, from which ``tools/k2_dec_rule.py
--from`` makes the digest that the plan's decode rule is fitted to.

    python3 tools/k2_plan_sweep.py --part decode [--shapes c,b ...]
"""
from __future__ import annotations

import argparse
import itertools
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import device_ms, gpu_line  # noqa: E402

PATH_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
               (4096, 2048), (512, 2048), (2048, 4096)]
LADDER_SHAPES = [(12288, 12288), (1024, 12288), (28672, 12288),
                 (12288, 28672), (8192, 2048), (4096, 4096), (4, 4096),
                 (2048, 4096), (2048, 2048)]
WHISPER_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096)]
WIDE_SHAPES = [(7168, 16384), (7168, 18432), (12288, 28672), (8192, 28672),
               (3584, 14336)]
ROW_BATCHES = (8, 16, 32, 64, 128)
WHISPER_ROWS = 6000
# PERF.md's K2 table: the path shapes above and every other served family's
TABLE_SHAPES = PATH_SHAPES + [
    (1536, 7168), (24576, 1536), (576, 7168), (7168, 16384), (18432, 7168),
    (7168, 18432), (1024, 1152), (256, 1152), (6912, 1152), (1152, 1024),
    (1152, 6912), (14704, 3584), (3584, 7168), (3584, 3584), (14336, 3584),
    (3584, 14336), (8192, 2048), (4096, 4096), (4, 4096), (1024, 1024),
    (4096, 1024), (1024, 4096), (2560, 2560), (640, 2560), (6912, 2560),
    (2560, 6912), (12288, 12288), (1024, 12288), (28672, 12288),
    (12288, 28672), (8192, 8192), (1024, 8192), (28672, 8192), (8192, 28672)]
DEC_BATCHES = (1, 4, 8, 16, 32, 63)
DEC_DEPTHS = (2, 4, 8)


class Operands:
    """One packed weight and its rotated copies (so that every launch
    streams the weight from HBM), and the dense weight's copies."""

    def __init__(self, gen, dev, c: int, b: int):
        import torch

        from repro_torch.core.masks import nm_mask
        from repro_torch.core.sparsity import pack_nm

        w = (torch.randn((c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(torch.bfloat16)
        mask = nm_mask(w.float(), torch.ones((b,), device=dev), 2, 4)
        self.pk = pack_nm(w, mask, 2, 4, idx_bits=4)
        wd = w.masked_fill(mask > 0.5, 0)
        per = self.pk.values.numel() * 2 + self.pk.indices.numel()
        n = max(1, math.ceil(128 * 2**20 / per))
        self.vals = [self.pk.values.clone() for _ in range(n)]
        self.idxs = [self.pk.indices.clone() for _ in range(n)]
        self.dens = [wd.clone() for _ in range(max(1, math.ceil(
            128 * 2**20 / (wd.numel() * 2))))]
        self.ring = itertools.cycle(range(n))
        self.dring = itertools.cycle(range(len(self.dens)))
        self.c, self.b = c, b
        self.L, self.stride = self.pk.values.shape[1], self.pk.indices.shape[1]

    def reps(self, B: int, dense: bool = False) -> int:
        n = len(self.dens if dense else self.vals)
        return min(n * max(1, 64 // n), 8 if B > 8 else 64)

    def time_plan(self, x, plan) -> float:
        """Device ms of one launch under ``plan``, after holding it against
        the plain version."""
        import torch

        from repro_torch.kernels import nm_spmm as K2

        pk, b = self.pk, self.b
        y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4, plan)
        y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
        torch.cuda.synchronize()
        if not torch.allclose(y_k.float(), y_p.float(), rtol=2e-2,
                              atol=1e-2):
            raise SystemExit(f"K2 plan {plan} at ({self.c}, {b}) "
                             f"B={x.shape[0]} disagrees with the plain "
                             "version")

        def kern():
            i = next(self.ring)
            K2._launch_k2(x, self.vals[i], self.idxs[i], 2, 4, b, 4, plan)

        return device_ms(kern, self.reps(x.shape[0]))

    def time_library(self, x) -> float:
        import torch

        return device_ms(lambda: torch.matmul(x, self.dens[next(
            self.dring)].T), self.reps(x.shape[0], dense=True))


def path_part(gen, dev) -> None:
    """Every 8-row plan and the warp-per-row kernel at the path shapes."""
    import torch

    from repro_torch.kernels import nm_spmm as K2

    for c, b in PATH_SHAPES:
        ops = Operands(gen, dev, c, b)
        for B in (1, 4):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            chosen = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4)
            plans = [(1, 1, 0, 8, 8)]
            for CS in (1, 2, 4, 8):
                if b % (32 * CS) or (ops.stride // CS) % 16:
                    continue
                smem = K2._k2_smem(b, ops.L, ops.stride, B, CS)
                if smem + 64 <= K2._SMEM_LIMIT:
                    plans.append((2, CS, smem, 8, 8))
            res = {p: ops.time_plan(x, p) for p in plans}
            lib = ops.time_library(x)
            best = min(res, key=res.get)
            print(f"({c}, {b}) B={B}: library {lib:.4f} ms; " + "; ".join(
                f"{'*' if p == chosen else ''}mode {p[0]} CS {p[1]} "
                f"{t:.4f}" for p, t in res.items())
                + f"; best mode {best[0]} CS {best[1]}", flush=True)
        del ops


def rows_plans(c: int, b: int, B: int) -> list:
    """Every many-row plan: tiles BM × BN ∈ {128, 256} × {64, 128} (BN =
    128 only past 64 rows) whose ring holds 3 stages, splits CS with ≥ one
    32-column step a CTA (256-row blocks unsplit)."""
    from repro_torch.kernels import nm_spmm as K2

    return [(3, CS, K2._k2_rows_smem(BM, BN, 4), BM, BN)
            for BM, BN in ((128, 128), (128, 64), (256, 128), (256, 64))
            for CS in (1, 2, 4, 8)
            if b // 32 >= CS and (BN == 64 or B > 64)
            and K2._k2_rows_nst(BM, BN, 4) >= 3 and (BM == 128 or CS == 1)]


def rows_part(gen, dev) -> None:
    """The 8-row path against every many-row plan, by B; the crossover."""
    import torch

    from repro_torch.kernels import nm_spmm as K2

    cross = {}
    cases = [(s, ROW_BATCHES) for s in LADDER_SHAPES] + \
        [(s, ROW_BATCHES + (WHISPER_ROWS,)) for s in WHISPER_SHAPES] + \
        [(s, (1, 4)) for s in WIDE_SHAPES]
    for (c, b), batches in cases:
        ops = Operands(gen, dev, c, b)
        wins = {}
        for B in batches:
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            chosen = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4)
            tc8 = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4,
                              False)             # x unaligned: mode 2
            t8 = ops.time_plan(x, tc8)
            res = {p: ops.time_plan(x, p) for p in rows_plans(c, b, B)}
            lib = ops.time_library(x)
            best = min(res, key=res.get)
            wins[B] = res[best] < t8
            top = sorted(res, key=res.get)[:6]
            print(f"({c}, {b}) B={B}: library {lib:.4f} ms; "
                  f"{'*' if chosen == tc8 else ''}8-row CS {tc8[1]} "
                  f"{t8:.4f}; many-row best "
                  + ", ".join(f"{'*' if p == chosen else ''}{p[3]}×{p[4]} "
                              f"CS {p[1]} {res[p]:.4f}" for p in top)
                  + (f"; chosen {chosen[3]}×{chosen[4]} CS {chosen[1]} "
                     f"{res[chosen]:.4f} ({res[chosen] / res[best]:.2f}× "
                     "the best)" if chosen in res else ""), flush=True)
        if len(batches) > 2:
            from_b = None
            for B in batches:
                if wins[B] and from_b is None:
                    from_b = B
                elif not wins[B]:
                    from_b = None
            cross[(c, b)] = from_b
            print(f"  ({c}, {b}): many-row faster from B = {from_b}",
                  flush=True)
        del ops
        torch.cuda.empty_cache()
    known = [v for v in cross.values() if v is not None]
    print(f"crossover by shape: {cross}; threshold (the largest): "
          f"{max(known) if known else None} (_ROWS_MIN_B now "
          f"{K2._ROWS_MIN_B})")


def dec_plans(c: int, b: int, B: int) -> list:
    """Every decode plan: CS ∈ {1, 2, 4, 8} with ≥ one stage a CTA, ring
    depths DEC_DEPTHS and the deepest that fits, each cut to the CTA's
    stages (at least 2)."""
    from repro_torch.kernels import nm_spmm as K2

    N, BM = 8 * -(-B // 8), K2._DEC_BM
    nks = -(-b // (32 * K2._DEC_KS))
    plans = []
    for CS in K2._DEC_SPLITS:
        top = K2._k2_dec_nst_max(BM, N, 4, CS)
        if nks < CS or top < 2:
            break
        own = -(-nks // CS)
        depths = sorted({max(2, min(d, top, own))
                         for d in (*DEC_DEPTHS, top)})
        plans += [(4, CS, K2._k2_dec_smem(BM, N, 4, d, CS), BM, N)
                  for d in depths]
    return plans


def dec_part(gen, dev, shapes) -> None:
    """Mode 2 under its plan against every decode plan, by B; mode 3 where
    it runs today and at B = 64 (the crossover)."""
    import json

    import torch

    from repro_torch.kernels import nm_spmm as K2

    records = []
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    for c, b in shapes:
        ops = Operands(gen, dev, c, b)
        for B in (*DEC_BATCHES, 64):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            chosen = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4)
            tc8 = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4,
                              False)              # x unaligned: mode 2
            rec = {"c": c, "b": b, "B": B, "chosen": list(chosen)}
            if tc8[0] == 2:
                rec["mode2"] = [list(tc8), ops.time_plan(x, tc8)]
            if c >= K2._ROWS_MIN_C:
                rp = K2._k2_rows_plan(c, b, B, 4)
                rec["mode3"] = [list(rp), ops.time_plan(x, rp)]
            if c >= K2._ROWS_MIN_C and B <= 64:
                res = {p: ops.time_plan(x, p) for p in dec_plans(c, b, B)}
                rec["mode4"] = [[list(p), t] for p, t in res.items()]
                best = min(res, key=res.get)
            rec["library"] = ops.time_library(x)
            records.append(rec)
            line = f"({c}, {b}) B={B}: library {rec['library']:.4f}"
            if "mode2" in rec:
                line += f"; mode 2 CS {tc8[1]} {rec['mode2'][1]:.4f}"
            if "mode3" in rec:
                rp = rec["mode3"][0]
                line += (f"; mode 3 {rp[3]}×{rp[4]} CS {rp[1]} "
                         f"{rec['mode3'][1]:.4f}")
            if "mode4" in rec:
                top = sorted(res, key=res.get)[:4]
                line += "; mode 4 best " + ", ".join(
                    f"{'*' if p == chosen else ''}BM {p[3]} CS {p[1]} "
                    f"nst {K2._k2_dec_nst(p[2], p[3], p[4], 4, p[1])} "
                    f"{res[p]:.4f}"
                    for p in top)
                if chosen in res:
                    line += (f"; chosen {res[chosen]:.4f} "
                             f"({res[chosen] / res[best]:.2f}× the best)")
            print(line + f"; plan mode {chosen[0]}", flush=True)
            (out / "k2_decode_sweep.json").write_text(json.dumps(
                {"gpu": gpu_line(), "rows": records}))
        del ops
        torch.cuda.empty_cache()


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("all", "path", "rows", "decode"),
                    default="all")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="decode part: c,b weight shapes, each swept at "
                    "every B of DEC_BATCHES (default: TABLE_SHAPES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gpu: {gpu_line()}")
    if args.part in ("all", "path"):
        path_part(gen, dev)
    if args.part in ("all", "rows"):
        rows_part(gen, dev)
    if args.part in ("all", "decode"):
        shapes = TABLE_SHAPES if args.shapes is None else [
            tuple(map(int, s.split(","))) for s in args.shapes]
        dec_part(gen, dev, shapes)


if __name__ == "__main__":
    main()
