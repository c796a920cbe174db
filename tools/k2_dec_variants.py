#!/usr/bin/env python3
"""Time variants of K2's decode kernel (nm_sp_dec_kernel, plan mode 4) built
from edited copies of ``csrc/nm_spmm.cu``, against the kernel as built and
the 8-row kernel (mode 2), on one NVIDIA GPU.

    python3 tools/k2_dec_variants.py                 # from a checkout's root
    python3 tools/k2_dec_variants.py --part steps    # DEC_KS = 4, 8, 16
    python3 tools/k2_dec_variants.py --part split    # the split's cost

Part ``steps``: the kernel built with 4 (as committed), 8 and 16 32-column
steps a ring stage, every tile, split and ring depth of
``tools/k2_plan_sweep.py --part decode`` at each variant, the three best
printed.  Part ``split``: at every tile, split and a ring of 2 or 4
stages, the kernel as built, then without the split's reduction (every CTA
stores its partial sums to y, so y is wrong: timing only), then that
launched without the cluster attribute — what the reduction and the
cluster launch cost.  bf16 2:4, 4-bit indices, device times of CUDA-graph
replays with the weights rotated through copies (HBM-cold); the variants
build into ``build/k2_dec_variants/`` (gitignored).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

from chip_smoke import device_ms, gpu_line  # noqa: E402

OUT = ROOT / "build" / "k2_dec_variants"
STEPS_SHAPES = [(28672, 12288), (12288, 28672), (28672, 8192), (18432, 7168),
                (14704, 3584), (8192, 8192), (12288, 12288), (3584, 7168),
                (2560, 6912), (2048, 5632), (4096, 2048), (2048, 2048),
                (256, 2048), (1024, 1152)]
SPLIT_SHAPES = [(256, 2048), (2048, 2048), (5632, 2048), (2048, 5632),
                (1024, 1152), (4096, 2048), (28672, 12288)]
# the edits of the split part: the epilogue's unsplit branch taken always
# (no reduction), then no cluster attribute at the launch
NO_RED = ("  const bool consumer = warp < 4;\n  if (CS == 1) {",
          "  const bool consumer = warp < 4;\n  if (true) {")
NO_CLUSTER = ("  cfg.numAttrs = CS > 1 ? 1 : 0;\n  return static_cast<int>("
              "cudaLaunchKernelEx(\n      &cfg, kern, tm_v, tm_x, tm_i",
              "  cfg.numAttrs = 0;\n  return static_cast<int>("
              "cudaLaunchKernelEx(\n      &cfg, kern, tm_v, tm_x, tm_i")
KS_LINE = "constexpr int DEC_KS = 4;"


def build(variants: dict) -> dict:
    """{name: edited source} → {name: the library's nm_matmul entry}, the
    nvcc runs started together."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import nm_spmm as K2

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        fns[name] = K2._bind(ctypes.CDLL(str(OUT / f"{name}.so")), "nm_matmul")
    return fns


def use(fn) -> None:
    """Point K2's wrapper at one variant's entry."""
    from repro_torch.kernels import nm_spmm as K2

    K2._fn = lambda name: fn


def steps_part(gen, dev, source: str) -> None:
    import torch

    import k2_plan_sweep as sw
    from repro_torch.kernels import nm_spmm as K2

    kss = (4, 8, 16)
    fns = build({f"ks{ks}": source.replace(KS_LINE,
                                           f"constexpr int DEC_KS = {ks};")
                 for ks in kss})
    real = K2._fn
    for c, b in STEPS_SHAPES:
        ops = sw.Operands(gen, dev, c, b)
        for B in (1, 4, 32):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            K2._fn = real
            tc8 = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4,
                              False)
            line = f"({c}, {b}) B={B}: mode 2 {ops.time_plan(x, tc8):.4f}"
            for ks in kss:
                use(fns[f"ks{ks}"])
                K2._DEC_KS = ks
                res = {p: ops.time_plan(x, p) for p in sw.dec_plans(c, b, B)}
                line += f" | KS {ks}: " + ", ".join(
                    f"BM {p[3]} CS {p[1]} nst "
                    f"{K2._k2_dec_nst(p[2], p[3], p[4], 4, p[1])} {res[p]:.4f}"
                    for p in sorted(res, key=res.get)[:3])
            K2._DEC_KS, K2._fn = 4, real
            print(line, flush=True)
        del ops
        torch.cuda.empty_cache()


def split_part(gen, dev, source: str) -> None:
    import torch

    import k2_plan_sweep as sw
    from repro_torch.kernels import nm_spmm as K2

    assert source.count(NO_RED[0]) == 1 and source.count(NO_CLUSTER[0]) == 1
    no_red = source.replace(*NO_RED)
    fns = build({"no_red": no_red,
                 "no_cluster": no_red.replace(*NO_CLUSTER)})
    real = K2._fn
    fns["built"] = real("nm_matmul")
    for c, b in SPLIT_SHAPES:
        ops = sw.Operands(gen, dev, c, b)
        for B in (1, 4):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            K2._fn = real
            tc8 = K2._k2_plan(c, b, ops.L, ops.stride, B, 2, True, 2, 4,
                              False)
            line = f"({c}, {b}) B={B}: mode 2 {ops.time_plan(x, tc8):.4f}"
            for plan in sw.dec_plans(c, b, B):
                nst = K2._k2_dec_nst(plan[2], plan[3], plan[4], 4, plan[1])
                if nst not in (2, 4):
                    continue
                ts = []
                for name in ("built", "no_red", "no_cluster"):
                    use(fns[name])

                    def kern():
                        i = next(ops.ring)
                        K2._launch_k2(x, ops.vals[i], ops.idxs[i], 2, 4, b, 4,
                                      plan)

                    ts.append(device_ms(kern, ops.reps(B)))
                line += (f" | BM {plan[3]} CS {plan[1]} nst {nst}: "
                         + "/".join(f"{t:.4f}" for t in ts))
            K2._fn = real
            print(line, flush=True)
        del ops
        torch.cuda.empty_cache()


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("all", "steps", "split"),
                    default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    source = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
              "nm_spmm.cu").read_text()
    assert source.count(KS_LINE) == 1
    print(f"gpu: {gpu_line()}")
    if args.part in ("all", "split"):
        print("split: ms as built / without the reduction / and without "
              "the cluster launch")
        split_part(gen, dev, source)
    if args.part in ("all", "steps"):
        steps_part(gen, dev, source)


if __name__ == "__main__":
    main()
