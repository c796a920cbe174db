#!/usr/bin/env python3
"""Time K2 (the n:m compressed matmul) under every launch plan it could take
at the serving paths' shapes, on one NVIDIA GPU.

    python3 tools/k2_plan_sweep.py          # from the root of a checkout

For each (c, b) that K2 runs on the two paths (tinyllama-1.1b and
qwen3-moe-30b-a3b's attention) and B ∈ {1, 4}, bf16 2:4 with 4-bit indices:
the tensor-core path at every cluster split CS ∈ {1, 2, 4, 8} that fits,
the warp-per-row kernel (mode 1), and
``torch.matmul`` on the dense weight — device times of CUDA-graph replays,
the weights rotated through copies so that every launch streams them from
HBM.  The plan ``_k2_plan`` chooses is marked.  Every plan is first held
against the plain version (bf16 rtol 2e-2 / atol 1e-2).
"""
from __future__ import annotations

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


def main() -> None:
    import torch

    from repro_torch.core.masks import nm_mask
    from repro_torch.core.sparsity import pack_nm
    from repro_torch.kernels import nm_spmm as K2

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gpu: {gpu_line()}")
    for c, b in PATH_SHAPES:
        w = (torch.randn((c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(torch.bfloat16)
        mask = nm_mask(w.float(), torch.ones((b,), device=dev), 2, 4)
        pk = pack_nm(w, mask, 2, 4, idx_bits=4)
        wd = w.masked_fill(mask > 0.5, 0)
        per = pk.values.numel() * 2 + pk.indices.numel()
        copies = max(1, math.ceil(128 * 2**20 / per))
        vals = [pk.values.clone() for _ in range(copies)]
        idxs = [pk.indices.clone() for _ in range(copies)]
        dens = [wd.clone() for _ in range(max(1, math.ceil(
            128 * 2**20 / (wd.numel() * 2))))]
        L, stride = pk.values.shape[1], pk.indices.shape[1]
        reps = copies * max(1, 64 // copies)
        for B in (1, 4):
            x = torch.randn((B, b), generator=gen, device=dev).to(
                torch.bfloat16)
            chosen = K2._k2_plan(c, b, L, stride, B, 2, True, 2, 4)
            y_p = K2.nm_matmul_plain(x, pk.values, pk.indices, 2, 4, b, 4)
            plans = [(1, 1, 0)]
            for CS in (1, 2, 4, 8):
                if b % (32 * CS) or (stride // CS) % 16:
                    continue
                smem = K2._k2_smem(b, L, stride, B, CS)
                if smem + 64 <= K2._SMEM_LIMIT:
                    plans.append((2, CS, smem))
            ring = itertools.cycle(range(copies))
            res = {}
            for plan in plans:
                y_k = K2._launch_k2(x, pk.values, pk.indices, 2, 4, b, 4,
                                    plan)
                torch.cuda.synchronize()
                if not torch.allclose(y_k.float(), y_p.float(), rtol=2e-2,
                                      atol=1e-2):
                    raise SystemExit(f"K2 plan {plan} at ({c}, {b}) B={B} "
                                     "disagrees with the plain version")

                def kern(plan=plan):
                    i = next(ring)
                    K2._launch_k2(x, vals[i], idxs[i], 2, 4, b, 4, plan)

                res[plan] = device_ms(kern, reps)
            dring = itertools.cycle(range(len(dens)))
            lib = device_ms(lambda: torch.matmul(x, dens[next(dring)].T),
                            len(dens) * max(1, 64 // len(dens)))
            best = min(res, key=res.get)
            print(f"({c}, {b}) B={B}: library {lib:.4f} ms; " + "; ".join(
                f"{'*' if p == chosen else ''}mode {p[0]} CS {p[1]} "
                f"{t:.4f}" for p, t in res.items())
                + f"; best mode {best[0]} CS {best[1]}")
        del vals, idxs, dens


if __name__ == "__main__":
    main()
