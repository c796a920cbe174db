#!/usr/bin/env python3
"""Which linear-algebra backend the prune job's CUDA graphs can use, and
what the choice does to a pruned tree, on one NVIDIA GPU.

    python3 tools/prune_linalg_check.py      # from the root of a checkout

(a) Thanos 2:4 (B = 64) and unstructured (B = 128) at W (2048, 2048) and
(2048, 5632) bf16, graphed in one scope under each backend PyTorch offers
("default", "magma", "cusolver"): two keys of the same row count captured
in turn, then replayed interleaved, each call held bitwise against the
direct call — or the capture's error.  (b) A batched ``cholesky_solve`` of
random SPD systems (c, r, r) on MAGMA and on cuSOLVER against float64.
(c) xlstm-1.3b at full width, 16 blocks, Thanos 2:4 pruned eagerly on
MAGMA (PR 23's numerics) and from graphs on cuSOLVER: mask entries that
differ, summed OBS losses, and for each tree phase families' measures of
its served first step at depths 1, 8, 16 — K2 against the decompressed
dense logits in bf16 and in fp32, the bf16 dense tree's own spread with
every linear summed in another order, the fp32 error with block 8's
leaves lane-shifted, and every K2 product's error against the fp32
product beside the dense bf16 product's.
"""
from __future__ import annotations

import contextlib
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def capture_check(dev, gen) -> None:
    import torch

    from repro_torch.core import thanos
    from repro_torch.util import graphs

    def pair(c, b):
        w = (torch.randn((c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(torch.bfloat16)
        x = torch.randn((1024, b), generator=gen, device=dev)
        return w, 2.0 * (x.T @ x) / 1024

    refused = (RuntimeError, getattr(torch, "AcceleratorError",
                                     RuntimeError))
    check = graphs._check_linalg
    graphs._check_linalg = lambda: None       # let MAGMA try its capture
    try:
        for lib in ("default", "magma", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(lib)
            for name, fn, kw in (
                    ("thanos 2:4", thanos.prune_nm,
                     {"n": 2, "m": 4, "block_size": 64}),
                    ("thanos unstructured", thanos.prune_unstructured,
                     {"p": 0.5, "block_size": 128})):
                keys = {k: [pair(*k) for _ in range(2)]
                        for k in ((2048, 2048), (2048, 5632))}
                want = {(k, s): fn.__wrapped__(*keys[k][s], **kw)
                        for k in keys for s in (0, 1)}
                order = [(k, s) for k in keys for s in (0, 1)] + \
                    [(k, s) for _ in range(2) for s in (0, 1) for k in keys]
                try:
                    with graphs.scope() as sc:
                        bad = []
                        for k, s in order:
                            got = fn(*keys[k][s], **kw)
                            torch.cuda.synchronize()
                            if not cs.same_tree(got, want[(k, s)]):
                                bad.append((k, s))
                        st = sc.stats()
                    print(f"(a) {lib} {name}: {st['graphs']} graphs, "
                          f"{st['replays']} replays; calls not bitwise the "
                          f"direct call: {bad}", flush=True)
                except refused as exc:
                    print(f"(a) {lib} {name}: the capture raised "
                          f"{type(exc).__name__}: {str(exc)[:160]}",
                          flush=True)
                    torch.cuda.synchronize()
    finally:
        graphs._check_linalg = check
        torch.backends.cuda.preferred_linalg_library("cusolver")


def solve_accuracy(dev, gen) -> None:
    import torch

    for c, r in ((4096, 32), (2048, 128)):
        a = torch.randn((c, r, 2 * r), generator=gen, device=dev)
        spd = a @ a.transpose(1, 2) / (2 * r) + 1e-3 * torch.eye(r,
                                                                 device=dev)
        u = torch.randn((c, r, 1), generator=gen, device=dev)
        want = torch.linalg.solve(spd.double(), u.double())
        for lib in ("magma", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(lib)
            x = torch.cholesky_solve(u, torch.linalg.cholesky_ex(spd)[0])
            rel = float((x.double() - want).abs().max() / want.abs().max())
            print(f"(b) cholesky_solve ({c}, {r}, {r}) on {lib}: max rel "
                  f"err against float64 {rel:.3g}", flush=True)
    torch.backends.cuda.preferred_linalg_library("cusolver")


def xlstm_trees(dev) -> None:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import PruneConfig
    from repro_torch.core.schedule import prune_model
    from repro_torch.data.pipeline import calibration_batches
    from repro_torch.models.model_builder import ModelAdapter, build_model
    from repro_torch.serve.compressed import compress_params
    from repro_torch.util import graphs

    @contextlib.contextmanager
    def eager():                    # a scope no call sees: all inline
        yield graphs.Scope()

    cfg = get_config("xlstm-1.3b").replace(num_layers=cs.XLSTM_LAYERS)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batches = calibration_batches(cfg, num_samples=16, seq_len=128, batch=8,
                                  device=dev)
    prompts = cs.request_prompts(cfg.vocab_size)
    tok = torch.tensor([[int(p[0])] for p in prompts], device=dev)
    cell = PruneConfig("thanos", "nm", n=2, m=4, block_size=64)
    masks = {}
    for label, lib, graphed in (("MAGMA, eager", "magma", False),
                                ("cuSOLVER, graphs", "cusolver", True)):
        torch.backends.cuda.preferred_linalg_library(lib)
        scope = graphs.scope
        if not graphed:
            graphs.scope = eager
        try:
            pruned, rep = prune_model(params, ModelAdapter(model), batches,
                                      cell)
        finally:
            graphs.scope = scope
            torch.backends.cuda.preferred_linalg_library("cusolver")
        comp = compress_params(pruned, rep.masks, 2, 4)
        prof = cs.depth_profile(cfg, comp, prompts, cs.XLSTM_DEPTHS,
                                cs.XLSTM_DEPTHS[-2])
        lin = cs.k2_linear_errors(model, comp, tok)
        masks[label] = rep.masks
        print(f"(c) {label}: OBS losses summed "
              f"{sum(r.obs_loss for r in rep.layers):.6g}; depth: K2 bf16 "
              f"/ every linear summed in another order / K2 fp32 rel "
              + "; ".join(f"{d}: {v['kernel_rel']:.4g} / "
                          f"{v['rounding_rel']:.4g} / {v['fp32_rel']:.4g}"
                          for d, v in prof["depths"].items())
              + f"; fp32 with block {cs.XLSTM_DEPTHS[-2]} lane-shifted "
              f"{prof['fault']:.4g}; {len(lin)} K2 products against the fp32 product: max "
              f"rel {max(k for _, k, _ in lin):.4g} (dense bf16 "
              f"{max(d for _, _, d in lin):.4g})", flush=True)
        del pruned, rep, comp
    a, b = masks.values()
    diff = sum(int((a[p] != b[p]).sum()) for p in a)
    print(f"(c) mask entries differing between the trees: {diff} of "
          f"{sum(m.numel() for m in a.values())}", flush=True)


def main() -> None:
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    dev = resolve_device("cuda")
    print(f"gpu: {cs.gpu_line()}, torch {torch.__version__}", flush=True)
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    gen = torch.Generator(device=dev).manual_seed(0)
    capture_check(dev, gen)
    solve_accuracy(dev, gen)
    xlstm_trees(dev)


if __name__ == "__main__":
    main()
