#!/usr/bin/env python3
"""Time K3 (the stacked expert matmul) at the occupancies decode gives it,
under every launch plan, on one NVIDIA GPU; fit the plan's decode rule.

    python3 tools/k3_plan_sweep.py                   # on a card
    python3 tools/k3_plan_sweep.py --digest chiprun_out/k3_plan_sweep.json

On a card: qwen3-moe-30b-a3b's two full-width expert leaves, gate/up
W (128, 768, 2048) and down W (128, 2048, 768), bf16 2:4 with 4-bit
indices (8-bit at T = 1 and 4 too), x from the port's own ``moe_ffn``
dispatch (a random router) of T ∈ TOKENS tokens — C = 8 up to T = 115, 16
at 200, 40 at 512, 160 at 2 048 and 640 at 8 192 (``moe.capacity``: the
last two are prefills) — and a filled stack (every capacity row of every
expert non-zero, C = 8).  At each: the mode-2 kernel (timed before
and after the others), the decode-occupancy kernel (mode 4) at every
cluster size CS ∈ {1, 2, 4} and ring depth, ``torch.bmm`` over the whole
dense stack and over only the active experts' dense weights (gathered
before the timing, ``chip_smoke.bmm_active_ms``).  Device times of
CUDA-graph replays, the weights rotated through copies so that the active
experts' weights stream from HBM; every plan first held against the plain
version (bf16 rtol 2e-2 / atol 1e-2).
The record goes to ``chiprun_out/k3_plan_sweep.json``.

Here: ``--digest`` copies a record into ``tools/k3_plan_sweep.json`` (the
digest the plan is fitted to and ``tests/test_torch_stacked.py`` holds it
against), prints ``fit``'s rule beside ``nm_spmm._K3_DEC_RULE`` and the
rows, if any, at which that rule's plan ran slower than the mode-2 kernel.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DIGEST = Path(__file__).resolve().with_suffix(".json")
ARCH = "qwen3-moe-30b-a3b"
TOKENS = (1, 2, 4, 8, 16, 32, 64, 115, 200, 512, 2048, 8192)
WIDE_BITS_TOKENS = (1, 4)           # the 8-bit rows
SPLITS, DEPTHS = (1, 2, 4), (2, 3, 4, 6, 8)
# the fit's candidates for the threshold of 128-row tiles × CS
TILE_TARGETS = (1, 6, 12, 16, 24, 32, 48, 64)
TIE = 0.005            # the fit's totals this close count as equal


def configs(b: int) -> list:
    """Every (CS, nst) of mode 4 at b: clusters of CS with ≥ one stage a
    CTA when split, each depth cut to a split CTA's own stages (at least
    2)."""
    nks = -(-b // 128)
    out = []
    for CS in SPLITS:
        if nks < CS:
            continue
        for d in sorted({max(2, min(d, -(-nks // CS))) for d in DEPTHS}):
            out.append((CS, d))
    return out


def rule_plan(rule, c: int, b: int) -> tuple:
    """(CS, nst) that ``rule`` plans at (c, b), as ``nm_spmm._k3_dec_plan``
    does (its cut of the ring beside a long list of row groups never acts
    at the sweep's E = 128 and C ≤ 640)."""
    nks, tiles = -(-b // 128), -(-c // 128)
    CS = 1
    for cs in SPLITS:
        if nks < cs:
            break
        CS = cs
        if tiles * cs >= rule["tiles"]:
            break
    nst = rule["nst"] if CS > 1 else rule["nst1"]
    return CS, max(2, min(nst, -(-nks // CS)))


def load(path: Path = DIGEST) -> dict:
    return json.loads(Path(path).read_text())


def times(row: dict) -> dict:
    """A row's mode-4 times by (CS, nst)."""
    return {tuple(k): t for *k, t in row["mode4"]}


def decode_rows(digest: dict) -> list:
    """The rows the rule is fitted on: 4-bit indices, x from the dispatch
    (the filled stack is no decode occupancy: C = 8 holds 1 024 slots,
    at most 920 of them taken at T = 115)."""
    return [r for r in digest["rows"] if r["bits"] == 4 and r["T"]]


def fit(digest: dict) -> dict:
    """The rule: of the (tiles, nst, nst1) whose plans ran no slower than
    mode 2 at any row (``slower``), the one that loses the least to each
    row's best mode-4 plan over the C = 8 rows — the sum of time over that
    best, gate/up weighted 2 (gate and up each launch it), so that every
    occupancy counts alike and the few-token rows the serve path launches
    are not drowned by the full ones; of those within TIE of the least,
    the fewest stages and tiles.  Where no rule is no slower everywhere,
    the least loss of all (``slower`` then names its rows)."""
    c8 = [r for r in decode_rows(digest) if r["C"] == 8]
    cands = []
    for tiles, nst, nst1 in itertools.product(TILE_TARGETS, DEPTHS, DEPTHS):
        rule = {"tiles": tiles, "nst": nst, "nst1": nst1}
        total = sum(r["weight"] * times(r)[rule_plan(rule, r["c"], r["b"])]
                    / min(times(r).values()) for r in c8)
        cands.append((total, rule))
    cands = [c for c in cands if not slower(digest, c[1])] or cands
    least = min(t for t, _ in cands)
    return min((r for t, r in cands if t <= least * (1 + TIE)),
               key=lambda r: (r["nst"], r["nst1"], r["tiles"]))


def slower(digest: dict, rule: dict) -> list:
    """The decode rows (every C the sweep ran) at which ``rule``'s plan ran
    slower than mode 2: past the slower of mode 2's two timings of the row
    (before and after the row's mode-4 plans), so that a difference inside
    mode 2's own repeatability decides nothing.  None such: mode 4 takes
    every C its layout allows, with no bound on C."""
    return [r for r in decode_rows(digest)
            if times(r)[rule_plan(rule, r["c"], r["b"])]
            > max(r["mode2"], r["mode2_again"])]


def dispatch_inputs(gen, dev, packs: dict) -> dict:
    """{T: (x into gate/up (E, C, 2048), x into down (E, C, 768))} from the
    port's moe_ffn at full width with a random router."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod

    cfg = get_config(ARCH)
    d, E = cfg.d_model, cfg.num_experts
    gu, dn = packs
    p = {"router": {"w": (torch.randn((d, E), generator=gen, device=dev)
                          / math.sqrt(d)).to(torch.bfloat16)},
         "gate": {"w": gu}, "up": {"w": gu}, "down": {"w": dn}}
    seen: list = []
    real = ops.nm_matmul_stacked

    def spy(x, packed, **kw):
        seen.append(x.clone())
        return real(x, packed, **kw)

    out = {}
    ops.nm_matmul_stacked = spy
    try:
        with torch.no_grad():
            for T in TOKENS:
                seen.clear()
                x = torch.randn((T, 1, d), generator=gen, device=dev).to(
                    torch.bfloat16)
                moe_mod.moe_ffn(p, x, cfg)
                out[T] = (seen[0], seen[2])
    finally:
        ops.nm_matmul_stacked = real
    return out


class Leaf:
    """One packed leaf, its rotated copies and its dense weights."""

    def __init__(self, gen, dev, E: int, c: int, b: int, bits: int):
        import torch

        from repro_torch.core.masks import nm_mask
        from repro_torch.core.sparsity import pack_nm_stacked

        w = (torch.randn((E, c, b), generator=gen, device=dev)
             / math.sqrt(b)).to(torch.bfloat16)
        mask = nm_mask(w.reshape(E * c, b).float(),
                       torch.ones((b,), device=dev), 2, 4).reshape(E, c, b)
        self.pk = pack_nm_stacked(w, mask, 2, 4, idx_bits=bits)
        self.dense = w.masked_fill(mask > 0.5, 0)
        del w, mask
        self.E, self.c, self.b, self.bits = E, c, b, bits
        self.per = (self.pk.values[0].numel() * 2
                    + self.pk.indices[0].numel())
        self.copies = [(self.pk.values, self.pk.indices)]

    def rotate(self, groups: int) -> None:
        """Copies enough that the active weights of ``groups`` row groups
        pass 96 MiB over the ring (the L2 holds 50 MB)."""
        n = min(8, math.ceil(96 * 2**20 / max(1, groups * self.per)) + 1)
        while len(self.copies) < n:
            self.copies.append((self.pk.values.clone(),
                                self.pk.indices.clone()))
        del self.copies[n:]


def sweep(out_path: Path) -> None:
    import torch

    from chip_smoke import bmm_active_ms, device_ms, gpu_line
    from repro_torch.kernels import nm_spmm as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gpu: {gpu_line()}", flush=True)
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    record = {"gpu": gpu_line(), "rows": []}
    for bits in (4, 8):
        leaves = (Leaf(gen, dev, E, f, d, bits), Leaf(gen, dev, E, d, f, bits))
        xs = dispatch_inputs(gen, dev, (leaves[0].pk, leaves[1].pk))
        occ = [(T, xs[T]) for T in TOKENS
               if bits == 4 or T in WIDE_BITS_TOKENS]
        if bits == 4:
            occ.append((0, tuple(torch.randn((E, 8, lf.b), generator=gen,
                                             device=dev).to(torch.bfloat16)
                                 for lf in leaves)))
        for (T, pair), (li, leaf) in itertools.product(occ,
                                                       enumerate(leaves)):
            x = pair[li]
            act = K.active_row_groups(x)
            groups, experts = int(act.sum()), int(act.any(dim=1).sum())
            leaf.rotate(groups)
            ring = itertools.cycle(range(len(leaf.copies)))
            reps = 4 * len(leaf.copies)
            y_p = K.nm_matmul_stacked_plain(x, leaf.pk.values,
                                            leaf.pk.indices, 2, 4, leaf.b,
                                            bits)

            def timed(plan):
                y = K._launch_k3(x, leaf.pk.values, leaf.pk.indices, 2, 4,
                                 leaf.b, bits, plan)
                torch.cuda.synchronize()
                if not torch.allclose(y.float(), y_p.float(), rtol=2e-2,
                                      atol=1e-2):
                    raise SystemExit(f"K3 plan {plan} at {leaf.c}×{leaf.b} "
                                     f"T={T} disagrees with the plain "
                                     "version")

                def kern():
                    v, i = leaf.copies[next(ring)]
                    K._launch_k3(x, v, i, 2, 4, leaf.b, bits, plan)

                return device_ms(kern, reps)

            L = leaf.pk.values.shape[-1]
            stride = leaf.pk.indices.shape[-1]
            mode2 = K._k3_plan(L, stride, leaf.b, 2, True)
            row = {"leaf": "gate_up" if li == 0 else "down", "c": leaf.c,
                   "b": leaf.b, "bits": bits, "T": T, "C": x.shape[1],
                   "groups": groups, "experts": experts,
                   "weight": 2 if li == 0 else 1,
                   "chosen": list(K._k3_plan(L, stride, leaf.b, 2, True, 2,
                                             4, E, x.shape[1], leaf.c)),
                   "mode2": timed(mode2)}
            row["mode4"] = [[*cf, timed((4, *cf))]
                            for cf in configs(leaf.b)]
            row["mode2_again"] = timed(mode2)
            xd = x
            row["bmm"] = device_ms(lambda: torch.bmm(
                xd, leaf.dense.transpose(-1, -2)), 8)
            row["bmm_active"] = bmm_active_ms(x, leaf.dense, act)
            best = min(row["mode4"], key=lambda r: r[-1])
            print(f"{row['leaf']} ({E}, {leaf.c}, {leaf.b}) idx{bits} T={T} "
                  f"C={row['C']}: {experts} experts / {groups} groups "
                  f"active; mode 2 {row['mode2']:.4f} / "
                  f"{row['mode2_again']:.4f} ms; mode 4 best "
                  f"CS {best[0]} nst {best[1]} {best[2]:.4f}; plan "
                  f"{row['chosen']} "
                  f"{times(row).get(tuple(row['chosen'][1:]), math.nan):.4f}"
                  f"; bmm {row['bmm']:.4f}, active experts only "
                  f"{row['bmm_active']:.4f}", flush=True)
            record["rows"].append(row)
            out_path.write_text(json.dumps(record))
        del leaves, xs
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--digest", type=Path, default=None,
                    help="a sweep record to copy into the digest and fit")
    args = ap.parse_args()
    if args.digest is not None:
        record = load(args.digest)
        DIGEST.write_text("{\"gpu\": " + json.dumps(record["gpu"])
                          + ", \"rows\": [\n" + ",\n".join(
                              json.dumps(r) for r in record["rows"])
                          + "]}\n")
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import nm_spmm as K
        rule = fit(record)
        print(f"fitted: {rule}")
        print(f"source: {K._K3_DEC_RULE._asdict()}")
        for r in slower(record, rule):
            print(f"mode 4 slower than mode 2: {r['leaf']} T={r['T']} "
                  f"C={r['C']}")
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    sweep(out / "k3_plan_sweep.json")


if __name__ == "__main__":
    main()
