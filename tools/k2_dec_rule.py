#!/usr/bin/env python3
"""Fit the rule by which K2's plan takes the decode kernel (mode 4) below
``_ROWS_MIN_B`` activation rows to the decode sweep's timings, and check
the source's rule (``nm_spmm._DEC_RULE``) against the fit.

    python3 tools/k2_dec_rule.py            # the committed digest
    python3 tools/k2_dec_rule.py --from chiprun_out/k2_decode_sweep.json
                                            # a new sweep → the digest

``tools/k2_plan_sweep.py --part decode`` times, on one card, every (c, b)
of PERF.md's K2 table at B ∈ {1, 4, 8, 16, 32, 63}: the 8-row kernel
(mode 2) and the many-row kernel (mode 3) under their plans,
``torch.matmul``, and the decode kernel at every split and ring depth
(bf16 2:4, 4-bit indices, device times of graph replays, ms).  ``--from``
turns its record into the digest ``tools/k2_decode_sweep.json``, the data
this script and ``tests/test_torch_k2.py`` read.

The rule's form is ``nm_spmm._k2_dec_wins`` (read there); its thresholds
(``nm_spmm._DecRule``) are fitted one batch class at a time: of a grid of
values, those that save the most time over the class's rows such that
every row the rule sends to mode 4 ran there, under the plan's own split
and ring depth, in at most ``MARGIN`` of the time of the mode it replaces
(mode 2; mode 3 for rows too wide for one 8-row block) — a gain above the
sweep's noise.  Ties go to the first values in ascending order.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import nm_spmm as K2  # noqa: E402

DIGEST = ROOT / "tools" / "k2_decode_sweep.json"
MARGIN = 0.95
BITS = 4


def digest(records: list, gpu: str) -> dict:
    """The sweep's record → the digest: per row the modes' times and the
    decode kernel's at each (CS, ring depth) of its tile (``"CS,nst"``)."""
    rows = []
    for r in records:
        row = {"c": r["c"], "b": r["b"], "B": r["B"],
               "mode2": r["mode2"][1] if "mode2" in r else None,
               "mode3": r["mode3"][1] if "mode3" in r else None,
               "library": r["library"], "mode4": {}}
        row.update({k: round(row[k], 7) for k in ("mode2", "mode3",
                                                  "library")
                    if row[k] is not None})
        for (mode, CS, smem, BM, N), t in r.get("mode4", []):
            if BM == K2._DEC_BM:
                nst = K2._k2_dec_nst(smem, BM, N, BITS, CS)
                row["mode4"][f"{CS},{nst}"] = round(t, 7)
        rows.append(row)
    return {"gpu": gpu, "bits": BITS, "rows": rows}


def load(path: Path = DIGEST) -> dict:
    return json.loads(path.read_text())


def _stride(b: int) -> int:
    return b // 2 * BITS // 8


def plan_time(row: dict, plan) -> float | None:
    """The digest's time of ``plan`` at ``row`` (None where not swept)."""
    mode, CS, smem, BM, N = plan
    if mode != 4:
        return row[f"mode{mode}"]
    nst = K2._k2_dec_nst(smem, BM, N, BITS, CS)
    return row["mode4"].get(f"{CS},{nst}")


def cases(data: dict) -> list:
    """Each row below _ROWS_MIN_B that mode 4 can take, with what the rule
    reads: its class, the 8-row plan (what an unaligned x takes), the
    decode plan's time and the time of the mode it would replace."""
    out = []
    for row in data["rows"]:
        c, b, B = row["c"], row["b"], row["B"]
        if B >= K2._ROWS_MIN_B or c < K2._ROWS_MIN_C or not row["mode4"]:
            continue
        tc8 = K2._k2_plan(c, b, b // 2, _stride(b), B, 2, True, 2, 4, False)
        wide = tc8[0] != 2 or tc8[1] > 1
        cls = "wide" if wide else ("one" if B == 1 else
                                   "few" if B <= K2._MAXB else "many")
        t4 = plan_time(row, K2._k2_dec_plan(c, b, B, BITS))
        out.append({"row": row, "cls": cls, "smem": tc8[2], "t4": t4,
                    "before": row["mode3"] if wide else row["mode2"]})
    return out


def takes(case: dict, rule) -> bool:
    """Whether ``rule`` sends the case's row to mode 4."""
    row = case["row"]
    if case["cls"] == "wide":
        return row["B"] <= rule.wide_max_b
    return K2._k2_dec_wins(row["c"], row["b"], row["B"], _stride(row["b"]),
                           case["smem"], rule)


def grids(data: dict) -> dict:
    """Each class's parameters and the values tried for them: counts of
    blocks and waves, and the b, bytes and B of the class's own rows."""
    rows = {cls: [c["row"] for c in cases(data) if c["cls"] == cls]
            for cls in ("few", "many", "wide")}
    few = sorted({r["b"] for r in rows["few"]})
    many = sorted({r["B"] * r["c"] * (r["b"] + _stride(r["b"]))
                   for r in rows["many"]})
    batches = sorted({0} | {r["B"] for r in rows["wide"]})
    return {"one": {"one_per": range(1, K2._TC_BLOCKS_SM + 1),
                    "one_waves": range(1, 9)},
            "few": {"few_waves": range(1, 9), "few_b": few},
            "many": {"many_bytes": many},
            "wide": {"wide_max_b": batches}}


def gain(cs: list, rule) -> float | None:
    """ms saved over ``cs`` by ``rule``; None if a row it takes ran mode 4
    in more than MARGIN of the time of the mode it replaces."""
    total = 0.0
    for case in cs:
        if takes(case, rule):
            if case["t4"] is None or case["t4"] > MARGIN * case["before"]:
                return None
            total += case["before"] - case["t4"]
    return total


def fit(data: dict):
    """The rule fitted to ``data``, class by class."""
    cs = cases(data)
    rule = K2._DEC_RULE
    for cls, grid in grids(data).items():
        mine = [c for c in cs if c["cls"] == cls]
        if cls == "wide":
            # the largest B up to which every wide row is taken
            best = 0
            for B in grid["wide_max_b"]:
                if gain(mine, rule._replace(wide_max_b=B)) is None:
                    break
                best = B
            rule = rule._replace(wide_max_b=best)
            continue
        best = None
        for values in itertools.product(*grid.values()):
            trial = rule._replace(**dict(zip(grid, values)))
            g = gain(mine, trial)
            if g is not None and (best is None or g > best[0]):
                best = (g, trial)
        rule = best[1]
    return rule


def report(data: dict, rule) -> None:
    """Per class: rows, rows taken and ms saved; rows left on their mode
    where mode 4 ran faster (below MARGIN)."""
    cs = cases(data)
    for cls in ("one", "few", "many", "wide"):
        mine = [c for c in cs if c["cls"] == cls]
        took = [c for c in mine if takes(c, rule)]
        left = [c for c in mine if not takes(c, rule) and c["t4"]
                and c["t4"] <= MARGIN * c["before"]]
        print(f"{cls}: {len(mine)} rows, {len(took)} on mode 4 saving "
              f"{sum(c['before'] - c['t4'] for c in took):.4f} ms; left "
              f"where mode 4 ran faster: " + (", ".join(
                  f"({c['row']['c']}, {c['row']['b']}) B={c['row']['B']} "
                  f"{c['t4'] / c['before']:.2f}×" for c in left) or "none"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--from", dest="src", type=Path, default=None,
                    help="a sweep's record to turn into the digest first")
    args = ap.parse_args()
    if args.src is not None:
        rec = json.loads(args.src.read_text())
        dig = digest(rec["rows"], rec["gpu"])
        rows = ",\n".join(json.dumps(r) for r in dig.pop("rows"))
        DIGEST.write_text(json.dumps(dig)[:-1] + ', "rows": [\n' + rows
                          + "\n]}\n")
        print(f"wrote {DIGEST.relative_to(ROOT)}")
    data = load()
    rule = fit(data)
    print(f"sweep on {data['gpu']}, {len(data['rows'])} rows")
    print(f"fitted: {rule}")
    print(f"source: {K2._DEC_RULE}"
          + ("" if rule == K2._DEC_RULE else "  ← differs from the fit"))
    report(data, K2._DEC_RULE)


if __name__ == "__main__":
    main()
