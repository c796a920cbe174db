"""Whole prune job: the model FLOPs of the window's untraced blocks — two
calibration forwards a block (pass 1 and pass 2) and 2·rows·b² for each
K1 launch over whole batches — over their host time times the card's
bf16 peak, in %.  The OBS solves' arithmetic and masked K1 launches are
left out, so this is a lower bound."""

from bench.lib.common import PEAK_BF16_FLOPS


def read(rec):
    if not rec.get("clean_blocks") or rec.get("clean_s", 0) <= 0:
        return None
    flops = rec["clean_blocks"] * rec["forward_flops"]
    flops += sum(n * 2.0 * rows * b * b
                 for (rows, b, _), n in rec["k1_clean"].items()
                 if rows == rec["batch_tokens"])
    return 100.0 * flops / (rec["clean_s"] * PEAK_BF16_FLOPS)
