"""Whole model step: the model FLOPs of every token the model processed in
the window outside the profiler's slice and its export (each prompt token
prefilled, each token decoded, at its own context, the LM head where its
logits were read; ``bench/lib/flops.token_flops``) over that time times
the card's bf16 peak, in %.  Idle slots' re-decodes are not model work."""

from bench.lib.common import PEAK_BF16_FLOPS
from bench.lib.flops import token_flops


def read(rec):
    tokens = rec.get("tokens")
    if not tokens:
        return None
    cfg = rec["cfg"]
    flops = sum(n * token_flops(cfg, ctx) for ctx, n in tokens["head"].items())
    flops += sum(n * token_flops(cfg, ctx, head=False)
                 for ctx, n in tokens["body"].items())
    return 100.0 * flops / (rec["clean_s"] * PEAK_BF16_FLOPS)
