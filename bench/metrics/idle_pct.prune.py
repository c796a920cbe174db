"""Device: the share of the traced block with no operation running on the
card (``torch.profiler``), in %."""


def read(rec):
    trace, span = rec.get("trace"), rec.get("slice_s")
    if not trace or not span or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / span)
