"""Engine: the share of slot-steps that served a request, from the deltas
of ``engine.stats`` over the window's pumps: busy_slot_steps /
(decode_steps × batch_slots), in %."""


def read(rec):
    pumps = rec.get("pumps")
    if not pumps:
        return None
    steps = sum(p[4] for p in pumps)
    if not steps:
        return None
    return 100.0 * sum(p[5] for p in pumps) / (steps * rec["slots"])
