"""Model step: the mean host time of the window's pumps that admitted
nothing (one replayed B = batch_slots decode step each), in ms."""


def read(rec):
    plain = [p[1] - p[0] for p in rec.get("pumps", ()) if p[2] == 0
             and p[4] == 1]
    if not plain:
        return None
    return 1e3 * sum(plain) / len(plain)
