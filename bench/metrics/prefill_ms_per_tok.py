"""Engine admission: the host time the window's admitting pumps spent
beyond one decode step each, over the prompt tokens they prefilled (one
B = 1 step a token), in ms a token."""

import importlib.util
from pathlib import Path


def _decode_ms(rec):
    path = Path(__file__).with_name("decode_step_ms.py")
    spec = importlib.util.spec_from_file_location("bench_metric_dsm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def read(rec):
    adm = [p for p in rec.get("pumps", ()) if p[2] > 0]
    step = _decode_ms(rec)
    tokens = sum(p[3] for p in adm)
    if not adm or step is None or not tokens:
        return None
    busy = sum(p[1] - p[0] for p in adm) - 1e-3 * step * sum(p[4] for p in adm)
    return 1e3 * busy / tokens
