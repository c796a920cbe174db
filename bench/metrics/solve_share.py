"""OBS solve (``core/thanos.py``, ``core/solver.py``): the share of the
window's blocks spent in layer solves — Σ ``LayerReport.seconds`` (a
linear's Hessian finalize and solve, ending at its loss's sync) over the
blocks' host time, from the blocks the profiler did not trace, in %."""


def read(rec):
    if not rec.get("clean_blocks") or rec.get("clean_s", 0) <= 0:
        return None
    return 100.0 * rec["solve_s"] / rec["clean_s"]
