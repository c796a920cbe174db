"""K1 (``kernels/hessian_accum.py``: the scan and the xᵀx kernels): the
least time the traced block's K1 launches could take
(``bench/lib/flops.k1_bound_s`` of each launch, counted by
``hessian_update_cuda.by_shape``) over their device time in the
profiler's trace, in %.  Only where every launch took whole batches of
rows: a masked launch's valid rows are not counted by the program."""

import re

from bench.lib.flops import k1_bound_s

K1 = re.compile(r"\b(scan_kernel|xtx_\w*_kernel)")


def read(rec):
    trace, k1 = rec.get("trace"), rec.get("k1")
    if not trace or not k1:
        return None
    if any(rows != rec["batch_tokens"] for rows, _, _ in k1):
        return None
    t = sum(s for name, (_, s) in trace["kernels"].items() if K1.search(name))
    bound = sum(n * k1_bound_s(rows, b, 2 if "16" in str(dt) else 4)
                for (rows, b, dt), n in k1.items())
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
