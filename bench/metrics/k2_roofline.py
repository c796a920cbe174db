"""K2 (``kernels/nm_spmm.py``, the ``nm_*`` kernels other than
``nm_stacked_*``): the least time its launches in the traced slice could
take (``bench/lib/flops.k2_bound_s`` of each launch, counted by
``nm_matmul_cuda.by_shape`` over the slice) over their device time in the
profiler's trace, in %."""

import re

from bench.lib.flops import k2_bound_s

K2 = re.compile(r"\bnm_(?!stacked)\w*kernel")


def read(rec):
    trace, slc = rec.get("trace"), rec.get("slice")
    if not trace or not slc:
        return None
    t = sum(s for name, (_, s) in trace["kernels"].items()
            if K2.search(name))
    delta = slc["k2_1"].copy()
    delta.subtract(slc["k2_0"])
    bound = sum(n * k2_bound_s(key[0], key[1], key[2], key[4])
                for key, n in delta.items() if n > 0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
