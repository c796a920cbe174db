"""Rule registry — import order fixes the report order (the JAX package's,
less ``jit-purity`` and ``recompile-hazards``: the port traces nothing)."""
from __future__ import annotations

from repro_torch.analysis.rules.fault_hooks import FaultHookCostRule
from repro_torch.analysis.rules.serve_decompress import \
    ServeNeverDecompressesRule
from repro_torch.analysis.rules.atomic_writes import AtomicWritesRule
from repro_torch.analysis.rules.dtype_discipline import DtypeDisciplineRule
from repro_torch.analysis.rules.import_hygiene import ImportHygieneRule

RULES = {
    rule.name: rule
    for rule in (
        FaultHookCostRule(),
        ServeNeverDecompressesRule(),
        AtomicWritesRule(),
        DtypeDisciplineRule(),
        ImportHygieneRule(),
    )
}

__all__ = ["RULES"]
