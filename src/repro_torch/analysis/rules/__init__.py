"""Rule registry — import order fixes the report order (the JAX package's:
``jit-purity`` and ``recompile-hazards`` read the code a CUDA graph
captures, where JAX's read the code ``jax.jit`` traces)."""
from __future__ import annotations

from repro_torch.analysis.rules.jit_purity import JitPurityRule
from repro_torch.analysis.rules.fault_hooks import FaultHookCostRule
from repro_torch.analysis.rules.serve_decompress import \
    ServeNeverDecompressesRule
from repro_torch.analysis.rules.atomic_writes import AtomicWritesRule
from repro_torch.analysis.rules.recompile import RecompileHazardsRule
from repro_torch.analysis.rules.dtype_discipline import DtypeDisciplineRule
from repro_torch.analysis.rules.import_hygiene import ImportHygieneRule

RULES = {
    rule.name: rule
    for rule in (
        JitPurityRule(),
        FaultHookCostRule(),
        ServeNeverDecompressesRule(),
        AtomicWritesRule(),
        RecompileHazardsRule(),
        DtypeDisciplineRule(),
        ImportHygieneRule(),
    )
}

__all__ = ["RULES"]
