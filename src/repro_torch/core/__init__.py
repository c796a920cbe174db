"""Core library: the paper's contribution (Thanos) + baselines + driver
(the exports of ``repro.core`` that the port has)."""
from repro_torch.core.api import (
    METHODS, ON_SINGULAR, PATTERNS, GuardInfo, MethodSpec, PruneConfig,
    method_spec, prune_layer, prune_layer_guarded, reconstruction_error,
    register_method, unregister_method,
)
from repro_torch.core.hessian import (
    DAMP_FLOOR, HessianAccumulator, dampen, factor_finite, h_finite,
    inv_cholesky_upper,
)
from repro_torch.core.plan import (
    AllocationSpec, LayerStat, PrunePlan, PruneRule, as_plan, path_str,
)
from repro_torch.core.schedule import (
    LayerReport, PruneReport, collect_hessian_stats, get_path, prune_model,
    set_path,
)
from repro_torch.core.jobs import (LayerRecord, PruneJob, PruneJournal,
                                   batch_digest)
from repro_torch.core.sparsity import (NmCompressed, compression_ratio,
                                       pack_nm, unpack_nm)
from repro_torch.core.thanos import PruneResult

__all__ = [
    "METHODS", "ON_SINGULAR", "PATTERNS", "GuardInfo", "MethodSpec",
    "PruneConfig", "method_spec", "prune_layer", "prune_layer_guarded",
    "reconstruction_error", "register_method", "unregister_method",
    "DAMP_FLOOR", "HessianAccumulator", "dampen", "factor_finite",
    "h_finite", "inv_cholesky_upper",
    "AllocationSpec", "LayerStat", "PrunePlan", "PruneRule", "as_plan",
    "path_str",
    "LayerReport", "PruneReport", "collect_hessian_stats", "get_path",
    "prune_model", "set_path",
    "LayerRecord", "PruneJob", "PruneJournal", "batch_digest",
    "NmCompressed", "compression_ratio", "pack_nm", "unpack_nm",
    "PruneResult",
]
